"""Device ms per frame inside the span around the SLAM loop
(``system.run_slam``, or ``bootstrap_map`` / ``run_slam_steps`` on one
frame in the live drive), the poses brought to the host."""

from harness import readers


def read(ctx):
    return readers.stage_ms(ctx, "slam")
