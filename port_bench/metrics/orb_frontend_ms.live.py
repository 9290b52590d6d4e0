"""Device ms per frame inside the span around the ORB frontend
(``run_slam_cli.features_for_frames``, or ``tracking.extract_features``
on one frame in the live drive)."""

from harness import readers


def read(ctx):
    return readers.stage_ms(ctx, "frontend")
