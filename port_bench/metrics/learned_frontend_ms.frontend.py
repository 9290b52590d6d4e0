"""Device ms per frame inside the span around the learned frontend
(``run_slam_cli.learned_features_for_frames``)."""

from harness import readers


def read(ctx):
    return readers.stage_ms(ctx, "frontend")
