"""Device ms per frame inside the span around the segmenter's weight maps
(``run_slam_cli.semantic_weight_maps``)."""

from harness import readers


def read(ctx):
    return readers.stage_ms(ctx, "segmenter")
