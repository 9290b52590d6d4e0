"""The model FLOPs of the traced pass's frames (learned frontend and
segmenter from their published shapes; the SLAM loop counts 0) over its
window, against the H100's dense bf16 peak, in %."""

from harness import readers


def read(ctx):
    return readers.mfu(ctx)
