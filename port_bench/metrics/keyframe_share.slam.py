"""Keyframes a frame in the SLAM loop (the port's counter ``keyframes``
plus the bootstrap frame, as ``is_keyframe`` counts them), median over
the passes."""

from harness import program_trace


def read(ctx):
    return program_trace.keyframe_share(ctx)
