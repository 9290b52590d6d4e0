"""Host ms a frame in the port's span ``slam.map`` (the keyframe's and the
bootstrap's landmark insert and keyframe row), median over the passes."""

from harness import program_trace


def read(ctx):
    return program_trace.loop_span_ms(ctx, "slam.map")
