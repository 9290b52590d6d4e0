"""Host ms a frame in the port's span ``slam.ba`` (window bundle
adjustment on each keyframe), median over the passes."""

from harness import program_trace


def read(ctx):
    return program_trace.loop_span_ms(ctx, "slam.ba")
