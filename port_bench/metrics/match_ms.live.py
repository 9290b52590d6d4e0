"""Host ms a frame in the port's span ``slam.match`` (descriptor matching
against the map in ``system.slam_step``), median over the passes."""

from harness import program_trace


def read(ctx):
    return program_trace.loop_span_ms(ctx, "slam.match")
