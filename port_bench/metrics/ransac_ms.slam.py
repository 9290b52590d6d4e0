"""Host ms a frame in the port's span ``slam.ransac`` (``pnp.ransac_pose``:
draws, the Kabsch hypotheses, scoring, the best hypothesis's mask), median
over the passes."""

from harness import program_trace


def read(ctx):
    return program_trace.loop_span_ms(ctx, "slam.ransac")
