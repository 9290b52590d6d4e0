"""Host ms a frame in the port's span ``slam.refine`` (``pnp.ransac_pose``:
the Gauss-Newton polish, rescoring, refine-or-keep, rmse), median over the
passes."""

from harness import program_trace


def read(ctx):
    return program_trace.loop_span_ms(ctx, "slam.refine")
