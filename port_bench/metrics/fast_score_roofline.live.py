"""``csrc/fast_score.cu``: its least time for the pyramid levels of the
traced pass (``counters.fast_score_bound_s``) over its device time, in %."""

from harness import readers


def read(ctx):
    return readers.roofline(ctx, "fast_score_kernel", ctx.config["orb"]["num_levels"], readers.fast_score_bound_s(ctx))
