"""``csrc/aligned_patches.cu``: its least time for the traced pass's
levels and keypoints (``counters.aligned_patches_bound_s``) over its
device time, in %."""

from harness import readers


def read(ctx):
    return readers.roofline(ctx, "aligned_patches_kernel", ctx.config["orb"]["num_levels"],
                            readers.aligned_patches_bound_s(ctx))
