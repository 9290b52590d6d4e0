"""``csrc/gather_patches.cu`` (sub-patch refinement's windows): its least
time (``counters.gather_patches_bound_s``, a floor on the bytes read)
over its device time, in %."""

from harness import readers


def read(ctx):
    return readers.roofline(ctx, "gather_patches_kernel", 1, readers.gather_patches_bound_s(ctx))
