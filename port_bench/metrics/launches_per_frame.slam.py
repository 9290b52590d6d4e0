"""Device kernels per frame launched inside the SLAM loop's span (a count
from the profiler's trace)."""

from harness import readers


def read(ctx):
    return readers.launches_per_frame(ctx, "slam")
