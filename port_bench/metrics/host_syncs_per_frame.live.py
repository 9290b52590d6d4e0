"""The port's counter ``host_syncs`` in the SLAM loop a frame: reads of a
device value on the host, median over the passes."""

from harness import program_trace


def read(ctx):
    return program_trace.loop_counter_per_frame(ctx, "host_syncs")
