"""Host ms a frame inside the SLAM loop's ``sync.*`` spans (each read of a
device value on the host; they sit inside the other spans), median over
the passes."""

from harness import program_trace


def read(ctx):
    return program_trace.sync_wait_ms(ctx)
