"""MB (1e6 bytes) a frame that the segmenter's and the frontend's calls
copy from the host to the device (the port's counter ``h2d_bytes``),
median over the passes."""

from harness import program_trace


def read(ctx):
    return program_trace.h2d_mb_per_frame(ctx)
