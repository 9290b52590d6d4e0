"""Host ms a frame in the port's spans ``stage.pad`` and ``stage.copy``
(padding the frames to whole chunks, copying them to the device) in the
segmenter's and the frontend's calls, median over the passes."""

from harness import program_trace


def read(ctx):
    return program_trace.staging_ms(ctx)
