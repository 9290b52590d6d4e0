"""Device ms a frame between the CUDA events of the port's span
``frontend.heads`` (selector, top-k, sub-patch refinement, descriptors,
confidence), median over the passes."""

from harness import program_trace


def read(ctx):
    return program_trace.frontend_device_ms(ctx, "frontend.heads")
