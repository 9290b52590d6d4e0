"""Device ms a frame between the CUDA events of the port's span
``frontend.backbone`` (the ViT of ``LearnedFrontend.forward``), median
over the passes."""

from harness import program_trace


def read(ctx):
    return program_trace.frontend_device_ms(ctx, "frontend.backbone")
