"""Device ms a frame in the port's spans ``frontend.backbone.ffn``, one a
block and chunk: LN2, the SwiGLU's three products and gate, the second
LayerScale with its residual add. Median over the passes; None for a port
without the span."""

from harness import program_trace


def read(ctx):
    return program_trace.frontend_device_ms(ctx, "frontend.backbone.ffn")
