"""Device ms a frame in the port's spans ``frontend.backbone.attn``, one a
block and chunk: LN1, qkv, RoPE, the f32 scores, softmax, the product with
V, the output projection and the first LayerScale with its residual add.
Median over the passes; None for a port without the span."""

from harness import program_trace


def read(ctx):
    return program_trace.frontend_device_ms(ctx, "frontend.backbone.attn")
