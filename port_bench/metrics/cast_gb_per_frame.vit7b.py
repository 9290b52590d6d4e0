"""GB (1e9 bytes) a frame of weights that the frontend's ``Dense`` layers
cast to their compute dtype (the port's counter ``weight_cast_bytes``: the
f32 master weights read for a bf16 copy, once a layer and chunk), median
over the passes; None for a port without the counter."""

from harness import program_trace

COUNTER = "weight_cast_bytes"


def _gb(roots):
    if not any(COUNTER in r["counters"] for r in roots):
        return None
    return program_trace.counter_total(roots, COUNTER) / 1e9


def read(ctx):
    return program_trace._median(program_trace.FRONTEND_ROOTS, _gb)
