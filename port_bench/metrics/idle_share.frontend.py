"""1 - the union of device-op intervals over the traced pass's host-clock
window."""

from harness import readers


def read(ctx):
    return readers.idle_share(ctx)
