"""The benchmark harness of the PyTorch/CUDA port: the manifest, the
world generator, the system under test, the reference run, the checks,
tracing and the counters behind rooflines and mfu."""
