"""The plain reference of the benchmark's configurations: frozen copies of
the port's plain PyTorch paths (no CUDA kernel, no import of the port),
run in float32 with TF32 off."""
