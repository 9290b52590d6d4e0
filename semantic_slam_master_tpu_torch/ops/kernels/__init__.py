"""Hand-written CUDA kernels and their wrappers.

Each wrapper module holds the kernel's plain PyTorch version beside it.
A wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel (built from ``csrc/`` by ``build``)
or raises. Each wrapper counts its launches in ``<wrapper>.launches``.
"""
