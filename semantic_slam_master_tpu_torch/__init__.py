"""PyTorch/CUDA port of ``semantic_slam_master_tpu``.

Mirrors the JAX package's layout (``core/``, ``ops/``, ``slam/``,
``data/``, ``eval/``, ``cli/``); the two FAST-9 and patch-gather Pallas
kernels become hand-written CUDA C++ in ``csrc/``, built with ``nvcc``
at first use and bound through ``ctypes`` (``ops/kernels``). Importing
the package pins full-f32 matmuls (``core/precision.py``).
"""

from .core import precision as _precision  # noqa: F401  (pins TF32 off)
