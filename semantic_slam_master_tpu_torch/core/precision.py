"""Full-float32 matmuls and convolutions on the card.

The JAX package pins its geometry solves (Horn-Kabsch, GN/LM normal
equations, Schur complements) to full f32 (`semantic_slam_master_tpu/
core/precision.py`) and its tests pin every matmul to "highest". The
port's counterpart: TF32 off for cuBLAS matmuls and cuDNN convolutions,
set once when the package is imported.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
