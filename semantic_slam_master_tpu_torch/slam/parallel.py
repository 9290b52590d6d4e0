"""Fleet SLAM: independent sequences spread over the mesh's 'data' axis
(port of ``slam/parallel.py``).

The tracking and BA state is small but depends on frame order, so the way
to use N devices is N sequences (or N disjoint chunks of one long
sequence) at once, not parallelism inside a frame. Each rank runs its
sequences one after another through the unbatched ``system.run_slam``, so
the keyframe branch stays a real branch: a batched lock-step fleet would
run window BA on every frame of every sequence. The sequences are
independent; the only collective is the gather of the outputs at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import prng
from ..core.camera import PinholeCamera
from ..parallel import mesh as mesh_lib
from .system import SlamConfig, SlamOutput, run_slam
from .tracking import FrameFeatures


def run_slam_fleet(
    keys,
    features: FrameFeatures,
    cam: PinholeCamera,
    cfg: SlamConfig,
    mesh: mesh_lib.Mesh | None = None,
) -> SlamOutput:
    """Run S independent SLAM sequences over ``mesh``'s 'data' axis.

    keys: (S, 2) uint32 key words, one JAX PRNG key per sequence
    (``core.prng``), so each sequence draws the JAX ``run_slam``'s RANSAC
    uniforms; ``features`` leaves are (S, F, ...). S must be a multiple of
    the data axis; each rank runs its S / num_data sequences one after
    another on the features' device, and every rank returns all S. With
    no mesh, or a mesh of one rank, one process runs all S. Returns
    SlamOutput with a leading (S,) axis.
    """
    mesh = mesh or mesh_lib.Mesh()
    keys = np.asarray(keys, np.uint32)
    S, F = keys.shape[0], features.xy.shape[1]
    if S % mesh.num_data:
        raise ValueError(f"{S} sequences over a data axis of {mesh.num_data}")
    n = S // mesh.num_data
    lo = mesh.data_rank * n
    dev = features.xy.device
    outs = []
    for s in range(lo, lo + n):
        uniforms = torch.from_numpy(prng.key_slam_uniforms(keys[s], F, cfg.num_hypotheses)).to(dev)
        outs.append(run_slam(uniforms, FrameFeatures(*[x[s] for x in features]), cam, cfg))
    local = SlamOutput(*[torch.stack(field) for field in zip(*outs)])
    return SlamOutput(*[mesh_lib.gather(x, mesh.data_group) for x in local])
