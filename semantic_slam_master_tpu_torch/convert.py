"""Convert the JAX package's state into the port's tensors and back.

Takes the JAX package's NamedTuples (or anything with the same field
names) holding numpy-convertible arrays, so this module imports neither
JAX nor the JAX package. Packed uint32 descriptor words become int64.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.camera import PinholeCamera
from .slam.system import MapState
from .slam.tracking import FrameFeatures


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a)).to(device)


def frame_features(feats, device="cpu") -> FrameFeatures:
    """JAX ``FrameFeatures`` -> the port's, on ``device``."""
    return FrameFeatures(*[_tensor(getattr(feats, f), device) for f in FrameFeatures._fields])


def frame_features_to_numpy(feats: FrameFeatures) -> dict:
    """The port's ``FrameFeatures`` -> numpy arrays by field, packed words
    as uint32 (``tracking.FrameFeatures(**out)`` in the JAX package)."""
    out = {f: getattr(feats, f).detach().cpu().numpy() for f in FrameFeatures._fields}
    out["desc"] = out["desc"].astype(np.uint32)
    return out


def map_state(state, device="cpu") -> MapState:
    """JAX ``MapState`` -> the port's, on ``device`` (ring pointers as ints)."""
    fields = {}
    for f in MapState._fields:
        v = getattr(state, f)
        fields[f] = int(np.asarray(v)) if f in ("write_ptr", "kf_ptr") else _tensor(v, device)
    return MapState(**fields)


def camera(cam) -> PinholeCamera:
    """JAX ``PinholeCamera`` -> the port's."""
    return PinholeCamera(*[getattr(cam, f) for f in PinholeCamera._fields])


def test_pattern(pattern) -> np.ndarray:
    """A (256, 4) BRIEF test pattern as the int8 array ``orb.describe`` takes."""
    p = np.asarray(pattern, dtype=np.int8)
    if p.shape != (256, 4):
        raise ValueError(f"test pattern must be (256, 4), got {p.shape}")
    return p
