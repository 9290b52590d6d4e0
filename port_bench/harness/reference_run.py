"""Runs the plain reference (``reference/``) over a world: what the port
should have produced for the same frames, weights and RANSAC draws.

``precision="reference"`` is float32 with TF32 off. ``"control"`` is the
configuration's ``control``: the same reference one precision below the
one the configuration states (``"tf32"``: TF32 matmuls for a float32
path; ``"fp8"``: float8 e4m3 operands with float32 sums for the
bfloat16 models, and TF32 for the float32 rest). The control has to come
out as not correct.

The SLAM loop's reference follows the features it is given: the port's
poses are judged against the reference loop run over the port's own
features, and the port's features, by themselves, against the
reference's. SLAM is chaotic: two sound feature sets a rounding apart
give trajectories centimetres apart, which would hide the loop's own
faults.
"""

from __future__ import annotations

import contextlib
import importlib
from functools import partial

import numpy as np
import torch

from reference import segmenter as ref_segmenter
from reference import system as ref_system
from reference import tracking as ref_tracking
from reference import weights as ref_weights
from reference.camera import PinholeCamera
from reference.layers import FP8

from . import weights

CHUNK = 8  # frames per block, so that the float32 models fit beside nothing else


@contextlib.contextmanager
def tf32(enabled: bool):
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def frontend_module(config: dict):
    """The reference module (``reference/<model.reference>.py``, default
    ``frontend``) whose ``LearnedFrontend`` stands for the port's."""
    return importlib.import_module(f"reference.{config['model'].get('reference', 'frontend')}")


class Reference:
    """The reference of one configuration, its models read from the same
    committed weight files as the port's, or drawn from the same seed
    (``harness/weights.py``); ``weight_shapes`` as ``Program``'s."""

    def __init__(self, config: dict, root, device: torch.device, precision: str = "reference"):
        if precision not in ("reference", "control"):
            raise ValueError(f"precision {precision!r}")
        self.config, self.device = config, device
        self.control = config["control"] if precision == "control" else None
        dtype = FP8 if self.control == "fp8" else torch.float32
        self.cam = PinholeCamera(**config["camera"])
        self.slam_cfg = ref_system.SlamConfig(**config["slam"])
        self.frontend = self.segmenter = None
        self.weight_shapes = {}
        if config["frontend"] == "learned":
            m = config["model"]
            make = partial(frontend_module(config).LearnedFrontend, **m["sizes"], dtype=dtype)
            if "weights" in m:
                self.frontend = weights.drawn(make, m, device)
            else:
                model = make()
                model.load_state_dict(ref_weights.frontend_state_dict(str(root / m["checkpoint"])))
                self.frontend = model.to(device).eval()
            self.weight_shapes["model"] = weights.shapes(self.frontend)
        if config.get("semantics") == "model":
            s = config["segmenter"]
            make = partial(ref_segmenter.SemanticSegmenter, **s["sizes"], dtype=dtype)
            if "weights" in s:
                self.segmenter = weights.drawn(make, s, device)
            else:
                seg = make()
                seg.load_state_dict(ref_weights.segmenter_state_dict(str(root / s["checkpoint"])))
                self.segmenter = seg.to(device).eval()
            self.weight_shapes["segmenter"] = weights.shapes(self.segmenter)

    def _blocks(self, *arrays):
        n = len(arrays[0])
        for i in range(0, n, CHUNK):
            yield [None if a is None else torch.as_tensor(a[i : i + CHUNK]).to(self.device) for a in arrays]

    def weight_maps(self, rgb: np.ndarray):
        if self.segmenter is None:
            return None
        out = []
        with torch.no_grad():
            for (x,) in self._blocks(rgb):
                labels = ref_segmenter.predict_classes(self.segmenter(x, full_res=False))
                out.append(ref_segmenter.class_weights_map(labels, self.config["segmenter"]["class_weights"]))
        return torch.cat(out)

    def features(self, rgb, gray, depth, weight_map=None) -> ref_tracking.FrameFeatures:
        outs = []
        wm = None if weight_map is None else weight_map
        for i, (x, g, d) in enumerate(self._blocks(rgb, gray, depth)):
            w = None if wm is None else wm[i * CHUNK : (i + 1) * CHUNK]
            if self.frontend is not None:
                outs.append(ref_tracking.extract_learned_features(self.frontend, x, d, weight_map=w))
            else:
                o = self.config["orb"]
                outs.append(ref_tracking.extract_features(
                    g, d, num_keypoints=o["num_keypoints"], threshold=o["fast_threshold"],
                    nms_radius=o["nms_radius"], weight_map=w, num_levels=o["num_levels"],
                    scale_factor=o["scale_factor"], subpixel=o["subpixel"]))
        return ref_tracking.FrameFeatures(*[torch.cat(xs) for xs in zip(*outs)])

    def slam(self, uniforms: np.ndarray, feats) -> np.ndarray:
        u = torch.from_numpy(uniforms).to(self.device)
        out = ref_system.run_slam(u, feats, self.cam, self.slam_cfg)
        self.keyframes = int(out.is_keyframe.sum())
        return out.poses_wc.cpu().numpy()

    def run(self, world, with_slam: bool, follow=None) -> dict:
        """The reference's weight maps and features for every frame of
        ``world`` and (``with_slam``) its poses over the features
        ``follow``, or over its own features when that is None."""
        with tf32(self.control is not None):
            wm = self.weight_maps(world.rgb)
            feats = self.features(world.rgb, world.gray, world.depth, wm)
            poses = None
            if with_slam:
                poses = self.slam(world.uniforms, feats if follow is None else follow)
        return {"weight_map": wm, "features": feats, "poses": poses}
