"""The system under test: the port (``semantic_slam_master_tpu_torch``),
built from a configuration file and driven through its own stage
functions, the ones ``run-slam`` calls. Nothing here computes what the
port computes; the drives time these calls and the reference checks what
they return."""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

import semantic_slam_master_tpu_torch  # noqa: F401  (pins TF32 off, as every entry point does)
from semantic_slam_master_tpu_torch import convert
from semantic_slam_master_tpu_torch.cli import run_slam_cli
from semantic_slam_master_tpu_torch.core.camera import PinholeCamera
from semantic_slam_master_tpu_torch.models import frontend as frontend_mod
from semantic_slam_master_tpu_torch.models import segmenter as segmenter_mod
from semantic_slam_master_tpu_torch.ops.kernels import build
from semantic_slam_master_tpu_torch.slam import system, tracking

from . import weights


def build_kernels() -> float:
    """Seconds spent building the port's CUDA library (0 when it is
    already built in the checkout)."""
    seconds = build.build()
    build.library()
    return seconds


def slam_config(config: dict) -> system.SlamConfig:
    return system.SlamConfig(**config["slam"])


class Program:
    """The port at one configuration, on ``device``: its models loaded
    from the committed weights or drawn from the configuration's seed
    (``harness/weights.py``), its stages called as ``run-slam`` calls
    them. ``weight_shapes`` keeps each model's state-dict keys and shapes
    for the reference to be held to."""

    def __init__(self, config: dict, root, device: torch.device):
        self.config, self.device = config, device
        self.cam = PinholeCamera(**config["camera"])
        self.slam_cfg = slam_config(config)
        self.frontend = self.segmenter = None
        self.weight_shapes = {}
        if config["frontend"] == "learned":
            m = config["model"]
            make = partial(frontend_mod.LearnedFrontend, **m["sizes"], dtype=torch.bfloat16)
            if "weights" in m:
                self.frontend = weights.drawn(make, m, device)
            else:
                model = make()
                model.load_state_dict(convert.frontend_state_dict(str(root / m["checkpoint"])))
                self.frontend = model.to(device).eval()
            self.weight_shapes["model"] = weights.shapes(self.frontend)
        if config.get("semantics") == "model":
            s = config["segmenter"]
            make = partial(segmenter_mod.SemanticSegmenter, **s["sizes"])
            if "weights" in s:
                self.segmenter = weights.drawn(make, s, device)
            else:
                seg = make()
                seg.load_state_dict(convert.segmenter_state_dict(str(root / s["checkpoint"])))
                self.segmenter = seg.to(device).eval()
            self.weight_shapes["segmenter"] = weights.shapes(self.segmenter)

    def weight_maps(self, rgb: np.ndarray):
        """(F, H/4, W/4) semantic weights on the device, or None."""
        if self.segmenter is None:
            return None
        return run_slam_cli.semantic_weight_maps(rgb, None, "model", self.device, self.segmenter)

    def features(self, rgb: np.ndarray, gray: np.ndarray, depth: np.ndarray, weight_map=None):
        """``FrameFeatures`` of every frame, on the device, by the CLI's
        chunked frontends."""
        if self.frontend is not None:
            return run_slam_cli.learned_features_for_frames(
                self.frontend, rgb, depth, self.device, chunk=self.config["chunk"], weight_map=weight_map)
        return run_slam_cli.features_for_frames(
            gray, depth, self.config["orb"]["num_keypoints"], self.device, chunk=self.config["chunk"],
            weight_map=weight_map)

    def slam(self, uniforms: np.ndarray, feats) -> np.ndarray:
        """``system.run_slam`` over a pass's features; (F, 4, 4) poses on the host."""
        u = torch.from_numpy(uniforms).to(self.device)
        out = system.run_slam(u, feats, self.cam, self.slam_cfg)
        return out.poses_wc.cpu().numpy()

    # Live tracking: one frame at a time, closed loop.

    def live_features(self, gray: np.ndarray, depth: np.ndarray):
        """ORB features of one (1, H, W) frame, copied to the device here."""
        o = self.config["orb"]
        return tracking.extract_features(torch.from_numpy(gray).to(self.device),
                                         torch.from_numpy(depth).to(self.device),
                                         num_keypoints=o["num_keypoints"])

    def live_start(self, feats):
        """Bootstrap the map on a pass's first frame; returns the tracker's
        carry (state, pose, frames since the last keyframe)."""
        state = system.bootstrap_map(system.frame(feats, 0), self.cam, self.slam_cfg)
        return state, torch.eye(4, dtype=torch.float32, device=self.device), 0

    def live_step(self, carry, uniforms: np.ndarray, feats):
        """One tracked frame; returns the new carry."""
        u = torch.from_numpy(uniforms[None]).to(self.device)
        carry, _ = system.run_slam_steps(u, feats, self.cam, self.slam_cfg, *carry)
        return carry
