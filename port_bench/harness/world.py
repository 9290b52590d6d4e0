"""The traffic generator: a traffic file's world, the same frames for
every seed but for the sensor.

Every traffic mix renders the frozen synthetic room (``synthetic.py``)
with the texture that ``run-slam --synthetic`` renders (seed 0, the world
the committed models were trained on) along one of its trajectories, at
the configuration's camera. ``--seed`` seeds the sensor model applied to
each frame (depth noise, quantisation and holes, motion blur, exposure
drift, RGB noise) and the RANSAC draws, so every seed gives the same
sizes and the same scene, and no seed changes the amount of work by more
than what the noise moves.

The clean render is the same for every seed: it is rendered once per
checkout and kept under ``port_bench/.cache/`` (about 0.3 GB, git-ignored);
each run applies the sensor model to it in a pool of processes. Frames
stay host numpy arrays, as the port's CLI keeps them.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
from pathlib import Path
from typing import NamedTuple

import numpy as np

from . import synthetic
from .camera import PinholeCamera

TRAJECTORIES = {"orbit": synthetic.orbit_trajectory}
TEXTURE_SEED = 0
RENDER_WORKERS = 8
CACHE = Path(__file__).resolve().parents[1] / ".cache"


class World(NamedTuple):
    rgb: np.ndarray  # (F, H, W, 3) f32 in [0, 1]
    gray: np.ndarray  # (F, H, W) f32
    depth: np.ndarray  # (F, H, W) f32 metres, 0 = hole
    poses_wc: np.ndarray  # (F, 4, 4) f64 ground truth, camera in world
    uniforms: np.ndarray  # (F, num_hypotheses, 3) f32 RANSAC draws in [0, 1)


def sequence(traffic: dict, camera) -> synthetic.SyntheticSequence:
    ts, poses = TRAJECTORIES[traffic["trajectory"]](traffic["frames"])
    return synthetic.SyntheticSequence(cam=PinholeCamera(*camera), timestamps=ts, poses_wc=poses,
                                       seed=TEXTURE_SEED)


def _clean(args):
    traffic, camera, i = args
    f = sequence(traffic, camera).frame(i)
    return f["rgb"], f["depth"]


def _sensed(args):
    cache_dir, traffic, camera, seed, i = args
    seq = sequence(traffic, camera)
    rgb = np.load(cache_dir / "rgb.npy", mmap_mode="r")[i]
    depth = np.load(cache_dir / "depth.npy", mmap_mode="r")[i]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, 0xDE, i]))
    t = float(seq.timestamps[i] - seq.timestamps[0])
    sensor = synthetic.SensorModel()
    return sensor.apply_rgb(np.array(rgb), rng, seq._flow_px(i), t), sensor.apply_depth(np.array(depth), rng)


def _map(fn, jobs, workers: int):
    if workers <= 1:
        return [fn(j) for j in jobs]
    with multiprocessing.get_context("spawn").Pool(min(workers, len(jobs))) as pool:
        return pool.map(fn, jobs)


def clean_frames(traffic: dict, camera, workers: int = RENDER_WORKERS) -> Path:
    """The directory holding the clean render of the traffic's world
    (``rgb.npy``, ``depth.npy``), rendered and written on first use."""
    key = {"trajectory": traffic["trajectory"], "frames": traffic["frames"], "camera": list(camera),
           "texture_seed": TEXTURE_SEED, "renderer": "synthetic.py v1"}
    d = CACHE / ("world-" + hashlib.sha256(json.dumps(key, sort_keys=True).encode()).hexdigest()[:16])
    if (d / "rgb.npy").exists() and (d / "depth.npy").exists():
        return d
    frames = _map(_clean, [(traffic, tuple(camera), i) for i in range(traffic["frames"])], workers)
    d.mkdir(parents=True, exist_ok=True)
    for name, arr in (("depth", np.stack([f[1] for f in frames])), ("rgb", np.stack([f[0] for f in frames]))):
        tmp = d / f"{name}.{os.getpid()}.tmp.npy"
        np.save(tmp, arr.astype(np.float32))
        os.replace(tmp, d / f"{name}.npy")
    return d


def render(traffic: dict, camera, seed: int, num_hypotheses: int, workers: int = RENDER_WORKERS) -> World:
    """All frames of the traffic's world for ``seed``, the sensor model
    applied by ``workers`` spawned processes (1: in this process)."""
    n = traffic["frames"]
    camera = tuple(camera)[:7]
    d = clean_frames(traffic, camera, workers)
    frames = _map(_sensed, [(d, traffic, camera, seed, i) for i in range(n)], workers)
    rgb = np.stack([f[0] for f in frames]).astype(np.float32)
    depth = np.stack([f[1] for f in frames]).astype(np.float32)
    # The port CLI's render_all gray conversion.
    gray = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]).astype(np.float32)
    rng = np.random.default_rng([int(seed) % 2**63, 0x5EED])
    uniforms = rng.random((n, num_hypotheses, 3), dtype=np.float32)
    return World(rgb, gray, depth, sequence(traffic, camera).poses_wc, uniforms)
