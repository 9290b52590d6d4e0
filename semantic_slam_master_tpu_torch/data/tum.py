"""TUM RGB-D sequence loading and frame-pair batching (numpy copy of
``data/tum.py``).

A sequence directory holds ``rgb/`` and ``depth/`` PNGs named by their
timestamps and, optionally, ``groundtruth.txt``. Frames pair by sorted
file order; each frame takes the ground-truth pose nearest its
timestamp. PNGs are decoded by ``data/png.py`` frame by frame (``frame``,
``pair``: divided by 255 and by the depth scale, as the JAX package's
PIL path does) or by the native loader for a whole sequence
(``load_all_gray_depth``: multiplied by the float32 reciprocals, as the
loader does). ``pair`` gives a training pair resized to the model input,
ImageNet-normalised, optionally augmented with a seed shared by both
frames.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.camera import TUM_FR1, PinholeCamera, camera_for_sequence
from . import png
from .associate import associate_file_lists, nearest_indices, read_stamped_file_list, write_associations
from .trajectory_io import quat_to_matrix_f32

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def imagenet_normalize(rgb: np.ndarray) -> np.ndarray:
    """[0,1] float RGB (..., H, W, 3) -> ImageNet-normalized."""
    return (rgb - IMAGENET_MEAN) / IMAGENET_STD


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize (H, W[, C]) by separable linear interpolation,
    half-pixel centres (align_corners=False), no antialiasing."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img.astype(np.float32, copy=False)
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)
    wx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)
    img = img.astype(np.float32)
    if img.ndim == 3:
        top = img[y0][:, x0] * (1 - wx)[None, :, None] + img[y0][:, x1] * wx[None, :, None]
        bot = img[y1][:, x0] * (1 - wx)[None, :, None] + img[y1][:, x1] * wx[None, :, None]
        return top * (1 - wy)[:, None, None] + bot * wy[:, None, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy)[:, None] + bot * wy[:, None]


def resize_nearest(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Nearest-neighbour resize (the depth maps')."""
    h, w = img.shape[:2]
    ys = np.clip((np.arange(out_h) * h) // out_h, 0, h - 1)
    xs = np.clip((np.arange(out_w) * w) // out_w, 0, w - 1)
    return img[ys][:, xs]


@dataclass
class AugmentationConfig:
    """Photometric augmentation knobs (the JAX package's defaults)."""

    enabled: bool = True
    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.2
    hue: float = 0.1
    gaussian_blur: float = 0.3  # probability


def _rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def apply_augmentation(rgb: np.ndarray, seed: int, cfg: AugmentationConfig) -> np.ndarray:
    """Colour jitter (brightness, contrast, saturation, a hue rotation in
    YIQ) and an optional blur, a pure function of ``seed``: the draws are
    the JAX package's ``default_rng(seed)`` calls, in its order. Both
    frames of a training pair take the same seed. (H, W, 3) in [0, 1]."""
    if not cfg.enabled:
        return rgb
    rng = np.random.default_rng(seed)
    out = rgb.astype(np.float32)
    b = rng.uniform(1 - cfg.brightness, 1 + cfg.brightness)
    c = rng.uniform(1 - cfg.contrast, 1 + cfg.contrast)
    s = rng.uniform(1 - cfg.saturation, 1 + cfg.saturation)
    h = rng.uniform(-cfg.hue, cfg.hue)

    out = out * b
    gray_mean = _rgb_to_gray(out).mean()
    out = (out - gray_mean) * c + gray_mean
    gray = _rgb_to_gray(out)[..., None]
    out = (out - gray) * s + gray
    if abs(h) > 1e-6:
        theta = 2 * np.pi * h
        cos_t, sin_t = np.cos(theta), np.sin(theta)
        yiq = np.stack(
            [
                _rgb_to_gray(out),
                0.596 * out[..., 0] - 0.274 * out[..., 1] - 0.322 * out[..., 2],
                0.211 * out[..., 0] - 0.523 * out[..., 1] + 0.312 * out[..., 2],
            ],
            axis=-1,
        )
        i = yiq[..., 1] * cos_t - yiq[..., 2] * sin_t
        q = yiq[..., 1] * sin_t + yiq[..., 2] * cos_t
        out = np.stack(
            [
                yiq[..., 0] + 0.956 * i + 0.621 * q,
                yiq[..., 0] - 0.272 * i - 0.647 * q,
                yiq[..., 0] - 1.106 * i + 1.703 * q,
            ],
            axis=-1,
        )
    if rng.random() < cfg.gaussian_blur:
        sigma = rng.uniform(0.1, 2.0)
        out = _gaussian_blur(out, sigma)
    return np.clip(out, 0.0, 1.0)


def _gaussian_blur(img: np.ndarray, sigma: float, ksize: int = 5) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-(x**2) / (2 * sigma**2))
    k /= k.sum()
    pad_h = np.pad(img, [(r, r), (0, 0), (0, 0)], mode="reflect")
    tmp = sum(pad_h[i : i + img.shape[0]] * k[i] for i in range(ksize))
    pad_w = np.pad(tmp, [(0, 0), (r, r), (0, 0)], mode="reflect")
    return sum(pad_w[:, i : i + img.shape[1]] * k[i] for i in range(ksize))


def load_groundtruth_file(path: str | Path):
    """groundtruth.txt -> (timestamps (N,) f64, poses (N, 4, 4) f64). The
    rotations are computed in float32 from float32 quaternions
    (``quat_to_matrix_f32``), as the JAX package computes them (its arrays
    are 32-bit), then stored in f64."""
    times: List[float] = []
    rows: List[np.ndarray] = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 8:
                continue
            times.append(float(parts[0]))
            rows.append(np.array([float(p) for p in parts[1:8]]))
    arr = np.stack(rows)
    Rs = quat_to_matrix_f32(arr[:, 3:7])
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, :3] = Rs
    poses[:, :3, 3] = arr[:, 0:3]
    return np.asarray(times), poses


def load_rgb_file(path) -> np.ndarray:
    """(H, W, 3) f32 in [0, 1] of an 8-bit PNG (gray broadcast to RGB),
    divided by 255."""
    img = png.read_png(path)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img.astype(np.float32) / 255.0


class TUMSequence:
    """A TUM RGB-D sequence directory (rgb/, depth/, groundtruth.txt),
    decoded lazily; per-frame dicts and training pairs with the JAX
    package's key names."""

    def __init__(
        self,
        root: str | Path,
        sequence: str | None = None,
        input_size: int = 448,
        frame_spacing: int = 1,
        max_frames: Optional[int] = None,
        augmentation: Optional[AugmentationConfig] = None,
        camera: Optional[PinholeCamera] = None,
    ):
        root = Path(root)
        seq_dir = root / sequence if sequence and (root / sequence).exists() else root
        self.sequence_dir = seq_dir
        self.name = sequence or seq_dir.name
        self.input_size = input_size
        self.frame_spacing = frame_spacing
        self.augmentation = augmentation
        self.camera = camera or _camera_or_default(self.name)

        rgb_dir = seq_dir / "rgb"
        depth_dir = seq_dir / "depth"
        if not rgb_dir.exists() or not depth_dir.exists():
            raise FileNotFoundError(f"rgb/depth directories not found under {seq_dir}")
        rgb_files = sorted(f for f in os.listdir(rgb_dir) if f.endswith(".png"))
        depth_files = sorted(f for f in os.listdir(depth_dir) if f.endswith(".png"))
        n = min(len(rgb_files), len(depth_files))
        self.rgb_files = [rgb_dir / f for f in rgb_files[:n]]
        self.depth_files = [depth_dir / f for f in depth_files[:n]]
        # The file name's stem is the timestamp.
        self.timestamps = np.array([float(Path(f).name.rsplit(".png", 1)[0]) for f in rgb_files[:n]])

        gt_file = seq_dir / "groundtruth.txt"
        self.poses = None
        if gt_file.exists():
            gt_times, gt_poses = load_groundtruth_file(gt_file)
            self.poses = gt_poses[nearest_indices(self.timestamps, gt_times)]

        if max_frames is not None:
            self.rgb_files = self.rgb_files[:max_frames]
            self.depth_files = self.depth_files[:max_frames]
            self.timestamps = self.timestamps[:max_frames]
            if self.poses is not None:
                self.poses = self.poses[:max_frames]

    def __len__(self) -> int:
        return max(0, len(self.rgb_files) - self.frame_spacing)

    @property
    def cam(self) -> PinholeCamera:
        return self.camera

    def num_frames(self) -> int:
        return len(self.rgb_files)

    def load_rgb(self, i: int) -> np.ndarray:
        return load_rgb_file(self.rgb_files[i])

    def load_depth(self, i: int) -> np.ndarray:
        return png.read_png(self.depth_files[i]).astype(np.float32) / self.camera.depth_scale

    def load_all_gray_depth(self, num_threads: int = 8):
        """The whole sequence through ``native_io.load_batch`` (the plain
        decoder where the native one does not build): (gray (N, H, W) f32,
        depth (N, H, W) f32 metres) at native resolution."""
        from . import native_io

        rgb, depth = native_io.load_batch(
            self.rgb_files,
            self.depth_files,
            width=self.camera.width,
            height=self.camera.height,
            depth_scale=self.camera.depth_scale,
            num_threads=num_threads,
        )
        gray = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]).astype(np.float32)
        return gray, depth

    def frame(self, i: int) -> Dict[str, np.ndarray]:
        out = {
            "rgb": self.load_rgb(i),
            "depth": self.load_depth(i),
            "timestamp": float(self.timestamps[i]),
        }
        if self.poses is not None:
            out["pose_wc"] = self.poses[i]
        return out

    def pair(self, idx: int, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        """A training frame pair resized and normalised to the model input."""
        i1, i2 = idx, idx + self.frame_spacing
        size = self.input_size
        rgb1 = self.load_rgb(i1)
        rgb2 = self.load_rgb(i2)
        if self.augmentation is not None and seed is not None:
            rgb1 = apply_augmentation(rgb1, seed, self.augmentation)
            rgb2 = apply_augmentation(rgb2, seed, self.augmentation)
        rgb1 = imagenet_normalize(resize_bilinear(rgb1, size, size))
        rgb2 = imagenet_normalize(resize_bilinear(rgb2, size, size))
        depth1 = resize_nearest(self.load_depth(i1), size, size)
        depth2 = resize_nearest(self.load_depth(i2), size, size)
        out = {
            "rgb1": rgb1.astype(np.float32),
            "rgb2": rgb2.astype(np.float32),
            "depth1": depth1.astype(np.float32),
            "depth2": depth2.astype(np.float32),
            "timestamp1": float(self.timestamps[i1]),
            "timestamp2": float(self.timestamps[i2]),
        }
        if self.poses is not None:
            out["pose1"] = self.poses[i1].astype(np.float32)
            out["pose2"] = self.poses[i2].astype(np.float32)
            out["relative_pose"] = (self.poses[i2] @ np.linalg.inv(self.poses[i1])).astype(np.float32)
        return out


def _camera_or_default(name: str) -> PinholeCamera:
    try:
        return camera_for_sequence(name)
    except ValueError:
        return TUM_FR1


def write_tum_sequence(seq, root: str | Path, name: str, filters="up", depth_scale: float = 5000.0) -> Path:
    """Write every frame of a sequence with ``frame(i)`` (rgb in [0, 1],
    metric depth, ``pose_wc``) as the TUM directory ``root/name``: 8-bit RGB
    PNGs and 16-bit depth PNGs (metres x ``depth_scale``) named by their
    timestamps, with the PNG row filter ``filters``; ``rgb.txt`` and
    ``depth.txt``; ``groundtruth.txt`` (translation and quaternion
    qx qy qz qw per timestamp); and ``associations.txt`` from
    ``associate_file_lists``. Returns the directory."""
    import torch

    from ..core import lie

    out = Path(root) / name
    (out / "rgb").mkdir(parents=True, exist_ok=True)
    (out / "depth").mkdir(exist_ok=True)
    lines = {"rgb": [], "depth": [], "gt": []}
    for i in range(len(seq)):
        f = seq.frame(i)
        ts = f"{float(seq.timestamps[i]):.6f}"
        rgb = np.clip(np.round(np.asarray(f["rgb"], np.float64) * 255.0), 0, 255).astype(np.uint8)
        depth = np.nan_to_num(np.asarray(f["depth"], np.float64) * depth_scale, nan=0.0, posinf=0.0)
        png.write_png(out / "rgb" / f"{ts}.png", rgb, filters)
        png.write_png(out / "depth" / f"{ts}.png", np.clip(np.round(depth), 0, 65535).astype(np.uint16), filters)
        T = np.asarray(f["pose_wc"], np.float64)
        q = lie.matrix_to_quat(torch.from_numpy(T[:3, :3])).numpy()
        lines["rgb"].append(f"{ts} rgb/{ts}.png")
        lines["depth"].append(f"{ts} depth/{ts}.png")
        lines["gt"].append(f"{ts} " + " ".join(f"{v:.9f}" for v in (*T[:3, 3], *q)))
    for key, fname, header in (("rgb", "rgb.txt", "# color images"), ("depth", "depth.txt", "# depth maps"),
                               ("gt", "groundtruth.txt", "# timestamp tx ty tz qx qy qz qw")):
        (out / fname).write_text("\n".join([header] + lines[key]) + "\n")
    write_associations(associate_file_lists(read_stamped_file_list(out / "rgb.txt"),
                                            read_stamped_file_list(out / "depth.txt")), out / "associations.txt")
    return out


def batch_pairs(pairs: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of pair dicts into batched arrays."""
    keys = pairs[0].keys()
    return {k: np.stack([np.asarray(p[k]) for p in pairs]) for k in keys}
