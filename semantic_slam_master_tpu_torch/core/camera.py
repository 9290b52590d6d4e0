"""Pinhole camera models and TUM RGB-D intrinsics (port of ``core/camera.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class PinholeCamera(NamedTuple):
    """Pinhole intrinsics as plain Python numbers."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int = 640
    height: int = 480
    depth_scale: float = 5000.0  # TUM 16-bit depth -> meters divisor

    @property
    def K(self) -> torch.Tensor:
        """(3, 3) f32 intrinsic matrix."""
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
                            dtype=torch.float32)

    @property
    def K_inv(self) -> torch.Tensor:
        """(3, 3) f32 inverse intrinsics, in closed form."""
        return torch.tensor(
            [[1.0 / self.fx, 0.0, -self.cx / self.fx], [0.0, 1.0 / self.fy, -self.cy / self.fy], [0.0, 0.0, 1.0]],
            dtype=torch.float32,
        )

    def scaled(self, sx: float, sy: float) -> "PinholeCamera":
        """Intrinsics after resizing the image by (sx, sy)."""
        return self._replace(
            fx=self.fx * sx,
            fy=self.fy * sy,
            cx=self.cx * sx,
            cy=self.cy * sy,
            width=int(round(self.width * sx)),
            height=int(round(self.height * sy)),
        )


TUM_FR1 = PinholeCamera(fx=517.3, fy=516.5, cx=318.6, cy=255.3)
TUM_FR2 = PinholeCamera(fx=520.9, fy=521.0, cx=325.1, cy=249.7)
TUM_FR3 = PinholeCamera(fx=535.4, fy=539.2, cx=320.1, cy=247.6)

CAMERAS = {"freiburg1": TUM_FR1, "freiburg2": TUM_FR2, "freiburg3": TUM_FR3}


def camera_for_sequence(sequence: str) -> PinholeCamera:
    """Intrinsics picked from a TUM sequence name (e.g.
    ``rgbd_dataset_freiburg1_desk``): the first ``CAMERAS`` key it contains."""
    for key, cam in CAMERAS.items():
        if key in sequence:
            return cam
    raise ValueError(f"cannot infer camera from sequence name: {sequence}")


def project(points_cam: torch.Tensor, cam: PinholeCamera) -> torch.Tensor:
    """Camera-frame 3D points (..., 3) -> pixels (..., 2); Z clamped away
    from zero so the op stays finite inside optimisation loops."""
    z = points_cam[..., 2]
    z_safe = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    u = cam.fx * points_cam[..., 0] / z_safe + cam.cx
    v = cam.fy * points_cam[..., 1] / z_safe + cam.cy
    return torch.stack([u, v], dim=-1)


def backproject(pixels: torch.Tensor, depth: torch.Tensor, cam: PinholeCamera) -> torch.Tensor:
    """Lift pixels (..., 2) with metric depth (...,) to camera-frame points."""
    x = (pixels[..., 0] - cam.cx) / cam.fx * depth
    y = (pixels[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def in_bounds(pixels: torch.Tensor, cam: PinholeCamera, margin: float = 0.0) -> torch.Tensor:
    """Boolean mask of pixels inside the image frame."""
    u, v = pixels[..., 0], pixels[..., 1]
    return (
        (u >= margin)
        & (u <= cam.width - 1 - margin)
        & (v >= margin)
        & (v <= cam.height - 1 - margin)
    )


def rotation_homography(K: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Rotation-only homography ``H = K R K^{-1}``."""
    return K @ R @ torch.linalg.inv(K)


def apply_homography(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Warp (..., N, 2) points by a 3x3 homography; the homogeneous scale
    is kept away from 0 with its sign."""
    homo = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    warped = homo @ H.transpose(-1, -2)
    w = warped[..., 2:3]
    return warped[..., :2] / torch.clamp(w.abs(), min=1e-8) * torch.sign(w)
