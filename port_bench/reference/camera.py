# Frozen copy of semantic_slam_master_tpu_torch/core/camera.py (the port as of the
# benchmark's first version), rewritten to import nothing of the port and
# no kernel, and cut to what the benchmark calls: the plain reference that
# decides `correct`. Do not edit to follow the port.
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


TUM_FR2 = PinholeCamera(fx=520.9, fy=521.0, cx=325.1, cy=249.7)


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


