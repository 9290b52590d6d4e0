"""The pinhole intrinsics the world generator renders with, free of
torch so that render workers start quickly (the fields of
``reference/camera.py::PinholeCamera``)."""

from __future__ import annotations

from typing import NamedTuple


class PinholeCamera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int = 640
    height: int = 480
    depth_scale: float = 5000.0


TUM_FR2 = PinholeCamera(fx=520.9, fy=521.0, cx=325.1, cy=249.7)
