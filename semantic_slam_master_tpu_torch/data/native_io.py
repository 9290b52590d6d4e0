"""ctypes bindings to the repo's threaded C++ PNG loader,
``native/semslam_io.cpp`` (``ssm_png_info``, ``ssm_load_batch``).

The library is built at first use with ``g++ ... -lpng -lz -lpthread``
into the port's git-ignored ``_build/``; it is skipped while the library
is newer than the source. Where it does not build (no compiler, no
``png.h``), ``load_batch`` decodes with ``data/png.py`` instead and gives
the same numbers: the loader scales by a float32 reciprocal,
``src * (1/255.f)`` and ``src * (1/depth_scale)``, and so does the plain
path (``TUMSequence.frame`` divides instead, as the JAX package's
per-frame path does). ``decoder()`` says which decoder is in use and why.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from . import png

SOURCE = Path(__file__).resolve().parents[2] / "native" / "semslam_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
LIB_PATH = BUILD_DIR / "libsemslam_io.so"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native", "-shared"]
LD_FLAGS = ["-lpng", "-lz", "-lpthread"]

_state: dict = {}


def build() -> None:
    """Compile ``SOURCE`` into ``LIB_PATH`` (through a temporary file, so a
    concurrent build never leaves a half-written library); raises on failure."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    if not SOURCE.exists():
        raise RuntimeError(f"{SOURCE} is missing")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp, *LD_FLAGS],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}): {proc.stderr.strip()[-2000:]}")
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    if "lib" in _state:
        return _state["lib"]
    lib, error = None, None
    try:
        if not LIB_PATH.exists() or LIB_PATH.stat().st_mtime <= SOURCE.stat().st_mtime:
            build()
        lib = ctypes.CDLL(str(LIB_PATH))
        lib.ssm_png_info.argtypes = [ctypes.c_char_p] + [ctypes.POINTER(ctypes.c_int)] * 4
        lib.ssm_png_info.restype = ctypes.c_int
        lib.ssm_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
        ]
        lib.ssm_load_batch.restype = ctypes.c_int
    except (RuntimeError, OSError) as e:
        lib, error = None, str(e)
    _state.update(lib=lib, error=error)
    return lib


def available() -> bool:
    return _load() is not None


def decoder() -> dict:
    """``{"name": "native" | "plain", "library": path or None,
    "build_error": message or None}``: the decoder ``load_batch`` uses."""
    lib = _load()
    return {"name": "native" if lib else "plain", "library": str(LIB_PATH) if lib else None,
            "build_error": _state["error"]}


def png_info(path: str | Path):
    """(width, height, channels, bit depth) of a PNG, by the native loader."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_state['error']}")
    w, h, c, b = (ctypes.c_int() for _ in range(4))
    if lib.ssm_png_info(str(path).encode(), w, h, c, b) != 0:
        raise IOError(f"cannot decode {path}")
    return w.value, h.value, c.value, b.value


def _paths_array(paths: Optional[Sequence]):
    if paths is None:
        return None
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [str(p).encode() for p in paths]
    return arr


def load_batch(
    rgb_paths: Optional[Sequence],
    depth_paths: Optional[Sequence],
    width: int = 640,
    height: int = 480,
    depth_scale: float = 5000.0,
    num_threads: int = 8,
):
    """Decode a batch of frames: (rgb (N, H, W, 3) f32 in [0, 1] or None,
    depth (N, H, W) f32 metres or None). Raises ``IOError`` naming the
    first frame that does not decode to (height, width)."""
    lib = _load()
    if lib is None:
        return load_batch_plain(rgb_paths, depth_paths, width, height, depth_scale)
    n = len(rgb_paths) if rgb_paths is not None else len(depth_paths)
    rgb_out = np.empty((n, height, width, 3), np.float32) if rgb_paths else None
    depth_out = np.empty((n, height, width), np.float32) if depth_paths else None
    f32p = ctypes.POINTER(ctypes.c_float)
    rc = lib.ssm_load_batch(
        _paths_array(rgb_paths), _paths_array(depth_paths), n, width, height, depth_scale,
        rgb_out.ctypes.data_as(f32p) if rgb_out is not None else None,
        depth_out.ctypes.data_as(f32p) if depth_out is not None else None,
        num_threads,
    )
    if rc != 0:
        idx = -rc - 1
        raise IOError(f"native decode failed at frame {idx}: {(rgb_paths or depth_paths)[idx]}")
    return rgb_out, depth_out


INV_255 = np.float32(1.0) / np.float32(255.0)


def decode_rgb(path, width: int, height: int) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit RGB or gray PNG (gray broadcast), as the
    native loader takes it."""
    img = png.read_png(path)
    if img.dtype != np.uint8 or img.shape[:2] != (height, width):
        raise IOError(f"{path}: {img.dtype} {img.shape}, expected 8-bit {height}x{width}")
    return np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else img


def decode_depth(path, width: int, height: int) -> np.ndarray:
    """(H, W) uint8 or uint16 of a one-channel PNG."""
    img = png.read_png(path)
    if img.ndim != 2 or img.shape != (height, width):
        raise IOError(f"{path}: {img.shape}, expected one channel at {height}x{width}")
    return img


def load_batch_plain(rgb_paths, depth_paths, width: int = 640, height: int = 480,
                     depth_scale: float = 5000.0):
    """``load_batch`` through ``data/png.py``, bit-equal to the native loader."""
    rgb_out = depth_out = None
    if rgb_paths:
        rgb_out = np.stack([decode_rgb(p, width, height).astype(np.float32) * INV_255 for p in rgb_paths])
    if depth_paths:
        inv_scale = np.float32(1.0) / np.float32(depth_scale)
        depth_out = np.stack([decode_depth(p, width, height).astype(np.float32) * inv_scale
                              for p in depth_paths])
    return rgb_out, depth_out
