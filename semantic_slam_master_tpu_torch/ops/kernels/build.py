"""Build ``csrc/*.cu`` into one shared library with ``nvcc`` and load it.

One ``nvcc`` call compiles every source for ``sm_90a`` into
``_build/libsemslam_kernels.so`` inside the package (a git-ignored
directory). The sources include no PyTorch header: each kernel has a
plain ``extern "C"`` launcher taking raw pointers, ints and the CUDA
stream, returning ``cudaGetLastError()``. The build runs at first use and
is skipped while the library is newer than every source.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_PATH = BUILD_DIR / "libsemslam_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_vp = ctypes.c_void_p
_int = ctypes.c_int
# name -> argtypes of each launcher (pointers and the stream as c_void_p).
SIGNATURES = {
    "semslam_fast_score": [_vp, _vp, _int, _int, _int, ctypes.c_float, _vp],
    "semslam_aligned_patches": [_vp, _vp, _vp, _int, _int, _int, _int, _vp],
    "semslam_gather_patches": [_vp, _vp, _vp, *[_int] * 10, _vp],
    "semslam_pnp_refine": [*[_vp] * 15, _int, _int, *[ctypes.c_float] * 7, _vp],
    "semslam_ransac": [*[_vp] * 15, _int, _int, *[ctypes.c_float] * 5, _vp],
}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin")


def is_stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(src.stat().st_mtime >= built for src in sources())


def build(force: bool = False) -> float:
    """Compile the library if stale (or ``force``); returns seconds spent."""
    if not force and not is_stale():
        return 0.0
    return compile_library(sources(), LIB_PATH)


def compile_library(srcs, lib_path: Path, extra_flags=(), verbose: bool = False) -> float:
    """One ``nvcc`` call: ``srcs`` into the shared library ``lib_path``;
    returns seconds spent. ``verbose`` prints what nvcc wrote to stderr
    (with ``extra_flags=["-Xptxas", "-v"]``: registers and shared memory
    of each kernel)."""
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    if verbose and proc.stderr:
        print(proc.stderr, flush=True)
    os.replace(tmp, lib_path)
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    build()
    return load(LIB_PATH)


def load(lib_path: Path) -> ctypes.CDLL:
    """A kernel library with the argument types of every launcher it has."""
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        if not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.semslam_error_string.argtypes = [ctypes.c_int]
    lib.semslam_error_string.restype = ctypes.c_char_p
    return lib


def check(status: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if status != 0:
        msg = library().semslam_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({status}: {msg})")
