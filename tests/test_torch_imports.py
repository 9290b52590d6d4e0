"""Import hygiene of the port: neither semantic_slam_master_tpu_torch nor
chip_smoke.py imports JAX or the JAX package, by their source and at run
time."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import semantic_slam_master_tpu_torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "semantic_slam_master_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


PORT_FILES = sorted((REPO / "semantic_slam_master_tpu_torch").rglob("*.py"))


@pytest.mark.parametrize("path", PORT_FILES + [REPO / "chip_smoke.py", REPO / "profile_port.py", REPO / "profile_kernels.py",
                                  REPO / "profile_determinism.py"], ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    bad = [n for n in _imported_roots(path) if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def test_port_modules_load_without_jax():
    names = [m.name for m in pkgutil.walk_packages(semantic_slam_master_tpu_torch.__path__, "semantic_slam_master_tpu_torch.")]
    assert len(names) > 20
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "import runpy; runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
