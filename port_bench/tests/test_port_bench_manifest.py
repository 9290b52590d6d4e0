"""BENCHMARK.json against the benchmark's contract, and the harness's
imports: every name resolves to its file, names and units use the
allowed characters, each per-layer metric's cells report what it moves,
nothing imports JAX or the JAX package, and the reference imports
nothing of the port."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
PORT = "semantic_slam_master_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "semantic_slam_master_tpu"}


def _imports(path: Path) -> set:
    """Top-level names of every module a file imports (relative imports
    excluded), anywhere in the file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_top_level_and_entry_keys():
    assert set(MANIFEST) == TOP_KEYS
    for section, keys in KEYS.items():
        assert 1 <= len(MANIFEST[section])
        for entry in MANIFEST[section]:
            extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
            assert keys <= set(entry) <= keys | extra, entry["name"]
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and 1 <= len(paths) <= 16
    for p in paths:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths), word
            assert (ROOT / word).is_file()


def test_names_units_and_text_fields():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MANIFEST[section]]
        assert len(names) == len(set(names)), section
        for e in MANIFEST[section]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in {"configs": ("why", "source"), "workloads": ("why",), "per_layer": ("layer",)}.get(section, ()):
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in MANIFEST["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16


def test_every_name_resolves_to_its_file():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    used = set()
    for w in MANIFEST["workloads"]:
        cfg = configs[w["config"]]
        used.add(cfg["name"])
        assert cfg["file"].startswith("port_bench/") and (ROOT / cfg["file"]).is_file()
        traffic = BENCH / "traffic" / f"{w['traffic']}.json"
        assert traffic.is_file(), traffic
        drive = json.loads(traffic.read_text())["drive"]
        assert (BENCH / "drives" / f"{drive}.py").is_file(), drive
    assert used == set(configs)
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for m in MANIFEST["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_bounds_and_run_seconds():
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in MANIFEST["end_to_end"])


def _reported(cell: str) -> set:
    return {m["name"] for m in MANIFEST["end_to_end"] if cell in m.get("workloads", [cell])}


def test_per_layer_cells_report_what_they_move():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    layer_of = {}
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in MANIFEST["end_to_end"]} and m["moves"] != "setup_s"
        for cell in m.get("workloads", sorted(cells)):
            assert cell in cells
            assert m["moves"] in _reported(cell), (m["name"], cell)
        layer_of.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layer_of.values()), layer_of
    for cell in cells:
        assert "setup_s" in _reported(cell) and len(_reported(cell)) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in MANIFEST["per_layer"])


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN
    if "reference" in path.relative_to(BENCH).parts:
        assert PORT not in _imports(path)


def test_harness_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path[:0] = [%r, %r]; from harness import bench, check, counters, readers, "
            "reference_run, trace, world; import calibrate; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))" % (str(BENCH), str(ROOT), FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_exits_nonzero_and_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "orb.live", "--seed",
                          "2147483701", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert out.returncode != 0
    assert not any(line.lstrip().startswith("{") for line in out.stdout.splitlines())


def test_only_the_benchmark_and_its_paths_is_not_enough(tmp_path):
    """In a directory that holds only BENCHMARK.json and the files under
    ``paths`` the run exits non-zero and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "orb.live", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert not any(line.lstrip().startswith("{") for line in out.stdout.splitlines())
