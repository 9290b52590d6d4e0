"""``BENCHMARK.json`` and the files it names, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``drives/<drive>.py`` (named by the traffic file) and
``metrics/<metric>.py``, and a learned configuration's reference model,
``reference/<model.reference>.py``. A later cell, configuration, traffic
mix or per-layer metric is a new entry and new files; nothing here
changes."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

from . import counters, weights

HERE = Path(__file__).resolve().parents[1]


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} (named by {name!r}) is missing")
    spec = importlib.util.spec_from_file_location(f"port_bench_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        entry = next(c for c in self.data["configs"] if c["name"] == cell["config"])
        config = json.loads((self.root / entry["file"]).read_text())
        check_config(config, entry["file"])
        return config

    def traffic(self, cell: dict) -> dict:
        return json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())

    @staticmethod
    def drive(traffic: dict):
        return _module(HERE / "drives" / f"{traffic['drive']}.py", traffic["drive"])

    @staticmethod
    def reader(metric: str):
        return _module(HERE / "metrics" / f"{metric}.py", metric)

    def end_to_end(self, cell: dict) -> list:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.data["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]

    def per_layer(self, cell: dict) -> list:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list whose ``moves`` metric the cell reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if cell["name"] in m.get("workloads", [cell["name"]] if m["moves"] in reported else [])]


def check_config(config: dict, file: str) -> None:
    """Raise, naming ``file``, where a configuration's models name no
    weights or both (``harness/weights.py``), an unknown reference
    module, or an unknown feed-forward block: before anything is built."""
    errors = []
    if config["frontend"] == "learned":
        m = config["model"]
        errors.append(weights.spec_error(m, "model"))
        name = m.get("reference", "frontend")
        if not (isinstance(name, str) and re.fullmatch(r"[A-Za-z0-9_]+", name)
                and (HERE / "reference" / f"{name}.py").is_file()):
            errors.append(f"model.reference {name!r} names no module reference/<name>.py")
        ffn = m.get("ffn", "gelu_mlp")
        if not (isinstance(ffn, str) and ffn in counters.FFN_PRODUCTS):
            errors.append(f"model.ffn {ffn!r} is not one of {sorted(counters.FFN_PRODUCTS)}")
    if config.get("semantics") == "model":
        errors.append(weights.spec_error(config["segmenter"], "segmenter"))
    errors = [e for e in errors if e]
    if errors:
        raise ValueError(f"{file}: " + "; ".join(errors))
