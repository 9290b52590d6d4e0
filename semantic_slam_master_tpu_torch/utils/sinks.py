"""Pluggable metric sinks (a copy of the JAX package's
``utils/sinks.py``, which imports no JAX): the trainer emits metric dicts
and sinks consume them -- console table, JSONL file, wandb (optional
import; a no-op without it), or any combination.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional


class Sink:
    def log(self, metrics: Dict) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:
        pass


class ConsoleSink(Sink):
    """One formatted line per epoch and split."""

    KEY_ORDER = (
        "loss", "desc", "variance", "repeat", "peakiness", "activation",
        "edge", "sparsity", "num_matches", "mean_saliency",
        "saliency_variance", "descriptor_variance",
    )

    def __init__(self, stream=None):
        self.stream = stream or sys.stdout

    def log(self, metrics: Dict) -> None:
        split = metrics.get("split", "train")
        epoch = metrics.get("epoch", "?")
        parts = [f"[{split} epoch {epoch}]"]
        for k in self.KEY_ORDER:
            if k in metrics:
                parts.append(f"{k}={metrics[k]:.4f}")
        print(" ".join(parts), file=self.stream)


class JsonlSink(Sink):
    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")

    def log(self, metrics: Dict) -> None:
        record = {"ts": time.time(), **{k: _jsonable(v) for k, v in metrics.items()}}
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class WandbSink(Sink):
    """Optional wandb sink; a no-op when wandb cannot be imported or started."""

    def __init__(self, project: str, run_name: str, config: Optional[Dict] = None):
        try:
            import wandb

            self.run = wandb.init(project=project, name=run_name, config=config)
        except Exception as e:  # pragma: no cover - env dependent
            print(f"[sinks] wandb unavailable ({e}); disabling", file=sys.stderr)
            self.run = None

    def log(self, metrics: Dict) -> None:
        if self.run is not None:  # pragma: no cover - env dependent
            self.run.log({k: v for k, v in metrics.items() if isinstance(v, (int, float))})

    def close(self) -> None:
        if self.run is not None:  # pragma: no cover - env dependent
            self.run.finish()


class MultiSink(Sink):
    def __init__(self, sinks: Iterable[Sink]):
        self.sinks: List[Sink] = list(sinks)

    def log(self, metrics: Dict) -> None:
        for s in self.sinks:
            s.log(metrics)

    def close(self) -> None:
        for s in self.sinks:
            s.close()


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        try:
            return float(v)
        except Exception:
            return str(v)
