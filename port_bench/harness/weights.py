"""Weights drawn from a seed, for a configuration whose ``model`` or
``segmenter`` gives ``"weights": {"seed": <int>, "overrides": [...]}`` in
place of a committed ``"checkpoint"``.

The draw follows a model's own ``state_dict()`` keys and shapes; it
imports nothing of the port. Each key has its own ``torch.Generator`` on
the run's device, seeded with the key's crc32 started from the seed, so a
key's values depend on nothing but (seed, key, shape, device), whatever
the order of the keys. The port and the reference each draw from their own
model's keys (asserted equal) and get the same tensors.

The default rule, by key:

- ``running_mean``: 0.02 N; ``running_var``: 1 + 0.1 |N|;
- ``*bias``, and the tokens and position tables (a last name part with
  ``token`` in it, or ``pos_embed``): 0.02 N;
- other 1-D tensors (norm scales): 1 + 0.02 N;
- tensors of two dimensions or more: N(0, 1/fan_in) clipped at 2 sigma,
  fan_in = prod(shape[1:]) in PyTorch's (out, in, ...) layout, or
  prod(shape[:-1]) for a ``*kernel``, which keeps flax's (..., in, out)
  layout (``selector.conv1_kernel``: 3 x 3 x in).

``overrides`` are ``[regex, "const" | "std", value]``: the first whose
regex is found in a key (``re.search``) sets that key to the constant
``value``, or to ``value`` times N clipped at 2 sigma. An override that
matches no key is an error.

``drawn`` builds a model on the ``meta`` device and assigns the drawn
tensors to it (``load_state_dict(strict=True, assign=True)``), so its
weights exist once, on the run's device, and never on the host.
"""

from __future__ import annotations

import math
import re
import zlib

import torch

KINDS = ("const", "std")
_TABLE = re.compile(r"token|^pos_embed$")


def spec_error(spec: dict, what: str) -> str | None:
    """Why a configuration's ``model`` or ``segmenter`` entry (``what``)
    names no weights, or None: exactly one of ``checkpoint`` and
    ``weights``, and a seed and well-formed overrides in ``weights``."""
    if ("checkpoint" in spec) == ("weights" in spec):
        return f"{what} gives {'both' if 'checkpoint' in spec else 'neither'} of 'checkpoint' and 'weights'"
    if "checkpoint" in spec:
        return None
    w = spec["weights"]
    if not isinstance(w, dict) or not set(w) <= {"seed", "overrides"}:
        return f"{what}.weights must be an object with 'seed' and optional 'overrides'"
    if not isinstance(w.get("seed"), int) or not 0 <= w["seed"] < 2**32:
        return f"{what}.weights.seed must be a whole number in [0, 2**32)"
    for o in w.get("overrides", []):
        if not (isinstance(o, list) and len(o) == 3 and isinstance(o[0], str) and o[1] in KINDS
                and isinstance(o[2], (int, float))):
            return f"{what}.weights.overrides: {o!r} is not [regex, 'const' | 'std', number]"
        try:
            re.compile(o[0])
        except re.error as e:
            return f"{what}.weights.overrides: bad regex {o[0]!r}: {e}"
    return None


def shapes(model: torch.nn.Module) -> dict:
    """{key: (shape, dtype)} of a model's state dict."""
    return {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()}


def same_shapes(port: dict, ref: dict, what: str) -> None:
    """Raise unless the port's and the reference's ``shapes`` are equal."""
    if port != ref:
        diff = sorted(k for k in port.keys() | ref.keys() if port.get(k) != ref.get(k))
        raise ValueError(f"{what}: the port's and the reference's state dicts differ at {diff[:8]}")


def _seed(seed: int, key: str) -> int:
    """The key's crc32 started from ``seed``: 32 bits, since the host's
    generator keeps only the low 32 bits of a seed (CUDA's keeps 64)."""
    return zlib.crc32(key.encode(), seed)


def _one(key: str, shape: tuple, dtype, gen: torch.Generator, rule) -> torch.Tensor:
    dev = gen.device

    def normal():
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    if rule is not None:
        kind, value = rule
        x = torch.full(shape, float(value), device=dev) if kind == "const" else normal().clamp_(-2, 2) * value
    else:
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "running_var":
            x = 1 + 0.1 * normal().abs()
        elif leaf == "running_mean" or leaf.endswith("bias") or _TABLE.search(leaf):
            x = 0.02 * normal()
        elif len(shape) == 1:
            x = 1 + 0.02 * normal()
        else:
            fan_in = math.prod(shape[:-1] if leaf.endswith("kernel") else shape[1:])
            x = normal().clamp_(-2, 2) / math.sqrt(fan_in)
    return x.to(dtype)


def draw(shapes_: dict, seed: int, overrides=(), device="cpu") -> dict:
    """A state dict for ``shapes_`` ({key: (shape, dtype)}) from ``seed``,
    on ``device``."""
    rules = [(re.compile(regex), kind, value) for regex, kind, value in overrides]
    used, out = set(), {}
    for key, (shape, dtype) in shapes_.items():
        hit = next((i for i, (rx, _, _) in enumerate(rules) if rx.search(key)), None)
        used.add(hit)
        gen = torch.Generator(device=device).manual_seed(_seed(seed, key))
        out[key] = _one(key, shape, dtype, gen, None if hit is None else rules[hit][1:])
    unused = [rules[i][0].pattern for i in range(len(rules)) if i not in used]
    if unused:
        raise ValueError(f"weight overrides match no key: {unused}")
    return out


def drawn(make, spec: dict, device: torch.device) -> torch.nn.Module:
    """The model that ``make()`` builds, in eval mode on ``device``, with
    the weights drawn from ``spec["weights"]``."""
    with torch.device("meta"):
        model = make()
    w = spec["weights"]
    model.load_state_dict(draw(shapes(model), w["seed"], w.get("overrides", []), device), strict=True, assign=True)
    left = [n for n, t in [*model.named_parameters(), *model.named_buffers()] if t.is_meta]
    if left:
        raise ValueError(f"tensors outside the state dict stay unset on the meta device: {left[:8]}")
    return model.eval()
