"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent, so a run never slides onto the CPU unnoticed."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU), so host-clock
    stage times cover the work they launched."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
