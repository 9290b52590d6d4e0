"""What the per-layer metric readers (``metrics/<name>.py``) share.

A reader is ``read(ctx) -> float | None``: None when the traced pass
holds nothing for it to read, and the harness then leaves the metric out
of the line. ``ctx`` is a ``Context``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reference import fast as ref_fast
from reference import tracking as ref_tracking

from . import counters


class Context(NamedTuple):
    config: dict
    traffic: dict
    world: object  # harness.world.World
    trace: object  # harness.trace.TraceSummary of the traced pass
    device: torch.device


def stage_ms(ctx: Context, stage: str):
    """Device ms per frame inside the benchmark's span around ``stage``."""
    frames = ctx.trace.stage_frames.get(stage, 0)
    return ctx.trace.stage_ms[stage] / frames if frames else None


def kernel(ctx: Context, symbol: str):
    """(seconds, launches) of the device ops whose name holds ``symbol``."""
    names = [n for n in ctx.trace.kernel_s if symbol in n]
    return sum(ctx.trace.kernel_s[n] for n in names), sum(ctx.trace.kernel_n[n] for n in names)


def frontend_frames(ctx: Context) -> list:
    """Indices of the frames the frontend's calls handled in one pass,
    chunk by chunk: a chunked drive pads the last chunk by repeating the
    last frame, as the CLI does; the live drive hands in single frames."""
    n = ctx.traffic["frames"]
    chunk = 1 if ctx.traffic["drive"] == "live" else ctx.config["chunk"]
    idx = list(range(n)) + [n - 1] * ((-n) % chunk)
    return [idx[i : i + chunk] for i in range(0, len(idx), chunk)]


def roofline(ctx: Context, symbol: str, calls_per_chunk: int, bound_s: float):
    """Least time over measured time of the kernel ``symbol``, in %, when
    the trace holds exactly the launches that one pass makes."""
    seconds, launches = kernel(ctx, symbol)
    if launches != calls_per_chunk * len(frontend_frames(ctx)) or seconds <= 0:
        return None
    return 100.0 * bound_s / seconds


def orb_levels(ctx: Context, frames: list):
    """The ORB pyramid of the given frames and each level's keypoints, by
    the reference (the port's levels and detections are equal to them)."""
    o = ctx.config["orb"]
    gray = torch.from_numpy(ctx.world.gray[frames]).to(ctx.device)
    levels = ref_tracking.build_pyramid(gray, o["num_levels"], o["scale_factor"])
    quotas = ref_tracking.level_quotas([lv.shape[1:] for lv in levels], o["num_keypoints"])
    return levels, quotas


def fast_score_bound_s(ctx: Context) -> float:
    o = ctx.config["orb"]
    total = 0.0
    for frames in frontend_frames(ctx):
        levels, _ = orb_levels(ctx, frames)
        for lv in levels:
            n_pass = int(ref_fast.fast_candidates_plain(lv, o["fast_threshold"]).sum())
            total += counters.fast_score_bound_s(lv.numel(), n_pass)
    return total


def aligned_patches_bound_s(ctx: Context) -> float:
    o = ctx.config["orb"]
    total = 0.0
    for frames in frontend_frames(ctx):
        levels, quotas = orb_levels(ctx, frames)
        for lv, q in zip(levels, quotas):
            kp = ref_fast.detect(lv, int(q), o["fast_threshold"], o["nms_radius"], subpixel=o["subpixel"])
            total += counters.aligned_patches_bound_s(lv, kp.xy)
    return total


def gather_patches_bound_s(ctx: Context) -> float:
    s = ctx.config["model"]["sizes"]
    frames = sum(len(c) for c in frontend_frames(ctx))
    return counters.gather_patches_bound_s(frames, s["num_keypoints"], s["patch_size"] // 2 + 2, s["patch_size"])


def idle_share(ctx: Context):
    """1 - the device's busy time in the profiled pass over the host-clock
    time of the same pass's work without the profiler (the span pass)."""
    t = ctx.trace
    return 1.0 - t.busy_s / t.span_window_s if t.span_window_s > 0 else None


def launches_per_frame(ctx: Context, stage: str):
    frames = ctx.trace.stage_frames.get(stage, 0)
    return ctx.trace.stage_kernels.get(stage, 0) / frames if frames else None


def mfu(ctx: Context):
    """Model FLOPs of the frames one pass delivers over the span pass's
    host-clock time, against the bf16 dense peak, in %."""
    flops = counters.model_flops_per_frame(ctx.config) * ctx.traffic["frames"]
    if not flops or ctx.trace.span_window_s <= 0:
        return None
    return 100.0 * flops / ctx.trace.span_window_s / counters.BF16_FLOPS_PER_S
