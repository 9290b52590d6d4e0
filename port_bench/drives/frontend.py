"""The passes of ``drives/slam.py`` stopped after the frontend: the
segmenter's weight maps (when the configuration has one) and the chunked
frontend's features, with the device synchronised at the end of each
pass. ``frontend_fps`` is every frame of every pass over the window, the
pass in flight at its close finished and counted."""

from __future__ import annotations

import time

import torch

from harness.result import WindowResult

WITH_SLAM = False


def one_pass(program, world, tracer):
    n = len(world.rgb)
    wm = None
    with tracer.traced_pass():
        if program.segmenter is not None:
            with tracer.stage("segmenter", n):
                wm = program.weight_maps(world.rgb)
        with tracer.stage("frontend", n):
            feats = program.features(world.rgb, world.gray, world.depth, wm)
        if program.device.type == "cuda":
            torch.cuda.synchronize(program.device)
    return wm, feats


def warm(program, world, tracer):
    one_pass(program, world, tracer)


def window(program, world, seconds: float, tracer, rng) -> WindowResult:
    res = WindowResult()
    t0 = time.perf_counter()
    while True:
        p0 = time.perf_counter()
        wm, feats = one_pass(program, world, tracer)
        res.add_pass(rng, len(world.rgb), wm, feats, None, time.perf_counter() - p0)
        if time.perf_counter() - t0 >= seconds and tracer.done:
            break
    res.elapsed_s = time.perf_counter() - t0
    res.metrics["frontend_fps"] = res.frames / res.elapsed_s
    return res
