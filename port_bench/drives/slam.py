"""Whole SLAM passes back to back, closed loop: each pass runs the stages
``run-slam`` runs, without render, load or file writes: the segmenter's
weight maps (when the configuration has one), the chunked frontend, then
``system.run_slam`` with the poses brought to the host. The pass in
flight when the window closes is finished and counted; ``slam_fps`` is
every frame of every pass over the time from the window's start to the
end of the last pass."""

from __future__ import annotations

import time

from harness.result import WindowResult

WITH_SLAM = True


def one_pass(program, world, tracer):
    n = len(world.rgb)
    wm = None
    with tracer.traced_pass():
        if program.segmenter is not None:
            with tracer.stage("segmenter", n):
                wm = program.weight_maps(world.rgb)
        with tracer.stage("frontend", n):
            feats = program.features(world.rgb, world.gray, world.depth, wm)
        with tracer.stage("slam", n):
            poses = program.slam(world.uniforms, feats)
    return wm, feats, poses


def warm(program, world, tracer):
    one_pass(program, world, tracer)


def window(program, world, seconds: float, tracer, rng) -> WindowResult:
    res = WindowResult()
    t0 = time.perf_counter()
    while True:
        p0 = time.perf_counter()
        wm, feats, poses = one_pass(program, world, tracer)
        res.add_pass(rng, len(world.rgb), wm, feats, poses, time.perf_counter() - p0)
        if time.perf_counter() - t0 >= seconds and tracer.done:
            break
    res.elapsed_s = time.perf_counter() - t0
    res.metrics["slam_fps"] = res.frames / res.elapsed_s
    return res
