"""Live tracking, closed loop, one frame at a time: each frame's host
arrays are copied to the device and run through the batch-1 frontend
(``tracking.extract_features``), then ``system.bootstrap_map`` on a pass's
first frame or ``system.run_slam_steps`` on that one frame, and the pose
is brought to the host before the next frame is handed in. A frame's
latency runs from its hand-over to its pose on the host; ``track_ms_p95``
is the 95th percentile over every frame of the window, bootstrap frames
included, the pass in flight at its close finished and counted."""

from __future__ import annotations

import time

import numpy as np
import torch

from harness.result import WindowResult

WITH_SLAM = True


def one_pass(program, world, tracer, latencies: list):
    feats_all, poses = [], []
    with tracer.traced_pass():
        for i in range(len(world.gray)):
            t0 = time.perf_counter()
            with tracer.stage("frontend", 1):
                feats = program.live_features(world.gray[i : i + 1], world.depth[i : i + 1])
            with tracer.stage("slam", 1):
                if i == 0:
                    carry = program.live_start(feats)
                else:
                    carry = program.live_step(carry, world.uniforms[i], feats)
                pose = carry[1].cpu().numpy()
            latencies.append(time.perf_counter() - t0)
            feats_all.append(feats)
            poses.append(pose)
    feats = type(feats_all[0])(*[torch.cat(xs) for xs in zip(*feats_all)])
    return feats, np.stack(poses)


def warm(program, world, tracer):
    one_pass(program, world, tracer, [])


def window(program, world, seconds: float, tracer, rng) -> WindowResult:
    res = WindowResult()
    latencies = []
    t0 = time.perf_counter()
    while True:
        p0 = time.perf_counter()
        feats, poses = one_pass(program, world, tracer, latencies)
        res.add_pass(rng, len(world.gray), None, feats, poses, time.perf_counter() - p0)
        if time.perf_counter() - t0 >= seconds and tracer.done:
            break
    res.elapsed_s = time.perf_counter() - t0
    ms = np.asarray(latencies) * 1e3
    res.metrics["track_ms_p95"] = float(np.percentile(ms, 95))
    res.notes["track_ms_median"] = float(np.median(ms))
    res.notes["track_frames"] = len(ms)
    res.attempted = len(ms)
    return res
