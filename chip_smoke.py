#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its name and elapsed seconds (stdout flushed, the
device synchronised at the end of each):

1. device  -- CUDA present; the card's name and power limit (nvidia-smi).
2. build   -- one nvcc call builds semantic_slam_master_tpu_torch/csrc/*.cu.
3. ORB path inputs -- 16 rendered 640x480 frames, their four pyramid
   levels, the levels blurred and the path's detections on them, as
   ``extract_features`` makes them.
4. fast_score / 5. gather_aligned_patches / 6. gather_patches -- each
   kernel bit-exact against its plain PyTorch version: the ORB kernels on
   random frames at the path's shapes and ragged ones (keypoints on every
   clamp edge) and on the path's own inputs, where every pixel failing
   the 4-point test must score 0; gather_patches in both modes (the
   learned path's 8x500 windows of radius 10, the train steps' 8x500 at
   448 px and 8x192 at 224 px, the padded 32x32 mode at
   N=8192, ragged cases with B N % 4 != 0, N = 1, centres on every clamp
   edge and non-finite or huge centres). Each is
   timed with CUDA events (median of 20 launches after warm-up, L2
   flushed between launches, host enqueue time hidden behind a device
   spin) beside its bound, the plain version's time and, for the gathers,
   one ``torch.gather`` over the precomputed flat index (the gather
   alone). A bound is the larger of bytes over 3.35 TB/s and operations
   over the f32 issue rate (33.45 T/s: compares and adds issue at half the
   FMA-counted 67 TFLOP/s). fast_score's operations are the 4-point test
   on every pixel and the 16-point chain on the pixels that pass it (the
   share is printed; the old bound, the chain on every pixel at 67
   TFLOP/s, is printed beside it). A gather's bytes are the distinct
   source pixels its windows cover, read once, plus its output.
7. ORB frontend -- extract_features on two 640x480 frames on the card
   against the same call on the CPU (the plain versions of both
   kernels), and on two frames of the dynamic world with the GT
   class-weight map, which must change the detections and down-weight
   some keypoints on the card as on the CPU.
8. ORB main path -- ``run-slam --synthetic`` at 640x480 with the defaults
   (512 keypoints, 2048 landmarks, window 5, 4 BA iterations, 16-frame
   frontend chunks), then ``evaluate``; ATE finite and below 0.05 m, both
   ORB kernels launched 4x per frontend chunk, pnp_refine and ransac once
   per tracked frame (59), their inputs recorded for phases 33 and 34.
9. learned frontend + segmenter -- the ViT-S/16 frontend of
   configs/train_vits_synthetic_long.yaml (its offset head's last conv
   given seeded non-zero weights, so sub-patch offsets are not all 0) and
   the segmenter, seeded alike, on two 640x480 frames on the card against
   the CPU: saliency max abs difference <= 0.02; >= 90% of the
   patch-centre keypoints selected by both; the sub-patch refinement on
   the CPU's inputs: mean |offset| >= 0.5 px and >= 99% of offsets
   within 1e-3 px of the CPU's; >= 90% of the refined keypoints within
   0.5 px of a CPU one (bf16 vs f32 of the same model on the CPU is
   printed beside it as the yardstick); descriptor cosine >= 0.99 on
   average and >= 0.9 at worst over keypoint pairs within 0.05 px; >=
   99% of the segmenter's 1/4-resolution labels agree (bf16 rounds at
   other places on the card; a near-tie in saliency rank can move a
   keypoint).
10. learned path -- ``run-slam --synthetic --frontend learned
   --train-config configs/train_vits_synthetic.yaml --checkpoint
   weights/frontend_vits.npz --semantics model --segmenter-checkpoint
   weights/segmenter.npz`` (the trained ViT-S/16 at full width with
   sub-patch refinement and the trained segmenter, 8-frame chunks), 60
   frames, then ``evaluate``: finite poses, ATE below VITS_ATE_BOUND_M,
   gather_patches launched at least once per chunk, pnp_refine and ransac
   once per tracked frame (59), their inputs recorded for phases 33 and 34;
   fps and the time
   split (segmenter, backbone, heads, SLAM loop) of the trained pair
   printed.
11. dynamic path -- ``run-slam --synthetic --dynamic --seed 1`` (ORB
   frontend, so the weight map and score weight run through both ORB
   kernels), 60 frames, with ``--semantics gt`` (ATE below
   DYNAMIC_ATE_BOUND_M) and ``off`` (ATE above DYNAMIC_OFF_ATE_FLOOR_M:
   without the weights this seed tracks the walking person, as in the
   paired CPU runs of both packages).

12. trained weights -- weights/frontend_tiny.npz, weights/segmenter.npz
   and weights/frontend_vits.npz (export_weights.py) are read before the
   build; their sizes are printed, and the ViT-S/16 file's form: every
   array float32 as restored (no leaf stored rounded). A missing or
   unreadable file fails the run.
13. trained tiny learned path -- ``run-slam --synthetic --frontend learned
   --train-config configs/train_tiny_synthetic.yaml --checkpoint
   weights/frontend_tiny.npz``, 60 frames, then ``evaluate``: ATE below
   TINY_ATE_BOUND_M, gather_patches launched at least once per chunk.
14. trained segmenter -- ``run-slam --synthetic --dynamic --seed 1
   --semantics model --segmenter-checkpoint weights/segmenter.npz``, 60
   frames: ATE below SEG_MODEL_ATE_BOUND_M; the card's 1/4-resolution
   labels of those frames against the GT labels: person recall at least
   SEG_PERSON_RECALL_MIN (label accuracy printed).
15. loop path -- accuracy.py's loop protocol (LOOP_* constants):
   ``run_slam_online`` with and without closure on the same features of
   the 320-frame harsh loop; at least one loop closed, the closure ATE
   below LOOP_ATE_BOUND_M; per-chunk ``slam_s`` and ``closure_s`` and the
   ratio of the last third of the chunk times to the first third printed.
16. closing pass card vs cpu -- ``close_sequence_loops`` over that run's
   odometry on the CPU and on the card, on identical features: the same
   loops, corrected poses within 1e-3 m and 1e-3 rad.
17. CLI loop closing -- ``run-slam --synthetic --loop-closure offline``
   and ``online`` (60 frames), then ``evaluate``: ATE below
   CLI_LOOP_ATE_BOUND_M.
18. TUM input -- the 60-frame 640x480 world written as the TUM directory
   ``rgbd_dataset_freiburg2_synthetic`` (8-bit RGB PNGs, 16-bit depth
   x5000, groundtruth.txt, rgb.txt, depth.txt, associations.txt), its PNG
   rows filtered with None, Sub and Up only (the filters data/png.py
   decodes vectorised); whether png.h, libpng and PIL are on the machine
   and which decoder runs; all 60 frames decoded by the native loader
   (built from native/semslam_io.cpp) and by the plain decoder, bit-equal,
   with both host decode rates; then ``frame_chunks(chunk=16)`` streamed
   to the card: every chunk equal to the host arrays, every array copied
   from a pinned buffer.
19. TUM main path -- ``run-slam --data-root <dir> --sequences
   rgbd_dataset_freiburg2_synthetic`` (the ORB path, the run-slam
   defaults), then ``evaluate --data-root``: ATE below TUM_ATE_BOUND_M,
   both ORB kernels launched exactly 4x per 16-frame chunk.
20. acceptance suite -- ``run-tests --frontend orb-pyramid`` on that
   directory at ``--difficulty normal``, and ``run-tests --frontend
   learned --synthetic`` with the trained tiny frontend (``--config
   configs/train_tiny_synthetic.yaml --checkpoint
   weights/frontend_tiny.npz``) and the trained ViT-S/16 (``--config
   configs/train_vits_synthetic.yaml --checkpoint
   weights/frontend_vits.npz``): repeatability, inlier ratio, precision
   and tracking success within SUITE_MARGIN of the JAX package's CPU
   figures (SUITE_*_JAX; the ViT-S checkpoint's own TPU figures are
   printed beside them as context); the ORB kernels launched on the
   first, gather_patches on the learned ones; the performance test's
   stage times and fps printed beside the card's name and power limit.
21. resumed training -- ``train --resume weights/frontend_tiny_state.npz
   --epochs 67`` (the trained tiny frontend's epoch-65 state, exported
   from its orbax checkpoint) on a YAML derived from
   configs/train_tiny_synthetic.yaml (17 frames of one world: 2 steps an
   epoch), epochs 66-67: every per-epoch figure in the JSONL within
   RESUME_GAP_BOUND of the JAX CLI's CPU run of the same YAML
   (RESUME_JAX), no step skipped, gather_patches launched twice a step.
22. a checkpoint written and read -- ``train --init-from
   weights/frontend_tiny.npz`` for 1 epoch with validation writes
   best_model.npz; ``run-slam --frontend learned --checkpoint`` it, then
   ``evaluate``: ATE below TINY_ATE_BOUND_M.
23. ViT-S/16 at full width -- configs/train_vits_synthetic_long.yaml
   (448 px, 500 keypoints, 12 layers x 384, backbone trained, hard and
   cross-image negatives, 8 pairs a batch) with its data cut to
   VITS_FRAMES frames of one world (1 step an epoch), VITS_EPOCHS epochs
   from seeded weights (their sum |w| checked first): no step skipped,
   every figure finite (``hard`` included), gather_patches twice a step,
   each step's time (CUDA events) and the peak
   ``torch.cuda.max_memory_allocated``; the first step's forward on two
   of its pairs, card against the host's CPU from the same weights.
24. segmenter training -- ``train-segmenter`` (300 steps, 120x160, width
   32, seed 0): final loss and accuracy within a band of the JAX CLI's
   CPU figures over seeds 0-3; then ``run-slam --dynamic --seed 1
   --semantics model --segmenter-checkpoint`` it: ATE below twice the
   worst of the JAX package's own 300-step segmenters.
25. ORB windows at radius 15 -- ``orb.orientations`` and
   ``orb.describe_from_patches`` on the ORB path's blurred level-0 frames
   and detections, through gather_patches at radius 15 (31x31 windows; the
   kernel is also held against its plain version at that shape among the
   gather_patches cases): orientations of the u8-quantised frame (exact
   integer moments, as every ORB path takes them) within 1e-6 rad and
   descriptors equal to the CPU's.
26. describe on small pyramid levels -- ``extract_features`` on (4, 48,
   64) frames, whose levels reach the 24x32 floor, card against CPU (the
   frontend phase's bounds), and ``orb.describe`` at (24, 32), (32, 32),
   (24, 64), (32, 64), (48, 80), (120, 100) on identical inputs, card
   against CPU: at least 99.9% of descriptors identical; the aligned
   kernel launched exactly on the sizes that take it.
27. bench -- ``bench --frontend orb`` (640x480, batch 8, 1000 keypoints)
   and ``--frontend learned`` (seeded ViT-S/16 at 448x448, batch 8): the
   JSON's stage times and fps beside the card's name and power limit.
28. visualize -- the device half of each mode on the card against the
   CPU (``saliency_map`` in ORB mode and with a seeded ViT-S/16 ``.npz``
   written by ``convert.save_npz``; ``orb_extract_and_match`` on a frame
   pair and on the sequence's spacings), then ``visualize saliency``
   (both modes), ``matches`` and ``sequence`` through the CLI where
   ``matplotlib`` is installed (where it is not, the script says so and
   draws nothing).
29. check-setup -- ``check-setup`` exits 0 on the card.
30. fleet SLAM -- the TUM phase's 60 decoded frames of the ORB path's
   world, their features from ``extract_features`` on the card (both ORB
   kernels 4x per 16-frame chunk), cut into FLEET_SEQUENCES disjoint
   15-frame sequences, then ``slam.parallel.run_slam_fleet`` with the
   default ``SlamConfig`` (2048 landmark slots) and one JAX key per
   sequence: each sequence's poses equal its own ``run_slam`` on the card
   within the gap between two card runs of it; the CPU's fleet on the
   same features against the card's (FLEET_POSE_TOL).
31. training over a mesh -- phase 23's recipe (ViT-S/16, 448 px, 8 pairs,
   sub-patch refinement, seeded), one step from the seeded weights at
   float32 and at bfloat16: without a mesh; through the mesh code on a
   1x1 mesh under NCCL; and on two gloo ranks spawned on the one card
   (CUDA tensors) at 2x1 and 1x2. 1x1 against the step without a mesh,
   2x1 and 1x2 against 1x1 (figures, Adam's moments, parameters,
   BatchNorm statistics; bounds at the constants); every rank's
   first-step seconds, peak memory and gather_patches launches (2 a
   step) printed.
32. stage-2 warm start -- ``train --init-from weights/frontend_vits.npz``
   (the trained ViT-S/16) on the YAML phase 23 derives from
   configs/train_vits_synthetic_long.yaml, one step: every figure finite
   (``hard`` included), no step skipped, gather_patches twice in the
   step; then the first step's forward on VITS_CPU_PAIRS of its pairs
   from the loaded weights, bf16, within RESUME_GAP_BOUND of the JAX
   package's forward on the same pairs and weights (VITS_WARM_JAX);
   step time and peak memory printed.

33. pnp_refine vs plain -- after phase 10, on every tracked frame's
   inputs recorded in phases 8 (ORB, N=512) and 10 (learned, N=500): the
   kernel's pose, count, mask and rmse equal to its plain version's bits;
   printed beside them, per path, the frames that kept T_best, the ties
   (the refined inlier set is the best's) and how many of those have two
   support sums that differ in bits, and the frames whose best row of the
   batched inlier masks differs from its own recount. Then the kernel
   timed on the ORB path's middle frame (median_ms, as above) beside the
   plain version on the host clock, synchronised, and the bound (bytes
   over 3.35 TB/s; the kernel is latency-bound).

34. ransac vs plain -- after phase 33, on every tracked frame's inputs
   recorded in phases 8 (ORB, N=512) and 10 (learned, N=500): every
   output of the kernel (the fits, supports, counts, best, its mask and
   weights) equal to its plain version's bits; printed beside them, per
   path, the frames whose largest support ties. Then the kernel alone (the
   draw's cumsum taken before) timed on each path's middle frame
   (median_ms, as above), the whole span beside it, the plain version on
   the host clock, synchronised, and the bound (the operations at the f32
   issue rate; the kernel is latency-bound).

Every path that runs a kernel resets the launch counters just before it
and reads them just after; the kernels line sums them (``launches``)
beside each path's count (``launches_by_path``). The whole script aims
to finish within TARGET_TOTAL_S by its own clock.

Then one JSON line describing every kernel, and as the last line
``{"ok": true, "device": {...}}``. Every failure raises, so the exit code
is non-zero and the last line is not printed.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes.util
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

SEED = 0
MAIN_FRAMES = 60  # the run-slam default; not cut
TIMED_ITERS = 20
WARMUP_ITERS = 3
PLAIN_ITERS = 5
PLAIN_FRAMES = 20  # pnp_refine's plain version timed on a path's first frames
SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's clock: covers the host's enqueue
# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, and the
# non-tensor-core float32 rate, which counts an FMA as two operations.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Compares, subtracts, max, adds and rounds issue one per lane per cycle:
# 132 SMs x 128 lanes x 1.98 GHz, half the FMA-counted rate. The bounds
# price the kernels' operations at this rate.
F32_OPS_PER_S = 132 * 128 * 1.98e9
FAST_THRESHOLD = 0.05  # the ORB path's (slam/tracking.py::extract_features)
# FAST-9 float32 work per pixel that runs the 16-point chain: 16 circle
# points x (difference, two compares, bright: subtract + max + add, dark:
# negate + subtract + max + add) plus the final select-add-select.
FAST_F32_OPS_PER_PIXEL = 16 * 10 + 3
# The 4-point early test every pixel runs: 4 differences, 8 compares.
FAST_EARLY_OPS_PER_PIXEL = 4 + 8
# Patch gather: quantise (max, min, multiply, round) per gathered pixel.
PATCH_F32_OPS_PER_PIXEL = 4

# run-slam --synthetic --dynamic, 60 frames at 640x480, paired CPU runs of
# both packages (the port draws JAX's RANSAC uniforms for the same seed):
# with --semantics gt the JAX package gives 0.0155, 0.0172, 0.0258, 0.0174
# m over seeds 0-3 and the port 0.0151, 0.0172, 0.0258, 0.0174 m; the gt
# bound is twice the worst. With --semantics off, seed 1 tracks the walking
# person: 1.0573 m (JAX) and 1.0574 m (port). The card runs seed 1 both
# ways: gt below DYNAMIC_ATE_BOUND_M, off above DYNAMIC_OFF_ATE_FLOOR_M
# (half the paired runs' failure, ten times the gt bound), which shows the
# weighting at work.
DYNAMIC_ATE_BOUND_M = 0.05
DYNAMIC_OFF_ATE_FLOOR_M = 0.5
DYNAMIC_SEED = 1
LEARNED_CONFIG = "configs/train_vits_synthetic_long.yaml"

# Trained weights, exported from the committed orbax checkpoints by
# export_weights.py. Each bound comes from the JAX package's CPU runs of
# the same command (PERF.md section 2): 60 frames at 640x480, seeds 0-3.
TINY_CONFIG = "configs/train_tiny_synthetic.yaml"
TINY_WEIGHTS = "weights/frontend_tiny.npz"
SEGMENTER_WEIGHTS = "weights/segmenter.npz"
# run-slam --synthetic --frontend learned (the trained tiny frontend): JAX
# 0.018752, 0.020083, 0.024481, 0.014596 m; the bound is twice the worst.
TINY_ATE_BOUND_M = 2 * 0.024481
# run-slam --synthetic --dynamic --semantics model (the trained segmenter):
# JAX 0.022010, 0.022231, 0.019590, 0.023760 m; twice the worst. Seed 1 is
# the one where --semantics off tracks the walking person (above).
SEG_MODEL_ATE_BOUND_M = 2 * 0.023760
# The trained segmenter's 1/4-resolution labels on those 60 dynamic frames
# against the rendered GT labels (accuracy.py's dynamic_sem_model row, JAX
# on the CPU): person recall 0.979746, label accuracy 0.919885.
SEG_PERSON_RECALL_JAX = 0.979746
SEG_LABEL_ACCURACY_JAX = 0.919885
SEG_PERSON_RECALL_MIN = SEG_PERSON_RECALL_JAX - 0.02
# Loop closing, accuracy.py's loop protocol: the 320-frame harsh loop at
# 640x480, 1000 ORB keypoints, the default SlamConfig, 32-frame chunks,
# min_score 0.30, min_frame_gap 60, min_inliers 25, RANSAC seed 0. The JAX
# package on the CPU: 0.018156 m with closure (5 loops), 0.018296 m
# without; the bound is twice the closure ATE.
LOOP_FRAMES = 320
LOOP_KEYPOINTS = 1000
LOOP_CHUNK = 32
LOOP_KW = dict(min_score=0.30, min_frame_gap=60, min_inliers=25)
LOOP_ATE_BOUND_M = 2 * 0.018156
# run-slam --synthetic --loop-closure offline / online (60 frames, seed 0):
# JAX on the CPU 0.009174 m (7 loops) / 0.009028 m (5 loops); the bound is
# the larger of the ORB path's 0.05 m and twice the worse.
CLI_LOOP_ATE_BOUND_M = max(0.05, 2 * 0.009174)
# The TUM phases: the 60-frame 640x480 world written as a TUM directory
# whose name gives the fr2 camera (the synthetic world's). Its rows are
# filtered with None, Sub and Up only: data/png.py decodes those
# vectorised, while Average and Paeth rows (which libpng's and PIL's
# adaptive filtering also choose) go along anti-diagonals, several times
# slower per frame.
TUM_NAME = "rgbd_dataset_freiburg2_synthetic"
TUM_FILTERS = ("none", "sub", "up")
TUM_CHUNK = 16
# run-slam --data-root on that directory (the ORB path, the run-slam
# defaults), then evaluate --data-root: the JAX package on the CPU gives
# 0.006630, 0.005861, 0.007477, 0.009830 m over seeds 0-3; the bound is
# twice the worst.
TUM_ATE_BOUND_M = 2 * 0.009830
# run-tests on the same inputs, the JAX package on the CPU: --frontend
# orb-pyramid --difficulty normal on the TUM directory, and --frontend
# learned with the trained tiny frontend (its orbax checkpoint) --synthetic
# (40 frames at scale 0.5). Each figure on the card must lie within
# SUITE_MARGIN of JAX's.
SUITE_MARGIN = 0.02
SUITE_TUM_JAX = {"repeatability_1": 0.915320, "repeatability_5": 0.854339, "inlier_ratio": 0.932385,
                 "precision": 0.692627, "tracking_1": 1.0, "tracking_5": 1.0}
SUITE_LEARNED_JAX = {"repeatability_1": 0.732786, "repeatability_5": 0.788204, "inlier_ratio": 0.793379,
                     "precision": 0.790295, "tracking_1": 1.0, "tracking_5": 1.0}
# The trained ViT-S/16: artifacts/frontend_vits (epoch 40 of
# configs/train_vits_synthetic.yaml, params only), exported whole as
# float32 by export_weights.py (193 arrays, 94,615,436 bytes).
VITS_CONFIG = "configs/train_vits_synthetic.yaml"
VITS_WEIGHTS = "weights/frontend_vits.npz"
VITS_ARRAYS = 193
# run-slam --synthetic --frontend learned --train-config VITS_CONFIG
# --checkpoint artifacts/frontend_vits/best_model --semantics model
# --segmenter-checkpoint artifacts/segmenter/best_model (the JAX package's
# CLI on the CPU, its orbax checkpoints): VITS_ATE_JAX_M over seeds 0-3;
# the bound is twice the worst.
VITS_ATE_JAX_M = (0.011430, 0.010403, 0.010502, 0.010712)
VITS_ATE_BOUND_M = 2 * max(VITS_ATE_JAX_M)
# run-tests --frontend learned --config VITS_CONFIG --checkpoint
# artifacts/frontend_vits/best_model --synthetic --difficulty normal, the
# JAX package on the CPU; the card is held to it within SUITE_MARGIN.
SUITE_VITS_JAX = {"repeatability_1": 0.720721, "repeatability_5": 0.802054, "inlier_ratio": 0.783742,
                  "precision": 0.768918, "tracking_1": 1.0, "tracking_5": 1.0}
# artifacts/frontend_vits/test_results.json: the same suite's figures on
# a TPU when the checkpoint was trained. Printed as context, not a bound.
SUITE_VITS_TPU = {"repeatability_1": 0.719760, "repeatability_5": 0.802265, "inlier_ratio": 0.785761,
                  "precision": 0.771739, "tracking_1": 1.0, "tracking_5": 1.0}
# Training (phases 21-24). The YAMLs are derived at run time from the
# committed configs (derive_config; ``python3 chip_smoke.py --write-config
# KIND OUT`` writes the same file without a card).
TINY_STATE = "weights/frontend_tiny_state.npz"  # artifacts/frontend_tiny's epoch-65 state
# Phase 21: the JAX CLI's per-epoch figures for the derived "resume" YAML
# (configs/train_tiny_synthetic.yaml, 17 frames of one world: 2 steps an
# epoch), from a CPU run of
#   python3 chip_smoke.py --write-config resume R.yaml
#   JAX_PLATFORMS=cpu python -m semantic_slam_master_tpu train --config R.yaml \
#       --resume artifacts/frontend_tiny/best_model --epochs 67 --jsonl-log J.jsonl
RESUME_JAX = {
    66: {"activation": 0.0006003701855661348, "calibration": 0.02071292046457529, "desc": 0.5827683806419373,
         "descriptor_variance": 0.015624419320374727, "edge": -0.9661192297935486,
         "expected_error": 0.0870591588318348, "localization": 0.6980366706848145, "loss": 5.0895819664001465,
         "max_saliency": 0.8993938565254211, "mean_saliency": 0.3743050843477249, "num_matches": 108.3125,
         "peakiness": 0.035451389849185944, "repeat": 0.025110822170972824, "saliency_variance": 0.032160867005586624,
         "skipped": 0.0, "sparsity": 0.0005694776773452759, "variance": 0.0},
    67: {"activation": 0.0002627247667987831, "calibration": 0.016629776917397976, "desc": 0.5481606721878052,
         "descriptor_variance": 0.015624841209501028, "edge": -0.9678350687026978,
         "expected_error": 0.0877896174788475, "localization": 0.6848908364772797, "loss": 4.797025203704834,
         "max_saliency": 0.9103991687297821, "mean_saliency": 0.3659706711769104, "num_matches": 108.75,
         "peakiness": 0.03563482686877251, "repeat": 0.022926748730242252, "saliency_variance": 0.03165819123387337,
         "skipped": 0.0, "sparsity": 0.0, "variance": 0.0},
}
# A figure x is held as |card - JAX| / (|JAX| + 0.01). The bf16 gap between
# the two packages on the CPU in that measure: 0.0499 for the resumed CLI
# runs of tests/test_torch_train_cli.py (64 px), 0.012599 for this YAML
# (the port's CLI with --device cpu beside the JAX run above). The card is
# held to twice the tests' gap.
RESUME_GAP_CPU_TEST = 0.0499
RESUME_GAP_CPU_PHASE = 0.012599
RESUME_GAP_BOUND = 2 * RESUME_GAP_CPU_TEST
# Phase 23: configs/train_vits_synthetic_long.yaml at full width with the
# data cut to 9 frames of one world (8 pairs: one step an epoch), 3 epochs.
# The seeded weights (training.seed 7) sum to this in |w| (float64, the
# state_dict, drawn on the CPU by PyTorch 2.13).
VITS_FRAMES = 9
VITS_EPOCHS = 3
VITS_WEIGHT_ABS_SUM = 877944.3491542276
VITS_CPU_PAIRS = 2  # the card-against-CPU forward: 2 pairs, so cross-image negatives run
# Phase 32: the stage-2 warm start (train --init-from VITS_WEIGHTS on the
# phase-23 YAML). The JAX package's first-step forward, bf16, train mode,
# on the first VITS_CPU_PAIRS pairs of the first batch from the restored
# artifacts/frontend_vits (``trainer._forward_pair``, jitted, on the CPU),
# as tests/test_torch_vits_weights.py computes and checks them; there the
# port's CPU forward from weights/frontend_vits.npz sits within 0.0083 of
# them (at ``desc``; 0.0125 at ``calibration`` with all the host's
# threads), well inside RESUME_GAP_BOUND, which the card is held to.
VITS_WARM_JAX = {
    "loss": 5.003952503204346, "activation": 0.0003540434699971229, "calibration": 0.019287066534161568,
    "desc": 0.5385493040084839, "edge": -0.9709627628326416, "expected_error": 0.0905679240822792,
    "hard": 0.06533731520175934, "localization": 0.8328458070755005, "peakiness": 0.033970415592193604,
    "repeat": 0.04104791209101677, "sparsity": 0.0, "variance": 0.0, "descriptor_variance": 0.0078122373670339584,
    "max_saliency": 0.9750898480415344, "mean_saliency": 0.33118394017219543, "num_matches": 312.0,
    "saliency_variance": 0.03569880872964859}
# Phase 24: train-segmenter --steps 300 --height 120 --width 160
# --model-width 32, JAX on the CPU over seeds 0-3: final loss 0.1011,
# 0.0975, 0.1090, 0.0628 and accuracy 0.964, 0.969, 0.965, 0.979; then
# run-slam --synthetic --dynamic --seed 1 --semantics model
# --segmenter-checkpoint <that seed's>: ATE 0.025214, 0.579714, 0.652049,
# 0.633786 m (the 300-step segmenter misses the walking person on three of
# the four). The port's init is drawn by PyTorch, so its run is held to a
# band: accuracy at least the worst JAX seed's less 0.03, loss at most
# twice the worst; ATE below twice the worst JAX seed's.
SEG_TRAIN_STEPS = 300
SEG_TRAIN_JAX_LOSS = (0.1011, 0.0975, 0.1090, 0.0628)
SEG_TRAIN_JAX_ACC = (0.964, 0.969, 0.965, 0.979)
SEG_TRAIN_ACC_MIN = min(SEG_TRAIN_JAX_ACC) - 0.03
SEG_TRAIN_LOSS_MAX = 2 * max(SEG_TRAIN_JAX_LOSS)
SEG_TRAIN_JAX_ATE_M = (0.025214, 0.579714, 0.652049, 0.633786)
SEG_TRAIN_ATE_BOUND_M = 2 * max(SEG_TRAIN_JAX_ATE_M)
# Phase 30: the ORB path's 60 frames (as the TUM phase decodes them) cut
# into FLEET_SEQUENCES disjoint sequences. The CPU's fleet on the card's
# features: matches and keyframes equal, inlier counts within one, poses
# within phase 16's bounds (m, rad) on all but FLEET_POSE_MISSES frames.
# RANSAC keeps its refined pose only if the refined support is not below
# the hypothesis's; where the two are level, the devices' rounding can
# decide it differently. On rendered frames of this world an H100 saw it
# once in 60 frames: the last frame of one sequence, equal inlier counts,
# poses 0.0157 m apart, every other frame within 5.3e-4 m.
FLEET_SEQUENCES = 4
FLEET_POSE_TOL = (1e-3, 1e-3)
FLEET_POSE_MISSES = 2
# Phase 31: the phase-23 recipe's first batch (ViT-S/16, 448 px, 8 pairs),
# one step from the seeded weights over 1x1 (NCCL; held against the step
# without a mesh) and the meshes MESH_SHAPES (two gloo ranks on the one
# card; held against 1x1), at float32 and at the recipe's bfloat16. At float32 a mesh changes
# only summation orders (the gradient's sum over ranks, BatchNorm's sums,
# the row-parallel partial products), so every figure and every array
# class (Adam's moments, the parameters, the BatchNorm statistics, each
# relative to its largest entry) is held to MESH_GAP_FACTOR x RUN_GAP.
# RUN_GAP is what summation order alone does to a train step on this card:
# the largest gap of Adam's moments between repeats of phase 22's bf16
# step with PyTorch's default kernels (scatter-add atomics in
# torch.gather's backward; the repeats are bit-equal under deterministic
# kernels): profile_determinism.py on an NVIDIA H100 80GB HBM3, 700 W.
# At bfloat16 the split matmuls also round their partial sums to bf16 (as
# Megatron's do) and keypoints flip, so the figures are held to
# RESUME_GAP_BOUND, the bf16 gap between the two frameworks, and the arrays
# printed; 1x1 keeps the float32 bound.
MESH_SHAPES = ((2, 1), (1, 2))
MESH_DTYPES = ("float32", "bfloat16")
RUN_GAP = 0.007982
MESH_GAP_FACTOR = 4.0
MESH_COLLECTIVE_TIMEOUT_S = 120
MESH_JOIN_TIMEOUT_S = 240
TARGET_TOTAL_S = 600
SMALL_LEVEL_SIZES = [(24, 32), (32, 32), (24, 64), (32, 64), (48, 80), (120, 100)]
DESCRIBE_SAME_MIN = 0.999  # descriptors card vs CPU on identical inputs (an atan2 ulp on a bin edge)
VIT_SALIENCY_GAP = 0.02  # ViT-S/16 saliency card vs CPU, as in phase 9
# gather_patches cases: (wrapper, (B, H, W), N, radius, centres). The first
# is the learned path's call per 8-frame chunk (500 keypoints on distinct
# cells of the 30x40 patch grid, 21x21 windows); the kernels line reports
# it. "random" centres fall in and around the frame, with keypoints on
# every clamp edge; "nonfinite" ones are +-inf, NaN and +-3e9 in x, y or
# both. B N = 111 is a multiple neither of the kernel's 8 keypoints per
# block nor of 4 (a ragged last block); N = 1 is one warp.
GATHER_CASES = [
    ("gather_patches", (8, 480, 640), 500, 10, "grid"),
    ("gather_patches", (8, 448, 448), 500, 10, "grid"),  # a ViT-S/16 train step's call (phase 23)
    ("gather_patches", (8, 224, 224), 192, 10, "grid"),  # a tiny-frontend train step's call (21, 22)
    ("gather_patches", (16, 480, 640), 202, 15, "random"),  # orb.orientations' 31x31 windows (phase 25)
    ("gather_patches_padded", (1, 480, 640), 8192, 15, "random"),
    ("gather_patches", (2, 83, 300), 37, 10, "random"),
    ("gather_patches_padded", (2, 83, 300), 37, 15, "random"),
    ("gather_patches", (3, 83, 300), 37, 10, "random"),
    ("gather_patches_padded", (3, 83, 300), 37, 15, "random"),
    ("gather_patches", (1, 480, 640), 1, 10, "random"),
    ("gather_patches_padded", (1, 480, 640), 1, 15, "random"),
    ("gather_patches", (2, 83, 300), 37, 10, "nonfinite"),
    ("gather_patches_padded", (2, 83, 300), 37, 15, "nonfinite"),
]
EXTREME_COORDS = [float("inf"), float("-inf"), float("nan"), 3e9, -3e9]

FAST_SHAPES = [(16, 480, 640), (16, 400, 544), (16, 336, 448), (16, 280, 384)]
# Ragged: heights and widths no multiple of the kernel's 128 x 16 tile, a
# width no multiple of 4 (no 16-byte rows), a frame smaller than a tile.
FAST_RAGGED = [(2, 83, 300), (1, 37, 129), (1, 7, 5)]
PATCH_CASES = [((16, 480, 640), 202), ((16, 400, 544), 142), ((16, 336, 448), 98), ((16, 280, 384), 70)]
PATCH_RAGGED = [((2, 83, 300), 37), ((1, 32, 33), 1), ((3, 59, 301), 9)]

T_START = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    import torch

    log(f"[phase] {name} ...")
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    log(f"[phase] {name} done in {time.perf_counter() - t0:.2f} s "
        f"(total {time.perf_counter() - T_START:.2f} s)")


def median_ms(fn, iters: int, warmup: int, flush) -> float:
    """Median device time of ``fn()`` over ``iters`` launches (CUDA events),
    with the L2 cache flushed before each launch. A spin on the device
    after the flush keeps the stream busy while the host enqueues the
    start event and ``fn``'s launches, so the host's enqueue time does not
    count as device time."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def unique_pixels(idx, n_pixels: int) -> int:
    """Distinct source pixels that the flat indices ``idx`` (B, L) touch
    in B frames of ``n_pixels``: what a gather must read at least once,
    however much its windows overlap."""
    import torch

    seen = torch.zeros((idx.shape[0], n_pixels), dtype=torch.bool, device=idx.device)
    seen.scatter_(1, idx, True)
    return int(seen.sum())


def bound(bytes_moved: float, f32_ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = f32_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def texture(torch, shape, gen):
    """Smooth random texture in [0, 1]: a coarse uniform grid upsampled,
    plus fine noise, so corners are neither absent nor everywhere."""
    B, H, W = shape
    coarse = torch.rand((B, 1, H // 8 + 1, W // 8 + 1), generator=gen, device="cuda")
    img = torch.nn.functional.interpolate(coarse, size=(H, W), mode="bilinear")[:, 0]
    return (img + 0.05 * torch.rand((B, H, W), generator=gen, device="cuda")).clamp(0, 1).contiguous()


def path_inputs(torch, synthetic, render_all, tracking, fast, image) -> list:
    """What the ORB path hands its two kernels for one 16-frame chunk of
    the rendered 640x480 world: per pyramid level (gray level, blurred
    level, keypoint xy), made by the calls ``extract_features`` makes."""
    seq = synthetic.make_sequence(num_frames=16, scale=1.0)
    gray = torch.from_numpy(render_all(seq)[1]).cuda()
    levels = tracking.build_pyramid(gray, 4)
    quotas = tracking.level_quotas([lvl.shape[1:] for lvl in levels], 512)
    out = []
    for lvl, quota in zip(levels, quotas):
        kp = fast.detect(lvl, int(quota), FAST_THRESHOLD, 3, subpixel=True)
        out.append((lvl, image.gaussian_blur(lvl, sigma=2.0, radius=3), kp.xy.contiguous()))
    torch.cuda.synchronize()
    return out


def fast_bounds(px: int, n_pass: int) -> dict:
    """fast_score's bounds for ``px`` pixels of which ``n_pass`` pass the
    4-point test: the recounted one (bytes; the early test on every pixel
    and the chain on the passing ones, at the issue rate), the old one
    (the chain on every pixel at the FMA-counted rate) and the chain on
    every pixel at the issue rate, the floor of a design without the
    early test."""
    ops = FAST_EARLY_OPS_PER_PIXEL * px + FAST_F32_OPS_PER_PIXEL * n_pass
    b_ms, b_by = bound(8.0 * px, ops)
    old_ms, old_by = bound(8.0 * px, FAST_F32_OPS_PER_PIXEL * px, F32_FLOPS_PER_S)
    chain_ms, chain_by = bound(8.0 * px, FAST_F32_OPS_PER_PIXEL * px)
    return {"bytes": 8.0 * px, "ops": ops, "bound_ms": b_ms, "bound_by": b_by, "old_bound_ms": old_ms,
            "old_bound_by": old_by, "chain_bound_ms": chain_ms}


def check_fast(torch, kfast, gen, flush, path) -> dict:
    """fast_score bit-exact against its plain version on random texture
    (FAST_SHAPES and the ragged shapes) and on the ORB path's four pyramid
    levels; every pixel that fails the 4-point test scores 0. Both inputs
    are timed per 16-frame chunk (the four levels summed); the path's
    levels give the kernels line."""
    cases = [("random", texture(torch, shape, gen)) for shape in FAST_SHAPES + FAST_RAGGED]
    cases += [("path", lvl) for lvl, _, _ in path]
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "px": 0, "pass": 0} for k in ("random", "path")}
    max_err = 0.0
    for kind, img in cases:
        shape = tuple(img.shape)
        got = kfast.fast_score(img, FAST_THRESHOLD)
        ref = kfast.fast_score_plain(img, FAST_THRESHOLD)
        cand = kfast.fast_candidates_plain(img, FAST_THRESHOLD)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not torch.equal(got, ref):
            raise AssertionError(f"fast_score {kind} {shape}: kernel != plain (max err {err}, "
                                 f"decisions equal {torch.equal(got > 0, ref > 0)})")
        if bool((ref[~cand] != 0).any()):
            raise AssertionError(f"fast_score {kind} {shape}: a pixel failing the 4-point test scores")
        max_err = max(max_err, err)
        ms = median_ms(lambda: kfast.fast_score(img, FAST_THRESHOLD), TIMED_ITERS, WARMUP_ITERS, flush)
        plain_ms = median_ms(lambda: kfast.fast_score_plain(img, FAST_THRESHOLD), PLAIN_ITERS, 1, flush)
        px, n_pass = img.numel(), int(cand.sum())
        b = fast_bounds(px, n_pass)
        log(f"  fast_score {kind} {shape}: exact=True corners={int((got > 0).sum())} "
            f"pass_share={n_pass / px:.4f} ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b['bound_ms']:.4f} "
            f"({b['bound_by']}) share_of_bound={b['bound_ms'] / ms:.3f} old_bound_ms={b['old_bound_ms']:.4f} "
            f"chain_on_every_pixel_bound_ms={b['chain_bound_ms']:.4f}")
        if kind == "path" or shape in FAST_SHAPES:
            t = totals[kind]
            t["ms"] += ms
            t["plain_ms"] += plain_ms
            t["px"] += px
            t["pass"] += n_pass
    for kind, t in totals.items():
        b = fast_bounds(t["px"], t["pass"])
        t.update(b, pass_share=t["pass"] / t["px"])
        log(f"  fast_score {kind} per 16-frame chunk (four levels): ms={t['ms']:.4f} "
            f"plain_ms={t['plain_ms']:.4f} pass_share={t['pass_share']:.4f} bound_ms={b['bound_ms']:.4f} "
            f"({b['bound_by']}) share_of_bound={b['bound_ms'] / t['ms']:.3f} old_bound_ms="
            f"{b['old_bound_ms']:.4f} ({b['old_bound_by']}) chain_on_every_pixel_bound_ms="
            f"{b['chain_bound_ms']:.4f}")
    return dict(totals["path"], max_abs_err=max_err, random_ms=totals["random"]["ms"])


def patch_bytes_ops(torch, kpatch, img, xy):
    """(bytes, ops, distinct pixels, flat index) of one aligned gather: the
    distinct f32 pixels the windows cover read once, 8 B of xy per
    keypoint, a 32x32 bf16 patch written per keypoint; quantisation ops."""
    B, H, W = img.shape
    N = xy.shape[1]
    cx, cy = kpatch.patch_centers(xy, H, W)
    d = torch.arange(32, device="cuda") - 15
    idx = ((cy[..., None, None] + d[:, None]) * W + cx[..., None, None] + d[None, :]).reshape(B, -1)
    n_read = unique_pixels(idx, H * W)
    return n_read * 4 + B * N * (8 + 32 * 32 * 2), B * N * 32 * 32 * PATCH_F32_OPS_PER_PIXEL, n_read, idx


def check_patches(torch, kpatch, gen, flush, path) -> dict:
    """gather_aligned_patches bit-exact against its plain version on random
    frames with keypoints on every clamp edge (PATCH_CASES, the ragged
    cases) and on the ORB path's blurred levels and detections. Both are
    timed per 16-frame chunk; the path's give the kernels line."""
    cases = []
    for (B, H, W), N in PATCH_CASES + PATCH_RAGGED:
        img = torch.rand((B, H, W), generator=gen, device="cuda") * 1.2 - 0.1
        xy = torch.rand((B, N, 2), generator=gen, device="cuda")
        xy = xy * torch.tensor([W + 10.0, H + 10.0], device="cuda") - 5.0
        # Keypoints on and beyond every clamp edge, and on half-pixel ties.
        edges = torch.tensor(
            [[0.0, 0.0], [W - 1.0, H - 1.0], [W - 18.0, H - 17.0], [W - 17.5, H - 16.5],
             [14.5, 15.5], [15.0, 15.0], [-3.0, H + 3.0], [W / 2 + 0.5, H / 2 - 0.5]],
            device="cuda",
        )
        xy[:, : min(N, len(edges))] = edges[:N]
        cases.append(("random", img, xy))
    cases += [("path", blurred, xy) for _, blurred, xy in path]
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "ops": 0.0}
              for k in ("random", "path")}
    max_err = 0.0
    for kind, img, xy in cases:
        (B, H, W), N = img.shape, xy.shape[1]
        got = kpatch.gather_aligned_patches(img, xy)
        ref = kpatch.gather_aligned_patches_plain(img, xy)
        torch.cuda.synchronize()
        if got.dtype != torch.bfloat16 or got.shape != (B, N, 32, 32):
            raise AssertionError(f"patches {(B, H, W, N)}: {got.dtype} {tuple(got.shape)}")
        err = (got.float() - ref.float()).abs().max().item()
        if not torch.equal(got, ref):
            raise AssertionError(f"patches {kind} {(B, H, W, N)}: kernel != plain (max err {err})")
        max_err = max(max_err, err)
        ms = median_ms(lambda: kpatch.gather_aligned_patches(img, xy), TIMED_ITERS, WARMUP_ITERS, flush)
        plain_ms = median_ms(lambda: kpatch.gather_aligned_patches_plain(img, xy), PLAIN_ITERS, 1, flush)
        nbytes, ops, n_read, idx = patch_bytes_ops(torch, kpatch, img, xy)
        flat = img.reshape(B, H * W)
        library_ms = median_ms(lambda: torch.gather(flat, 1, idx), TIMED_ITERS, WARMUP_ITERS, flush)
        b_ms, b_by = bound(nbytes, ops)
        log(f"  gather_aligned_patches {kind} {(B, H, W)} N={N}: exact=True ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
            f"share_of_bound={b_ms / ms:.3f} distinct_pixels_read={n_read} "
            f"window_pixels={B * N * 32 * 32}")
        if kind == "path" or ((B, H, W), N) in PATCH_CASES:
            t = totals[kind]
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms), ("bytes", nbytes),
                         ("ops", ops)):
                t[k] += v
    for kind, t in totals.items():
        b_ms, b_by = bound(t["bytes"], t["ops"])
        log(f"  gather_aligned_patches {kind} per 16-frame chunk (four levels): ms={t['ms']:.4f} "
            f"plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} bound_ms={b_ms:.4f} ({b_by}) "
            f"share_of_bound={b_ms / t['ms']:.3f}")
    return dict(totals["path"], max_abs_err=max_err, random_ms=totals["random"]["ms"])


def grid_centres(torch, gen, B: int, H: int, W: int, N: int):
    """(B, N, 2) centres of N distinct cells of the 16-pixel patch grid per
    frame, as the learned path's top-k over the saliency grid gives them."""
    cells = torch.stack([torch.randperm((H // 16) * (W // 16), generator=gen, device="cuda")[:N]
                         for _ in range(B)])
    return torch.stack([cells % (W // 16), cells // (W // 16)], -1).float() * 16 + 8


def gather_centres(torch, gen, kind: str, B: int, H: int, W: int, N: int, radius: int, side: int):
    """Centres of one GATHER_CASES case (see there)."""
    if kind == "grid":
        return grid_centres(torch, gen, B, H, W, N)
    xy = torch.rand((B, N, 2), generator=gen, device="cuda")
    xy = xy * torch.tensor([W + 40.0, H + 40.0], device="cuda") - 20.0
    if kind == "random":
        edges = [[0.0, 0.0], [W - 1.0, H - 1.0], [radius + 0.5, radius - 0.5],
                 [W - side + radius + 0.5, H - side + radius + 0.5], [-3.0, H + 3.0]]
    else:
        mid_x, mid_y = W / 2, H / 2
        edges = [p for v in EXTREME_COORDS for p in ([v, mid_y], [mid_x, v], [v, v])]
        edges += [[u, v] for u in EXTREME_COORDS for v in EXTREME_COORDS if u is not v][:N - len(edges)]
    edges = torch.tensor(edges[:N], device="cuda")
    xy[:, : len(edges)] = edges
    return xy


def check_gather(torch, kgather, gen, flush) -> dict:
    """gather_patches in both modes against its plain version, bit-exact;
    the first case (the learned path's shape) is timed for the kernels
    line."""
    report = {"max_abs_err": 0.0}
    for i, (wrapper, (B, H, W), N, radius, kind) in enumerate(GATHER_CASES):
        side = 2 * radius + 1 if wrapper == "gather_patches" else kgather.PADDED_SIDE
        img = torch.randn((B, H, W), generator=gen, device="cuda")
        xy = gather_centres(torch, gen, kind, B, H, W, N, radius, side)
        fn = getattr(kgather, wrapper)
        got = fn(img, xy, radius)
        ref = kgather.gather_patches_reference(img, xy, radius, side)
        torch.cuda.synchronize()
        if got.shape != (B, N, side, side) or got.dtype != torch.float32:
            raise AssertionError(f"{wrapper} {(B, H, W, N)}: {got.dtype} {tuple(got.shape)}")
        err = (got - ref).abs().max().item()
        if not torch.equal(got, ref):
            raise AssertionError(f"{wrapper} {(B, H, W, N, radius)} {kind}: kernel != plain (max err {err})")
        report["max_abs_err"] = max(report["max_abs_err"], err)
        ms = median_ms(lambda: fn(img, xy, radius), TIMED_ITERS, WARMUP_ITERS, flush)
        plain_ms = median_ms(lambda: kgather.gather_patches_reference(img, xy, radius, side),
                             PLAIN_ITERS, 1, flush)
        idx = kgather.window_index(xy, W, radius, side, *kgather.window_bounds(img, radius, side))
        flat = img.reshape(B, H * W)
        library_ms = median_ms(lambda: torch.gather(flat, 1, idx), TIMED_ITERS, WARMUP_ITERS, flush)
        # A pure copy, no arithmetic: the distinct source pixels the windows
        # cover read once (overlapping windows share them), 8 B of centre
        # per window, every window written once.
        n_read = unique_pixels(idx, H * W)
        nbytes = n_read * 4 + B * N * (8 + side * side * 4)
        b_ms, b_by = bound(nbytes, 0.0)
        log(f"  {wrapper} {(B, H, W)} N={N} r={radius} {kind}: exact=True ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) share_of_bound={b_ms / ms:.3f} "
            f"distinct_pixels_read={n_read} window_pixels={B * N * side * side}")
        if i == 0:
            report.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bytes=nbytes, ops=0.0)
    return report


@contextlib.contextmanager
def refine_inputs(torch):
    """Record what ``pnp.ransac_pose`` hands ``pnp_refine`` (copies of its
    arguments) on every call inside the block; the kernel still runs, and
    its launch count is untouched."""
    from semantic_slam_master_tpu_torch.ops.kernels import pnp_refine as kref
    from semantic_slam_master_tpu_torch.slam import pnp

    calls = []

    def recording(*args, **kw):
        calls.append(([a.clone() if isinstance(a, torch.Tensor) else a for a in args], kw))
        return kref.pnp_refine(*args, **kw)

    pnp.pnp_refine = types.SimpleNamespace(pnp_refine=recording)  # stands for the module there
    try:
        yield calls
    finally:
        pnp.pnp_refine = kref


@contextlib.contextmanager
def ransac_inputs(torch):
    """Record what ``pnp.ransac_pose`` hands ``ransac`` (copies of its
    arguments) on every call inside the block; the kernel still runs, and
    its launch count is untouched."""
    from semantic_slam_master_tpu_torch.ops.kernels import ransac as kransac
    from semantic_slam_master_tpu_torch.slam import pnp

    calls = []

    def recording(*args, **kw):
        calls.append(([a.clone() if isinstance(a, torch.Tensor) else a for a in args], kw))
        return kransac.ransac(*args, **kw)

    pnp.ransac = types.SimpleNamespace(ransac=recording)  # stands for the module there
    try:
        yield calls
    finally:
        pnp.ransac = kransac


def ransac_cost(args) -> tuple:
    """(bytes, f32 operations) the kernel needs once: u, the cumulative
    probabilities, points, points_dst, observations, valid, w_sem and
    weights read; Ts, T_best, inls, supports, best, mask and w written; ~2,000
    operations a fit and ~40 a reprojection (H x N of them, and N for the
    best's mask)."""
    u, points = args[0], args[1]
    H, N = u.shape[0], points.shape[0]
    nbytes = H * 12 + N * (4 + 12 + 12 + 8 + 1 + 4 + 4) + H * (64 + 8 + 4) + 64 + 8 + N * (1 + 4)
    return nbytes, 2000.0 * H + 40.0 * (H + 1) * N


def check_ransac(torch, paths: dict) -> dict:
    """Phase 34 (the module docstring): the RANSAC kernel against its plain
    version on what each path's ``ransac_pose`` handed it, to the bit; timed
    on the ORB path's middle frame for the kernels line."""
    from semantic_slam_master_tpu_torch.ops.kernels import ransac as kransac

    for path, calls in paths.items():
        differ, ties = [], 0
        for f, (args, kw) in enumerate(calls):
            got = kransac.ransac(*args, **kw)
            ref = kransac.ransac_plain(*args, **kw)
            outs = [name for name, a, b in zip(kransac.Hypotheses._fields, got, ref) if not torch.equal(a, b)]
            if outs:
                differ.append((f, *outs))
            ties += int((ref.supports == ref.supports.max()).sum()) > 1
        sizes = sorted({args[1].shape[0] for args, _ in calls})
        log(f"  {path}: {len(calls)} calls, N={sizes}: the kernel's outputs not the plain bits on {len(differ)} "
            f"{differ}; the largest support tied on {ties} (the first index taken)")
        if differ:
            raise AssertionError(f"ransac differs from its plain version on the {path} path's frames {differ}")

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    report = {"max_abs_err": 0.0}
    for path, calls in paths.items():
        args, kw = calls[len(calls) // 2]
        u, points, points_dst, obs, cam, valid, weights, threshold = args
        w_sem, probs = kransac._sampling_weights(valid, weights, points.dtype)
        p_cuml = torch.cumsum(probs, dim=0)
        launch = (u, p_cuml, w_sem, points, points_dst, obs, cam, valid, weights, threshold)
        ms = median_ms(lambda: kransac._launch(*launch), TIMED_ITERS, WARMUP_ITERS, flush)
        span_ms = median_ms(lambda: kransac.ransac(*args, **kw), TIMED_ITERS, WARMUP_ITERS, flush)
        plain = []
        for a, k in calls[:PLAIN_FRAMES]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kransac.ransac_plain(*a, **k)
            torch.cuda.synchronize()
            plain.append((time.perf_counter() - t0) * 1e3)
        plain_ms = sorted(plain)[len(plain) // 2]
        nbytes, ops = ransac_cost(args)
        b_ms, b_by = bound(nbytes, ops)
        log(f"  ransac on the {path} path's middle frame, H={u.shape[0]} N={points.shape[0]}: ms={ms:.4f} (the "
            f"kernel) span_ms={span_ms:.4f} (with the draw's weights and cumsum) plain_ms={plain_ms:.4f} (host "
            f"clock, synchronised; median of {len(plain)} frames) bound_ms={b_ms:.6f} ({b_by}: bytes {nbytes}, "
            f"ops {ops:.0f}; latency-bound: draws, fits, scores, argmax and mask one after another)")
        if path == "orb":
            report.update(ms=ms, plain_ms=plain_ms, bytes=nbytes, ops=ops)
    return report


def refine_bytes(args) -> int:
    """What the kernel must read and write once: points, observations, w,
    w_sem, valid and mask (N each), T_best, supports, inls and best; the
    pose, the count, the mask and the rmse."""
    N, H = args[1].shape[0], args[8].numel()
    return N * (12 + 8 + 4 + 4 + 1 + 1) + 64 + H * (4 + 8) + 8 + 64 + 8 + N + 4


def check_refine(torch, paths: dict) -> dict:
    """Phase 33 (the module docstring): pnp_refine against its plain version
    on what each path's ``ransac_pose`` handed it, to the bit; timed on the
    ORB path's middle frame for the kernels line."""
    from semantic_slam_master_tpu_torch.ops.kernels import pnp_refine as kref
    from semantic_slam_master_tpu_torch.slam import pnp

    for path, calls in paths.items():
        differ, kept, ties, split, below, rows_differ = [], 0, 0, 0, 0, 0
        for f, (args, kw) in enumerate(calls):
            T_best, points, obs, cam, w, w_sem, valid, mask, supports, inls, best = args
            got = kref.pnp_refine(*args, **kw)
            ref = kref.pnp_refine_plain(*args, **kw)
            outs = [name for name, a, b in zip(("pose", "count", "mask", "rmse"), got, ref) if not torch.equal(a, b)]
            if outs:
                differ.append((f, *outs))
            kept += torch.equal(ref[0], T_best)
            # A tie: the refined pose has the best hypothesis's inlier set,
            # so the two supports are one sum taken in two orders.
            T_ref = pnp.refine_pose(T_best, points, obs, cam, weights=w, num_iters=kw["num_iters"])
            _, mask_ref = pnp.count_inliers(T_ref, points, obs, cam, valid, kw["threshold"])
            if torch.equal(mask_ref, mask):
                ties += 1
                sup_ref = torch.sum(mask_ref * w_sem)
                split += not torch.equal(sup_ref, supports[best])
                below += bool(sup_ref < supports[best])
            # The best hypothesis's row of the batched recount against its own.
            H = supports.numel()
            rows = pnp.count_inliers(T_best.expand(H, 4, 4).contiguous(), points, obs, cam, valid, kw["threshold"])[1]
            rows_differ += not torch.equal(rows[0], mask)
        sizes = sorted({args[1].shape[0] for args, _ in calls})
        log(f"  {path}: {len(calls)} calls, N={sizes}: kernel's pose, count, mask or rmse not the plain bits on "
            f"{len(differ)} {differ}; T_best kept on {kept}; ties (the refined inlier set is the best's) on {ties}, "
            f"their two support sums differing in bits on {split} (the refined one below on {below}); "
            f"masks[best] != mask on {rows_differ}")
        if differ:
            raise AssertionError(f"pnp_refine differs from its plain version on the {path} path's frames {differ}")

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    report = {"max_abs_err": 0.0}
    for path, calls in paths.items():
        args, kw = calls[len(calls) // 2]
        ms = median_ms(lambda: kref.pnp_refine(*args, **kw), TIMED_ITERS, WARMUP_ITERS, flush)
        plain = []
        for a, k in calls[:PLAIN_FRAMES]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kref.pnp_refine_plain(*a, **k)
            torch.cuda.synchronize()
            plain.append((time.perf_counter() - t0) * 1e3)
        plain_ms = sorted(plain)[len(plain) // 2]
        nbytes = refine_bytes(args)
        b_ms, _ = bound(nbytes, 0.0)
        log(f"  pnp_refine on the {path} path's middle frame, N={args[1].shape[0]}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"(host clock, synchronised; median of {len(plain)} frames) bound_ms={b_ms:.6f} (bytes {nbytes}; "
            f"latency-bound: {kw['num_iters']} dependent steps)")
        if path == "orb":
            report.update(ms=ms, plain_ms=plain_ms, bytes=nbytes, ops=0.0)
    return report


def check_learned(torch, synthetic, render_all, tracking, config_mod, seg_mod, select_keypoints) -> None:
    """The ViT-S/16 learned frontend and the segmenter on the card against
    the CPU, the same seeded weights on both (bounds in the docstring).
    A freshly seeded offset head's last conv is zero, which would make
    every sub-patch offset exactly 0; here it gets seeded non-zero weights
    so the comparison runs through the gathered windows, their
    standardisation, the head's convolutions and its masked softmax."""
    seq = synthetic.make_sequence(num_frames=2, scale=1.0)
    rgb = torch.from_numpy(render_all(seq)[0])
    x = tracking.normalize_rgb(rgb)
    cfg = config_mod.load_model_config(LEARNED_CONFIG)

    def seeded(dtype):
        m = config_mod.build_model(cfg, dtype=dtype, generator=torch.Generator().manual_seed(SEED)).eval()
        w = m.offset_head.conv3.weight
        with torch.no_grad():
            w.copy_(torch.randn(w.shape, generator=torch.Generator().manual_seed(SEED + 1))
                    / w[0].numel() ** 0.5)
        return m

    model, model_f32 = seeded(torch.bfloat16), seeded(torch.float32)
    seg = seg_mod.SemanticSegmenter(generator=torch.Generator().manual_seed(SEED)).eval()
    with torch.no_grad():
        cpu = model(x)
        cpu_f32 = model_f32(x)
        cpu_labels = seg_mod.predict_classes(seg(rgb, full_res=False))
        kp = select_keypoints(cpu.saliency, model.num_keypoints, model.nms_radius)
        off_cpu = model.refine_at(cpu.features, cpu.saliency, x, kp.xy) - kp.xy
        model_gpu, seg_gpu = copy.deepcopy(model).cuda(), copy.deepcopy(seg).cuda()
        gpu = model_gpu(x.cuda())
        gpu_labels = seg_mod.predict_classes(seg_gpu(rgb.cuda(), full_res=False)).cpu()
        kp_gpu = select_keypoints(gpu.saliency, model.num_keypoints, model.nms_radius)
        # The sub-patch refinement alone, on the CPU's inputs.
        off_gpu = model_gpu.refine_at(cpu.features.cuda(), cpu.saliency.cuda(), x.cuda(),
                                      kp.xy.cuda()) - kp.xy.cuda()
    torch.cuda.synchronize()
    ps = model.patch_size
    sal_err = (gpu.saliency.cpu() - cpu.saliency).abs().max().item()
    # Patch-centre selections, as sets per frame (exact patch coordinates).
    sel_cpu, sel_gpu = kp.xy, kp_gpu.xy.cpu()
    selected = float((torch.cdist(sel_cpu, sel_gpu).min(-1).values <= 1e-3).float().mean())
    # Sub-patch offsets on the same inputs, in pixels.
    d_off = ((off_gpu.cpu() - off_cpu) * ps).abs().amax(-1)
    off_same = float((d_off <= 1e-3).float().mean())
    off_mean = float((off_cpu * ps).abs().mean())

    # Distance from each CPU keypoint to the nearest card (or f32) one.
    dist, j = torch.cdist(cpu.keypoints_px, gpu.keypoints_px.cpu()).min(-1)
    dist_f32 = torch.cdist(cpu.keypoints_px, cpu_f32.keypoints_px).min(-1).values
    within = {t: float((dist <= t).float().mean()) for t in (0.05, 0.5)}
    within_f32 = {t: float((dist_f32 <= t).float().mean()) for t in (0.05, 0.5)}
    pair = dist <= 0.05
    desc_gpu = torch.gather(gpu.descriptors.cpu(), 1, j[..., None].expand(-1, -1, cpu.descriptors.shape[-1]))
    cos = (desc_gpu * cpu.descriptors).sum(-1)[pair]
    agree = float((gpu_labels == cpu_labels).float().mean())
    log(f"  learned card vs cpu: saliency max abs diff {sal_err:.3g} (bound 0.02); patch-centre "
        f"keypoints selected by both {selected:.4f} (bound 0.90); sub-patch offsets on the same "
        f"inputs: mean |offset| {off_mean:.3f} px (bound >= 0.5), within 1e-3 px {off_same:.4f} "
        f"(bound 0.99), max |diff| {d_off.max().item():.3g} px; refined keypoints within 0.05 / 0.5 px "
        f"{within[0.05]:.4f} / {within[0.5]:.4f} (bound 0.90 at 0.5 px; bf16 vs f32 on the cpu "
        f"{within_f32[0.05]:.4f} / {within_f32[0.5]:.4f}); descriptor cosine over {int(pair.sum())} "
        f"pairs within 0.05 px mean {float(cos.mean()):.5f} min {float(cos.min()):.5f} "
        f"(bounds 0.99 / 0.9); segmenter labels agree {agree:.5f} (bound 0.99)")
    if not (sal_err <= 0.02 and selected >= 0.90 and off_mean >= 0.5 and off_same >= 0.99
            and within[0.5] >= 0.90 and int(pair.sum()) > 0 and float(cos.mean()) >= 0.99
            and float(cos.min()) >= 0.9 and agree >= 0.99):
        raise AssertionError("learned frontend or segmenter on the card disagrees with the CPU")


def learned_split(torch, synthetic, render_all, tracking, run_slam_cli, select_keypoints) -> dict:
    """Device ms per 8-frame chunk of each stage of the learned path
    (segmenter, backbone, saliency head + selection, sub-patch refinement,
    descriptors), warm, median of 5, with the path's trained models."""
    args = argparse.Namespace(
        seed=SEED, train_config=VITS_CONFIG, checkpoint=VITS_WEIGHTS, segmenter_checkpoint=SEGMENTER_WEIGHTS)
    model = run_slam_cli.load_learned_frontend(args, torch.device("cuda"))
    seg = run_slam_cli.load_segmenter(args, torch.device("cuda"))
    seq = synthetic.make_sequence(num_frames=run_slam_cli.LEARNED_CHUNK, scale=1.0)
    rgb = torch.from_numpy(render_all(seq)[0]).cuda()
    x = tracking.normalize_rgb(rgb)
    out = {}
    with torch.no_grad():
        feats = model.backbone(x)
        sal = model.selector(feats)
        kp = select_keypoints(sal, model.num_keypoints, model.nms_radius)
        xy = model.refine_at(feats, sal, x, kp.xy)
        stages = {
            "segmenter": lambda: seg(rgb, full_res=False),
            "backbone": lambda: model.backbone(x),
            "saliency_select": lambda: select_keypoints(model.selector(feats), model.num_keypoints,
                                                        model.nms_radius),
            "subpatch_refine": lambda: model.refine_at(feats, sal, x, kp.xy),
            "describe": lambda: model.describe_at(feats, xy),
        }
        for name, fn in stages.items():
            for _ in range(2):
                fn()
            times = []
            for _ in range(5):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            out[name] = sorted(times)[2]
    return out


def run_cli_path(torch, run_slam_cli, evaluate_cli, tmp, argv, seed: int = SEED, eval_argv=()) -> tuple:
    """``run-slam`` then ``evaluate`` in ``tmp``: (run stats, evaluation)."""
    t0 = time.perf_counter()
    run_slam_cli.main(argv + ["--device", "cuda", "--seed", str(seed), "--output-dir", tmp])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    evaluate_cli.main(["--trajectories", tmp, *eval_argv])
    with open(os.path.join(tmp, "results.json")) as f:
        (name, res), = json.load(f).items()
    with open(os.path.join(tmp, f"{name}_run.json")) as f:
        run = json.load(f)
    if res.get("status") != "success":
        raise AssertionError(f"evaluate failed: {res}")
    run["wall_s"] = wall
    return run, res


def check_frontend(torch, tracking, synthetic, seg_mod) -> None:
    """The card's frontend (both kernels) against the CPU's (their plain
    versions) on two 640x480 frames, and on two frames of the dynamic
    world with the GT class-weight map (``weight_map``: it scales the
    corner scores and sets each keypoint's ``sem_weight``). The
    pyramid's resize products sum in another order on the card, which
    moves sub-pixel refinements by ~1e-4 px; a keypoint coincides when
    its slot holds the same detection within 1e-3 px. >= 98% must
    coincide, >= 99% of their descriptors must be bit-identical (an ulp
    in a blurred pixel can cross a quantisation step), and their
    ``sem_weight`` must be equal. With the weight map, some keypoints must
    carry a weight below 1 and the detections must differ from the
    unweighted ones on the same frames."""
    from semantic_slam_master_tpu_torch.cli.run_slam_cli import render_all

    static = synthetic.make_sequence(num_frames=2, scale=1.0)
    dynamic = synthetic.make_dynamic_sequence(num_frames=2, scale=1.0)
    for name, seq, weighted in (("static", static, False), ("dynamic + GT weight map", dynamic, True)):
        _, gray, depth, labels = render_all(seq)
        g, d = torch.from_numpy(gray), torch.from_numpy(depth)
        wmap = seg_mod.class_weights_map(torch.from_numpy(labels)) if weighted else None
        cpu = tracking.extract_features(g, d, weight_map=wmap)
        gpu = tracking.extract_features(g.cuda(), d.cuda(),
                                        weight_map=None if wmap is None else wmap.cuda())
        torch.cuda.synchronize()
        gpu = tracking.FrameFeatures(*[x.cpu() for x in gpu])
        coincide = ((gpu.xy - cpu.xy).abs().amax(-1) <= 1e-3) & (gpu.valid == cpu.valid)
        share = float(coincide[cpu.valid].float().mean())
        exact_xy = float((gpu.xy == cpu.xy).all(-1)[cpu.valid].float().mean())
        same_desc = float((gpu.desc == cpu.desc).all(-1)[coincide & cpu.valid].float().mean())
        same_w = bool((gpu.sem_weight == cpu.sem_weight)[coincide & cpu.valid].all())
        log(f"  frontend card vs cpu, {name}: keypoints coincide {share:.4f} (bit-identical xy "
            f"{exact_xy:.4f}), descriptors identical where they coincide {same_desc:.4f}, "
            f"sem_weight equal {same_w}, valid {int(gpu.valid.sum())}/{gpu.valid.numel()}")
        if share < 0.98 or same_desc < 0.99 or not same_w:
            raise AssertionError(f"frontend on the card disagrees with the CPU frontend ({name})")
        if weighted:
            plain = tracking.extract_features(g.cuda(), d.cuda())
            torch.cuda.synchronize()
            down = int((gpu.sem_weight < 1.0)[gpu.valid].sum())
            moved = float(((plain.xy.cpu() - gpu.xy).abs().amax(-1) > 1e-3)[gpu.valid].float().mean())
            log(f"  weight map on the card: {down} keypoints weighted below 1, "
                f"{moved:.4f} of the slots hold another keypoint than without the map")
            if down == 0 or moved == 0.0:
                raise AssertionError("the weight map changed nothing on the card")


def poses_agree(P, Q) -> tuple:
    """(max translation difference in m, max rotation difference in rad)
    of two (F, 4, 4) pose stacks. The angle is 2 asin(|R_P - R_Q|_F / sqrt(8)),
    exact for rotations and 0 for equal matrices (the arccos of the
    relative rotation's trace turns f32 rounding into its square root)."""
    P, Q = np.asarray(P, np.float64), np.asarray(Q, np.float64)
    dt = float(np.abs(P[:, :3, 3] - Q[:, :3, 3]).max())
    fro = np.linalg.norm(P[:, :3, :3] - Q[:, :3, :3], axis=(1, 2))
    dr = float((2 * np.arcsin(np.minimum(fro / np.sqrt(8.0), 1.0))).max())
    return dt, dr


def segmenter_fidelity(torch, synthetic, render_all, seg_mod, run_slam_cli) -> tuple:
    """The trained segmenter's 1/4-resolution labels on the card over the
    dynamic phase's 60 frames against the rendered GT labels, subsampled
    to that grid as accuracy.py does: (person recall, label accuracy)."""
    args = argparse.Namespace(segmenter_checkpoint=SEGMENTER_WEIGHTS)
    seg = run_slam_cli.load_segmenter(args, torch.device("cuda"))
    rgb, _, _, labels = render_all(synthetic.make_dynamic_sequence(num_frames=MAIN_FRAMES, scale=1.0))
    pred = []
    with torch.no_grad():
        for i in range(0, len(rgb), run_slam_cli.SEGMENTER_CHUNK):
            x = torch.from_numpy(rgb[i:i + run_slam_cli.SEGMENTER_CHUNK]).cuda()
            pred.append(seg_mod.predict_classes(seg(x, full_res=False)).cpu())
    pred = torch.cat(pred).numpy()
    sy, sx = labels.shape[1] // pred.shape[1], labels.shape[2] // pred.shape[2]
    gt = labels[:, ::sy, ::sx][:, :pred.shape[1], :pred.shape[2]]
    person = gt == synthetic.CLASS_PERSON
    recall = float((pred[person] == synthetic.CLASS_PERSON).mean())
    return recall, float((pred == gt).mean())


def loop_path(torch, synthetic, run_slam_cli, system, online, prng, ate_rpe, reset_counts,
              read_counts) -> dict:
    """accuracy.py's loop protocol on the card (constants above): the
    harsh loop rendered once, its ORB features, then ``run_slam_online``
    with loop closure and without on the same features."""
    seq = synthetic.make_loop_sequence(num_frames=LOOP_FRAMES, scale=1.0, harsh=True)
    t0 = time.perf_counter()
    _, gray, depth, _ = run_slam_cli.render_all(seq)
    t_render = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    feats = run_slam_cli.features_for_frames(gray, depth, LOOP_KEYPOINTS, torch.device("cuda"))
    torch.cuda.synchronize()
    t_frontend = time.perf_counter() - t0
    del gray, depth
    cfg = system.SlamConfig()
    u = torch.from_numpy(prng.slam_uniforms(SEED, LOOP_FRAMES, cfg.num_hypotheses)).cuda()
    runs = {}
    for name, closure in (("closure", True), ("odometry", False)):
        timings = []
        t0 = time.perf_counter()
        out, loops = online.run_slam_online(u, feats, seq.cam, cfg, chunk_size=LOOP_CHUNK,
                                            enable_loop_closure=closure, timings=timings, **LOOP_KW)
        poses = out.poses_wc.cpu().numpy().astype(np.float64)
        wall = time.perf_counter() - t0
        res = ate_rpe.evaluate_trajectory(seq.timestamps, seq.poses_wc, seq.timestamps, poses)
        runs[name] = dict(out=out, poses=poses, loops=loops, timings=timings, wall=wall,
                          ate=res["ate"]["rmse"], finite=bool(np.isfinite(poses).all()))
    return dict(seq=seq, feats=feats, runs=runs, counts=read_counts(), render_s=t_render,
                frontend_s=t_frontend)


def closing_pass_card_vs_cpu(torch, tracking, loop_closing, loop) -> None:
    """One offline closing pass (``close_sequence_loops`` with the loop
    protocol's gates) over the loop run's odometry, once on the CPU and
    once on the card, on identical features: one set held on the CPU and
    copied to the card. The two must accept the same loops, with corrected
    poses within 1e-3 m and 1e-3 rad."""
    feats_cpu = tracking.FrameFeatures(*[x.cpu() for x in loop["feats"]])
    feats_card = tracking.FrameFeatures(*[x.cuda() for x in feats_cpu])
    odo = loop["runs"]["odometry"]
    is_kf = odo["out"].is_keyframe.cpu().numpy()
    cam = loop["seq"].cam
    t0 = time.perf_counter()
    p_cpu, l_cpu = loop_closing.close_sequence_loops(odo["poses"], feats_cpu, is_kf, cam, **LOOP_KW)
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    p_card, l_card = loop_closing.close_sequence_loops(odo["poses"], feats_card, is_kf, cam, **LOOP_KW)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    dt, dr = poses_agree(p_card, p_cpu)
    pairs_cpu, pairs_card = [(a, b) for a, b, _ in l_cpu], [(a, b) for a, b, _ in l_card]
    log(f"  closing pass over {int(is_kf.sum())} keyframes: cpu {t_cpu:.2f} s loops {pairs_cpu}; card "
        f"{t_card:.2f} s loops {pairs_card}; corrected poses max diff {dt:.3g} m {dr:.3g} rad "
        f"(bounds 1e-3 / 1e-3)")
    if pairs_cpu != pairs_card or not (dt <= 1e-3 and dr <= 1e-3):
        raise AssertionError("the closing pass on the card disagrees with the CPU's")
    if not pairs_cpu:
        raise AssertionError("the closing pass accepted no loop: nothing was compared")


def png_environment() -> dict:
    """Whether the machine has libpng's header (the compiler finds
    ``<png.h>``), the libpng library, and PIL."""
    cxx = shutil.which("g++") or shutil.which("c++")
    header = False
    if cxx:
        header = subprocess.run([cxx, "-E", "-x", "c++", "-"], input="#include <png.h>\n", capture_output=True,
                                text=True, timeout=60).returncode == 0
    return {"png.h": header, "libpng": ctypes.util.find_library("png16") or ctypes.util.find_library("png"),
            "PIL": importlib.util.find_spec("PIL") is not None, "g++": cxx}


def bits_equal(a, b) -> bool:
    return a.shape == b.shape and bool((a.view(np.uint32) == b.view(np.uint32)).all())


def tum_input(torch, synthetic, tum, native_io, prefetch, root: str, device: str = "cuda") -> dict:
    """Phase 18 (see the module docstring): writes the TUM directory under
    ``root`` and checks the decoders and the pinned stream to ``device``
    (on the CPU, for a rehearsal, the stream is the identity and nothing
    is pinned)."""
    seq = synthetic.make_sequence(num_frames=MAIN_FRAMES, scale=1.0)
    t0 = time.perf_counter()
    tum.write_tum_sequence(seq, root, TUM_NAME, filters=TUM_FILTERS)
    t_write = time.perf_counter() - t0
    env = png_environment()
    decoder = native_io.decoder()
    log(f"  wrote {MAIN_FRAMES} frames as {TUM_NAME} (rendered and encoded, PNG row filters {TUM_FILTERS}) in "
        f"{t_write:.2f} s; machine: png.h {'present' if env['png.h'] else 'absent'}, libpng "
        f"{env['libpng'] or 'absent'}, PIL {'present' if env['PIL'] else 'absent'}, g++ {env['g++'] or 'absent'}; "
        f"decoder {decoder}")
    ts = tum.TUMSequence(root, TUM_NAME)
    cam = ts.cam
    files = (ts.rgb_files, ts.depth_files)
    geometry = dict(width=cam.width, height=cam.height, depth_scale=cam.depth_scale)
    t0 = time.perf_counter()
    plain = native_io.load_batch_plain(*files, **geometry)
    t_plain = time.perf_counter() - t0
    rates = {"plain_fps": MAIN_FRAMES / t_plain}
    if decoder["name"] == "native":
        t0 = time.perf_counter()
        native = native_io.load_batch(*files, **geometry)
        rates["native_fps"] = MAIN_FRAMES / (time.perf_counter() - t0)
        equal = [bits_equal(n, p) for n, p in zip(native, plain)]
        log(f"  native vs plain decode of {MAIN_FRAMES} frames: rgb bit-equal {equal[0]}, depth bit-equal "
            f"{equal[1]}")
        if not all(equal):
            raise AssertionError("the native loader and the plain decoder disagree")
    log(f"  host decode rate (rgb + depth, 640x480): " + " ".join(f"{k}={v:.2f}" for k, v in rates.items()))

    rgb, depth = plain
    gray = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]).astype(np.float32)
    transfer = prefetch.PinnedTransfer(device, 4)
    t0 = time.perf_counter()
    n_chunks = 0
    for k, chunk in enumerate(prefetch.frame_chunks(*files, chunk=TUM_CHUNK, device=device, transfer=transfer,
                                                    **geometry)):
        lo = k * TUM_CHUNK
        count = min(TUM_CHUNK, MAIN_FRAMES - lo)
        idx = [min(lo + i, lo + count - 1) for i in range(TUM_CHUNK)]  # the padded tail repeats its last frame
        if int(chunk["count"]) != count or chunk["gray"].device.type != device:
            raise AssertionError(f"chunk {k}: count {int(chunk['count'])}, device {chunk['gray'].device}")
        for key, host in (("gray", gray), ("depth", depth)):
            if not bits_equal(chunk[key].cpu().numpy(), host[idx]):
                raise AssertionError(f"prefetched chunk {k} {key} differs from the host arrays")
        n_chunks += 1
    t_stream = time.perf_counter() - t0
    pinned = 2 * n_chunks if device == "cuda" else 0
    log(f"  frame_chunks(chunk={TUM_CHUNK}) to {device}: {n_chunks} chunks equal to the host arrays, "
        f"{transfer.pinned_copies} arrays copied from pinned buffers (expected {pinned}), "
        f"{MAIN_FRAMES / t_stream:.2f} frames/s decoded and streamed")
    if n_chunks != -(-MAIN_FRAMES // TUM_CHUNK) or transfer.pinned_copies != pinned:
        raise AssertionError("frame_chunks did not stream every chunk from pinned buffers")
    return {"env": env, "decoder": decoder, "rates": rates, "frames": (gray, depth, cam)}


def suite_figures(r: dict) -> dict:
    rep, dq, tr = r["repeatability"], r["descriptor_quality"], r["tracking"]
    return {"repeatability_1": rep[0]["mean_repeatability"], "repeatability_5": rep[1]["mean_repeatability"],
            "inlier_ratio": dq["inlier_ratio"], "precision": dq["precision"],
            "tracking_1": tr[0]["success_rate"], "tracking_5": tr[1]["success_rate"]}


def run_suite(run_tests_cli, tmp, argv, label: str, reference: dict, card: str) -> dict:
    """``run-tests`` on the card; its figures within SUITE_MARGIN of the
    JAX package's; the performance test printed."""
    out = os.path.join(tmp, f"{label}.json")
    t0 = time.perf_counter()
    rc = run_tests_cli.main(argv + ["--device", "cuda", "--output", out])
    wall = time.perf_counter() - t0
    with open(out) as f:
        (name, r), = json.load(f).items()
    got = suite_figures(r)
    diff = {k: got[k] - reference[k] for k in reference}
    perf = r["performance"]
    stages = {k: round(v["mean_ms"], 4) for k, v in perf["stages"].items()}
    log(f"  run-tests {label} on {name}: exit {rc} (0 only if every test passes) all_passed={r['all_passed']} "
        f"wall_s={wall:.2f}; figures " + " ".join(f"{k}={v:.6f}" for k, v in got.items())
        + "; minus JAX's " + " ".join(f"{k}={v:+.6f}" for k, v in diff.items())
        + f" (bound +-{SUITE_MARGIN})")
    log(f"  run-tests {label} performance on {card}: stage ms per call {stages} fps={perf['fps']:.2f} "
        f"(batch {perf['batch']}, marginal time between 4 and 10 back-to-back calls, CUDA events)")
    if not all(abs(d) <= SUITE_MARGIN for d in diff.values()):
        raise AssertionError(f"run-tests {label}: figures differ from the JAX package's by more than "
                             f"{SUITE_MARGIN}: {diff}")
    return r


def derive_config(kind: str, save_dir: str, out: str) -> str:
    """Write the YAML a training phase runs: ``resume`` (phase 21) and
    ``init`` (22, validation every epoch) cut configs/train_tiny_synthetic.yaml's
    data to 17 frames of one world (2 steps an epoch), ``vits`` (23) cuts
    configs/train_vits_synthetic_long.yaml's to VITS_FRAMES of one world (1
    step); widths, losses and optimiser stay. Returns ``out``."""
    import yaml

    from semantic_slam_master_tpu_torch.train import config as config_mod

    if kind == "vits":
        src, frames = LEARNED_CONFIG, VITS_FRAMES
    elif kind in ("resume", "init"):
        src, frames = TINY_CONFIG, 17
    else:
        raise ValueError(f"unknown config kind {kind!r}")
    over = {"dataset": {"synthetic_frames": frames, "synthetic_worlds": 1}, "training": {"save_dir": save_dir}}
    if kind == "init":
        over["training"]["val_interval"] = 1
    cfg = config_mod.load_config(src, over)
    with open(out, "w") as f:
        f.write(yaml.safe_dump(config_mod.to_dict(cfg), sort_keys=True))
    return out


def forward_figures(bundle, metrics) -> dict:
    """A ``_forward_pair`` result as floats: the loss, its components and the metrics."""
    return {"loss": float(bundle.total), **{k: float(v) for k, v in bundle.components.items()},
            **{k: float(v) for k, v in metrics.items()}}


def figure_gap(got: dict, want: dict) -> tuple:
    """Largest |got - want| / (|want| + 0.01) over ``want``'s figures, and its key."""
    return max((abs(got[k] - v) / (abs(v) + 0.01), k) for k, v in want.items())


def read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def train_phase_launches(counts: dict, steps: int, name: str) -> None:
    """gather_patches launches twice per train or eval step (one refine_at
    per frame of the pair) and nothing else launches in training."""
    want = {"fast_score": 0, "gather_aligned_patches": 0, "gather_patches": 2 * steps, "pnp_refine": 0,
            "ransac": 0}
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, expected {want}")


def train_vits(torch, train_cli, trainer, config_mod, tmp, reset_counts, read_counts) -> dict:
    """Phase 23: the full-width ViT-S/16 recipe on the card, data cut to
    one step an epoch; its first step's figures against the port's forward
    on the CPU from the same seeded weights and batch."""
    cfg_path = derive_config("vits", os.path.join(tmp, "vits"), os.path.join(tmp, "vits.yaml"))
    cfg = config_mod.load_config(cfg_path)
    cfg.training.epochs = VITS_EPOCHS
    cpu_model, _ = trainer.create_train_state(cfg, 16, device="cpu")
    abs_sum = sum(float(v.double().abs().sum()) for v in cpu_model.state_dict().values())
    log(f"  seeded weights (training.seed {cfg.training.seed}): sum |w| = {abs_sum!r} (expected "
        f"{VITS_WEIGHT_ABS_SUM!r}, PyTorch 2.13 on the CPU)")
    if abs(abs_sum - VITS_WEIGHT_ABS_SUM) > 1e-6 * VITS_WEIGHT_ABS_SUM:
        raise AssertionError("the seeded ViT-S/16 weights differ from the recorded ones: a PyTorch RNG change")
    t0 = time.perf_counter()
    batches = train_cli._synthetic_pair_batches(cfg, split_seed=0)
    render_s = time.perf_counter() - t0
    records, step_s = [], []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer.fit(cfg, batches, None, steps_per_epoch=16, log_fn=records.append, device="cuda", step_times=step_s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    train_phase_launches(counts, VITS_EPOCHS, "ViT-S/16 training")
    for r in records:
        bad = [k for k, v in r.items() if isinstance(v, float) and not np.isfinite(v)]
        if r["skipped"] != 0.0 or bad or "hard" not in r:
            raise AssertionError(f"ViT-S/16 epoch {r['epoch']}: skipped={r['skipped']} non-finite={bad} "
                                 f"hard present={'hard' in r}")
    # The first step's forward (the seeded weights, the first batch's first
    # VITS_CPU_PAIRS pairs) on the card and on the host's CPU, bf16 both.
    half = {k: v[:VITS_CPU_PAIRS] for k, v in next(iter(batches(1))).items()}
    figs, secs = {}, {}
    for device, model in (("cpu", cpu_model), ("cuda", copy.deepcopy(cpu_model).to("cuda"))):
        t0 = time.perf_counter()
        b = trainer.to_device(half, device)
        with torch.no_grad():
            bundle, metrics = trainer._forward_pair(model, b["rgb1"], b["rgb2"], cfg, b)
        figs[device] = forward_figures(bundle, metrics)
        secs[device] = time.perf_counter() - t0
    gap, key = figure_gap(figs["cuda"], figs["cpu"])
    log(f"  first step's forward on {VITS_CPU_PAIRS} pairs, card against the host CPU (same seeded weights, "
        f"bf16 both): largest gap {gap:.4g} at {key} (bound {RESUME_GAP_BOUND:.4g}); CPU {secs['cpu']:.1f} s, "
        f"card {secs['cuda']:.2f} s; card {figs['cuda']}")
    if not gap <= RESUME_GAP_BOUND:
        raise AssertionError(f"ViT-S/16 first forward: {key} card {figs['cuda'][key]} vs CPU {figs['cpu'][key]}")
    return {"records": records, "step_s": step_s, "wall_s": wall, "peak_bytes": peak, "counts": counts,
            "render_s": render_s, "gap": gap, "split_ms": vits_step_split(torch, trainer, cfg, next(iter(batches(1))))}


def vits_step_split(torch, trainer, cfg, batch, repeats: int = 3) -> dict:
    """Where a warm ViT-S/16 train step's time goes: the forward pair, the
    backward (``autograd.grad``) and the optimiser update with its two host
    syncs, each between CUDA events, median of ``repeats`` steps on a
    fresh seeded state (after one warm-up step)."""
    model, state = trainer.create_train_state(cfg, 16, device="cuda")
    tx = trainer.build_optimizer(cfg, 16, trainer.flax_order(state.trainable))
    b = trainer.to_device(batch, "cuda")
    state, _ = trainer.make_train_step(model, cfg, tx)(state, b)
    names = list(state.trainable)
    rows = []
    for _ in range(repeats):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        ev[0].record()
        with torch.enable_grad():
            bundle, _ = trainer._forward_pair(model, b["rgb1"], b["rgb2"], cfg, b)
            ev[1].record()
            grads = torch.autograd.grad(bundle.total, [state.trainable[k] for k in names], allow_unused=True)
        ev[2].record()
        grads = {k: torch.zeros_like(state.trainable[k]) if g is None else g for k, g in zip(names, grads)}
        tx.update(grads, state.opt_state, state.trainable)
        ev[3].record()
        torch.cuda.synchronize()
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    med = sorted(rows, key=lambda r: sum(r))[len(rows) // 2]
    return {"forward": med[0], "backward": med[1], "optimizer": med[2]}


def training_phases(torch, run_slam_cli, evaluate_cli, config_mod, record, reset_counts, read_counts, card) -> None:
    """Phases 21-24 (the module docstring): train, resume, checkpoint and
    segmenter training on the card."""
    from semantic_slam_master_tpu_torch.cli import train_cli, train_segmenter_cli
    from semantic_slam_master_tpu_torch.train import trainer

    with phase("21. resume the trained tiny frontend: train --resume weights/frontend_tiny_state.npz --epochs 67"), \
            tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg_path = derive_config("resume", os.path.join(tmp, "save"), os.path.join(tmp, "resume.yaml"))
        log_path = os.path.join(tmp, "resume.jsonl")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        train_cli.main(["--config", cfg_path, "--resume", TINY_STATE, "--epochs", "67", "--jsonl-log", log_path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        rows = read_jsonl(log_path)
        train_phase_launches(counts, 4, "resumed tiny training")
        record("train_resume_tiny", counts, {"gather_patches": 8})
        if [r["epoch"] for r in rows] != [66, 67]:
            raise AssertionError(f"resume ran epochs {[r['epoch'] for r in rows]}, expected 66 and 67")
        for r in rows:
            gap, key = figure_gap(r, RESUME_JAX[r["epoch"]])
            log(f"  epoch {r['epoch']}: loss={r['loss']:.6f} (JAX {RESUME_JAX[r['epoch']]['loss']:.6f}) "
                f"largest gap {gap:.4g} at {key} (bound {RESUME_GAP_BOUND:.4g} = 2 x the CPU tests' bf16 gap "
                f"{RESUME_GAP_CPU_TEST}; this YAML's CPU gap {RESUME_GAP_CPU_PHASE}) figures={r}")
            if not gap <= RESUME_GAP_BOUND or r["skipped"] != 0.0:
                raise AssertionError(f"resumed epoch {r['epoch']}: {key} {r[key]} vs JAX "
                                     f"{RESUME_JAX[r['epoch']][key]}, skipped {r['skipped']}")
        log(f"  4 steps (224 px, 8 pairs, 4-layer 128-wide ViT, 192 keypoints) wall {wall:.2f} s (host clock, "
            f"data render and first-call warm-up included), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")

    with phase("22. train --init-from weights/frontend_tiny.npz (1 epoch, val) then run-slam --checkpoint best_model"), \
            tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        save = os.path.join(tmp, "save")
        cfg_path = derive_config("init", save, os.path.join(tmp, "init.yaml"))
        reset_counts()
        train_cli.main(["--config", cfg_path, "--init-from", TINY_WEIGHTS, "--epochs", "1"])
        counts = read_counts()
        train_phase_launches(counts, 4, "tiny training with validation")
        record("train_init_tiny", counts, {"gather_patches": 8})
        ckpt = os.path.join(save, "best_model.npz")
        with open(os.path.join(save, "best_model.meta.json")) as f:
            meta = json.load(f)
        with np.load(ckpt) as z:
            keys = len(z.files)
        log(f"  wrote {ckpt}: {os.path.getsize(ckpt)} bytes, {keys} arrays, meta {meta}")
        reset_counts()
        run, res = run_cli_path(torch, run_slam_cli, evaluate_cli, os.path.join(tmp, "slam"), [
            "--synthetic", "--synthetic-frames", str(MAIN_FRAMES), "--frontend", "learned",
            "--train-config", TINY_CONFIG, "--checkpoint", ckpt])
        counts = read_counts()
        ate = res["ate"]["rmse"]
        chunks = -(-MAIN_FRAMES // run_slam_cli.LEARNED_CHUNK)
        record("learned_tiny_trained_here", counts, {"gather_patches": chunks})
        log(f"  run-slam with the card-written checkpoint: ate_rmse_m={ate:.6f} (bound < {TINY_ATE_BOUND_M:.6f}) "
            f"fps={run['fps']} launches={counts}")
        if not (run["finite_poses"] and ate == ate and ate < TINY_ATE_BOUND_M):
            raise AssertionError(f"checkpoint written by train: ATE {ate} m not below {TINY_ATE_BOUND_M} m")

    with phase(f"23. ViT-S/16 at full width: {VITS_EPOCHS} epochs of one step (8 pairs at 448 px)"), \
            tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        vits = train_vits(torch, train_cli, trainer, config_mod, tmp, reset_counts, read_counts)
        record("train_vits", vits["counts"], {"gather_patches": 2 * VITS_EPOCHS})
        for r in vits["records"]:
            log(f"  epoch {r['epoch']}: loss={r['loss']:.6f} desc={r['desc']:.6f} hard={r['hard']:.6f} "
                f"localization={r.get('localization', 0.0):.6f} skipped={r['skipped']} figures={r}")
        log("  warm train step split, ms (CUDA events, median of 3): "
            + " ".join(f"{k}={v:.2f}" for k, v in vits["split_ms"].items()))
        log(f"  train step s (CUDA events, data on the card): {[round(x, 4) for x in vits['step_s']]}; "
            f"peak torch.cuda.max_memory_allocated {vits['peak_bytes']} bytes "
            f"({vits['peak_bytes'] / 2**30:.2f} GiB); fit wall {vits['wall_s']:.2f} s; render "
            f"{vits['render_s']:.2f} s ({card})")

    with phase(f"24. train-segmenter --steps {SEG_TRAIN_STEPS} (120x160, width 32, seed 0), then run-slam "
               f"--dynamic --seed {DYNAMIC_SEED} --semantics model"), \
            tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            train_segmenter_cli.main(["--steps", str(SEG_TRAIN_STEPS), "--height", "120", "--width", "160",
                                      "--model-width", "32", "--seed", "0", "--output", os.path.join(tmp, "seg")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        text = buf.getvalue()
        log("  " + text.strip().replace("\n", "\n  "))
        m = re.search(r"final loss=([0-9.]+), acc=([0-9.]+)", text)
        loss, acc = float(m.group(1)), float(m.group(2))
        counts = read_counts()
        if any(counts.values()):
            raise AssertionError(f"segmenter training launched {counts}")
        log(f"  final loss {loss} (bound <= {SEG_TRAIN_LOSS_MAX:.4f}; JAX seeds 0-3 {SEG_TRAIN_JAX_LOSS}) accuracy "
            f"{acc} (bound >= {SEG_TRAIN_ACC_MIN:.4f}; JAX {SEG_TRAIN_JAX_ACC}); {SEG_TRAIN_STEPS} steps in "
            f"{wall:.2f} s host clock, render included ({card})")
        if not (loss <= SEG_TRAIN_LOSS_MAX and acc >= SEG_TRAIN_ACC_MIN):
            raise AssertionError(f"segmenter trained on the card: loss {loss}, accuracy {acc} outside the band")
        reset_counts()
        run, res = run_cli_path(torch, run_slam_cli, evaluate_cli, os.path.join(tmp, "slam"), [
            "--synthetic", "--synthetic-frames", str(MAIN_FRAMES), "--dynamic", "--semantics", "model",
            "--segmenter-checkpoint", os.path.join(tmp, "seg.npz")], seed=DYNAMIC_SEED)
        counts = read_counts()
        ate = res["ate"]["rmse"]
        chunks = -(-MAIN_FRAMES // run_slam_cli.FRONTEND_CHUNK)
        record("dynamic_model_trained_here", counts, {"fast_score": 4 * chunks, "gather_aligned_patches": 4 * chunks})
        log(f"  run-slam --semantics model with it: ate_rmse_m={ate:.6f} (bound < {SEG_TRAIN_ATE_BOUND_M:.6f} = "
            f"2 x the worst JAX seed; JAX seeds 0-3 {SEG_TRAIN_JAX_ATE_M}; the committed segmenter's bound "
            f"{SEG_MODEL_ATE_BOUND_M:.6f}) launches={counts}")
        if not (ate == ate and ate < SEG_TRAIN_ATE_BOUND_M):
            raise AssertionError(f"card-trained segmenter: ATE {ate} m not below {SEG_TRAIN_ATE_BOUND_M} m")


def warm_start_phase(torch, record, reset_counts, read_counts, card) -> None:
    """Phase 32 (the module docstring): the stage-2 recipe's warm start
    from the trained ViT-S/16 through the ``train`` CLI, then the first
    step's forward on VITS_CPU_PAIRS pairs from the loaded weights against
    the JAX package's, and one warm step timed."""
    from semantic_slam_master_tpu_torch.cli import train_cli
    from semantic_slam_master_tpu_torch.train import config as config_mod
    from semantic_slam_master_tpu_torch.train import trainer

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg_path = derive_config("vits", os.path.join(tmp, "save"), os.path.join(tmp, "warm.yaml"))
        log_path = os.path.join(tmp, "warm.jsonl")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        train_cli.main(["--config", cfg_path, "--init-from", VITS_WEIGHTS, "--epochs", "1", "--jsonl-log", log_path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        train_phase_launches(counts, 1, "ViT-S/16 warm start")
        record("train_warm_vits", counts, {"gather_patches": 2})
        rows = read_jsonl(log_path)
        cfg = config_mod.load_config(cfg_path)
    if [r["epoch"] for r in rows] != [1]:
        raise AssertionError(f"warm start logged {rows}, expected one train epoch")
    r = rows[0]
    bad = [k for k, v in r.items() if isinstance(v, float) and not np.isfinite(v)]
    log(f"  step 1 from {VITS_WEIGHTS}: figures={r}")
    if r["skipped"] != 0.0 or bad or "hard" not in r:
        raise AssertionError(f"warm start: skipped={r['skipped']} non-finite={bad} hard present={'hard' in r}")

    model, state = trainer.create_train_state(cfg, 16, device="cuda")
    trainer.restore_checkpoint(VITS_WEIGHTS, model, state)
    batch = next(iter(train_cli._synthetic_pair_batches(cfg, split_seed=0)(1)))
    b = trainer.to_device({k: v[:VITS_CPU_PAIRS] for k, v in batch.items()}, "cuda")
    with torch.no_grad():
        bundle, metrics = trainer._forward_pair(model, b["rgb1"], b["rgb2"], cfg, b)
    figs = forward_figures(bundle, metrics)
    gap, key = figure_gap(figs, VITS_WARM_JAX)
    log(f"  first step's forward on {VITS_CPU_PAIRS} pairs from {VITS_WEIGHTS}, card against the JAX package "
        f"(bf16 both): largest gap {gap:.4g} at {key} (bound {RESUME_GAP_BOUND:.4g}); card {figs}")
    if not gap <= RESUME_GAP_BOUND:
        raise AssertionError(f"warm-start forward: {key} card {figs[key]} vs JAX {VITS_WARM_JAX[key]}")
    # One warm train step of the whole batch from those weights (the
    # CLI's first step also built and warmed the kernels).
    tx = trainer.build_optimizer(cfg, 16, trainer.flax_order(state.trainable))
    step = trainer.make_train_step(model, cfg, tx)
    b = trainer.to_device(batch, "cuda")
    step_ms = []
    for _ in range(2):
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        state, _ = step(state, b)
        ev[1].record()
        torch.cuda.synchronize()
        step_ms.append(ev[0].elapsed_time(ev[1]))
    log(f"  train --init-from wall {wall:.2f} s (host clock: render of the train and val sets, model build, "
        f"load and the step); peak torch.cuda.max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB); "
        f"steps from the trained weights {[round(x, 2) for x in step_ms]} ms (CUDA events, 8 pairs) ({card})")


def coincide_share(torch, xy_a, xy_b, valid) -> float:
    """Share of valid keypoint slots that hold the same detection within
    1e-3 px in two (..., N, 2) sets."""
    same = (xy_a - xy_b).abs().amax(-1) <= 1e-3
    return float(same[valid].float().mean())


def shared_points(a, b) -> tuple:
    """(distinct points of ``a`` also in ``b``, distinct points of ``b``):
    a fixed-K set repeats its best point in unused slots."""
    sa, sb = set(map(tuple, a.tolist())), set(map(tuple, b.tolist()))
    return len(sa & sb), len(sb)


def cli_tool_phases(torch, synthetic, tracking, record, reset_counts, read_counts, card, path_frames) -> None:
    """Phases 25-29 (the module docstring): the ORB gather path, the small
    pyramid levels, and the bench, visualize and check-setup commands."""
    from semantic_slam_master_tpu_torch import convert
    from semantic_slam_master_tpu_torch.cli import bench_cli, check_setup_cli, visualize_cli
    from semantic_slam_master_tpu_torch.models.frontend import LearnedFrontend
    from semantic_slam_master_tpu_torch.ops import orb
    from semantic_slam_master_tpu_torch.ops.kernels import gather_patches as kgather
    from semantic_slam_master_tpu_torch.ops.kernels import patches as kpatch

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    with phase("25. ORB windows at radius 15: orb.orientations and describe_from_patches, card vs cpu"):
        blurred, xy = path_frames
        quantised = kpatch.quantize_u8(blurred)
        reset_counts()
        theta = orb.orientations(quantised, xy)
        desc = orb.describe_from_patches(kgather.gather_patches(blurred, xy, orb.PATCH_RADIUS))
        torch.cuda.synchronize()
        counts = read_counts()
        b_cpu, xy_cpu = blurred.cpu(), xy.cpu()
        theta_cpu = orb.orientations(quantised.cpu(), xy_cpu)
        desc_cpu = orb.describe_from_patches(kgather.gather_patches(b_cpu, xy_cpu, orb.PATCH_RADIUS))
        gap = float((theta.cpu() - theta_cpu).abs().max())
        same = bool(torch.equal(desc.cpu(), desc_cpu))
        log(f"  {tuple(blurred.shape)} with {xy.shape[1]} keypoints a frame: orientation gap {gap:.3e} rad "
            f"(bound 1e-6), descriptors equal {same}, launches={counts}")
        if gap > 1e-6 or not same:
            raise AssertionError("the radius-15 ORB windows on the card disagree with the CPU")
        record("orb_radius15", counts, {"gather_patches": 2})

    with phase("26. describe on small pyramid levels: extract_features (4, 48, 64) and describe, card vs cpu"):
        gen = torch.Generator().manual_seed(SEED)
        g = torch.nn.functional.interpolate(torch.rand((4, 1, 7, 9), generator=gen), size=(48, 64),
                                            mode="bilinear")[:, 0].contiguous()
        d = torch.ones_like(g)
        reset_counts()
        gpu = tracking.extract_features(g.cuda(), d.cuda(), num_keypoints=64)
        torch.cuda.synchronize()
        counts = read_counts()
        ref = tracking.extract_features(g, d, num_keypoints=64)
        share = coincide_share(torch, gpu.xy.cpu(), ref.xy, ref.valid)
        same_desc = float((gpu.desc.cpu() == ref.desc).all(-1)[ref.valid].float().mean())
        levels = tracking.pyramid_shapes(48, 64, 4)
        log(f"  extract_features (4, 48, 64), levels {levels}: keypoints coincide {share:.4f}, descriptors "
            f"identical {same_desc:.4f}, valid {int(ref.valid.sum())}/{ref.valid.numel()}, launches={counts}")
        if share < 0.98 or same_desc < 0.99:
            raise AssertionError("extract_features on small frames: card disagrees with the CPU")
        record("small_levels", counts, {"fast_score": 4, "gather_aligned_patches": 2})
        for H, W in SMALL_LEVEL_SIZES:
            img = torch.rand((4, H, W), generator=gen)
            pts = torch.rand((4, 64, 2), generator=gen) * torch.tensor([W + 10.0, H + 10.0]) - 5.0
            before = read_counts()["gather_aligned_patches"]
            got = orb.describe(img.cuda(), pts.cuda()).cpu()
            launched = read_counts()["gather_aligned_patches"] - before
            want = orb.describe(img, pts)
            same = float((got == want).all(-1).float().mean())
            aligned = int((H >= 32 and W >= 33) or (W % 32 == 0 and W >= 64))
            log(f"  describe ({H}, {W}): identical {same:.4f} (bound >= {DESCRIBE_SAME_MIN}), aligned kernel "
                f"launches {launched} (expected {aligned})")
            if same < DESCRIBE_SAME_MIN or launched != aligned:
                raise AssertionError(f"describe at ({H}, {W}) on the card disagrees with the CPU")

    with phase("27. bench --frontend orb and --frontend learned (ViT-S/16 at 448) on the card"), \
            tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for frontend in ("orb", "learned"):
            out = os.path.join(tmp, f"{frontend}.json")
            reset_counts()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = bench_cli.main(["--frontend", frontend, "--output", out])
            counts = read_counts()
            with open(out) as f:
                r = json.load(f)
            stages = {k: round(v["mean_ms"], 4) for k, v in r["stages"].items()}
            log(f"  bench --frontend {frontend} on {r['card']} ({r['device']}): exit {rc}, batch {r['batch']}, "
                f"stage ms per batch {stages}, fps={r['fps']:.2f}, launches={counts}")
            if rc != 0 or r["card"] != card or not r["fps"] > 0:
                raise AssertionError(f"bench --frontend {frontend}: {r}")
            if frontend == "orb":
                record("bench_orb", counts, {"fast_score": 1, "gather_aligned_patches": 1})

    plotting = importlib.util.find_spec("matplotlib") is not None
    with phase("28. visualize: saliency (ORB and --checkpoint), matches, sequence; device half card vs cpu"), \
            tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        seq = synthetic.make_sequence(num_frames=6, scale=0.5)
        frames = [seq.frame(i)["rgb"].astype(np.float32) for i in range(6)]
        reset_counts()
        sal, kpts = visualize_cli.saliency_map(frames[0], cuda)
        counts = read_counts()
        sal_cpu, kpts_cpu = visualize_cli.saliency_map(frames[0], cpu)
        n_same, n_cpu = shared_points(kpts, kpts_cpu)
        log(f"  saliency (FAST pooled to 16 px): max gap {np.abs(sal - sal_cpu).max():.3e}, keypoints "
            f"{len(kpts)} card / {len(kpts_cpu)} cpu, {n_same} shared, launches={counts}")
        if np.abs(sal - sal_cpu).max() > 0.02 or n_same < 0.98 * n_cpu:
            raise AssertionError("visualize saliency: card disagrees with the CPU")
        record("visualize_saliency", counts, {"fast_score": 2})

        ckpt = os.path.join(tmp, "vits_seeded.npz")
        vits = LearnedFrontend(generator=torch.Generator().manual_seed(SEED))
        convert.save_npz(ckpt, convert.frontend_tree(vits.state_dict()))
        del vits
        sal, kpts = visualize_cli.saliency_map(frames[0], cuda, ckpt)
        sal_cpu, kpts_cpu = visualize_cli.saliency_map(frames[0], cpu, ckpt)
        n_same, n_cpu = shared_points(kpts, kpts_cpu)
        log(f"  saliency --checkpoint (seeded ViT-S/16, {os.path.getsize(ckpt)} B .npz): saliency {sal.shape}, "
            f"max gap {np.abs(sal - sal_cpu).max():.3e} (bound {VIT_SALIENCY_GAP}), distinct keypoints shared "
            f"{n_same}/{n_cpu} (bound >= 90%)")
        if np.abs(sal - sal_cpu).max() > VIT_SALIENCY_GAP or n_same < 0.9 * n_cpu:
            raise AssertionError("visualize saliency --checkpoint: card disagrees with the CPU")

        pairs = [(0, 1)] + [(0, s) for s in (2, 5)]
        reset_counts()
        match = visualize_cli.orb_extract_and_match(cuda)
        got = [match(frames[a], frames[b]) for a, b in pairs]
        counts = read_counts()
        match_cpu = visualize_cli.orb_extract_and_match(cpu)
        for (a, b), (k1, _, m, _) in zip(pairs, got):
            r1, _, rm, _ = match_cpu(frames[a], frames[b])
            share = coincide_share(torch, torch.from_numpy(k1), torch.from_numpy(r1), torch.ones(len(r1), dtype=bool))
            log(f"  matches frames {a}->{b}: {len(m)} card / {len(rm)} cpu, keypoints coincide {share:.4f}")
            if share < 0.98 or abs(len(m) - len(rm)) > 0.02 * len(rm) + 2:
                raise AssertionError(f"visualize matches {a}->{b}: card disagrees with the CPU")
        log(f"  launches={counts}")
        record("visualize_matches", counts, {"fast_score": len(pairs), "gather_aligned_patches": len(pairs)})

        if not plotting:
            log("  no PNG drawn: matplotlib is not installed on this machine (the device halves above ran)")
        else:
            for mode, extra, png in (("saliency", [], "saliency_analysis.png"),
                                     ("saliency", ["--checkpoint", ckpt], "saliency_analysis.png"),
                                     ("matches", [], "matches.png"),
                                     ("sequence", ["--spacings", "1", "2", "5"], "matches_sequence.png")):
                out_dir = os.path.join(tmp, f"{mode}{len(extra)}")
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()) as buf:
                    rc = visualize_cli.main([mode, "--synthetic", "--frames", "6", "--output", out_dir, *extra])
                size = os.path.getsize(os.path.join(out_dir, png))
                log(f"  visualize {mode} {' '.join(extra[:1])}: exit {rc}, {png} {size} B, "
                    f"{time.perf_counter() - t0:.2f} s; {buf.getvalue().strip().splitlines()[0]}")
                if rc != 0 or size == 0:
                    raise AssertionError(f"visualize {mode} wrote no plot")

    with phase("29. check-setup on the card"):
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            rc = check_setup_cli.main([])
        lines = buf.getvalue().strip().splitlines()
        log("  " + " | ".join(line.strip() for line in lines if "accelerator" in line or "[ok] torch" in line
                                or line in ("PASS", "FAIL")))
        if rc != 0:
            raise AssertionError(f"check-setup exited {rc}: {lines}")


def sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def kernel_counts() -> tuple:
    """(reset, read) of the five kernel wrappers' launch counts."""
    from semantic_slam_master_tpu_torch.ops.kernels import fast_score as kfast
    from semantic_slam_master_tpu_torch.ops.kernels import gather_patches as kgather
    from semantic_slam_master_tpu_torch.ops.kernels import patches as kpatch
    from semantic_slam_master_tpu_torch.ops.kernels import pnp_refine as kref
    from semantic_slam_master_tpu_torch.ops.kernels import ransac as kransac

    counters = {"fast_score": kfast.fast_score, "gather_aligned_patches": kpatch.gather_aligned_patches,
                "gather_patches": kgather.gather_patches, "pnp_refine": kref.pnp_refine,
                "ransac": kransac.ransac}

    def reset_counts():
        for c in (*counters.values(), kgather.gather_patches_padded):
            c.launches = 0

    def read_counts():
        return {name: c.launches for name, c in counters.items()}

    return reset_counts, read_counts


def fleet_phase(torch, frames, record, reset_counts, read_counts, card, device: str = "cuda") -> None:
    """Phase 30 (the module docstring): the fleet of FLEET_SEQUENCES disjoint
    sequences cut from the ORB path's frames, on the card and the CPU."""
    from semantic_slam_master_tpu_torch.cli import run_slam_cli
    from semantic_slam_master_tpu_torch.core import prng
    from semantic_slam_master_tpu_torch.slam import parallel as fleet, system, tracking

    gray, depth, cam = frames
    S = FLEET_SEQUENCES
    F = len(gray) // S
    reset_counts()
    t0 = time.perf_counter()
    feats = run_slam_cli.features_for_frames(gray, depth, 512, torch.device(device))
    seqs = tracking.FrameFeatures(*[x[: S * F].reshape(S, F, *x.shape[1:]) for x in feats])
    sync(torch, device)
    frontend_s = time.perf_counter() - t0
    keys = prng.split(prng.PRNGKey(SEED), S)
    cfg = system.SlamConfig()
    t0 = time.perf_counter()
    out = fleet.run_slam_fleet(keys, seqs, cam, cfg)
    sync(torch, device)
    fleet_s = time.perf_counter() - t0
    counts = read_counts()
    chunks = -(-len(gray) // run_slam_cli.FRONTEND_CHUNK)
    record("fleet", counts, {"fast_score": 4 * chunks, "gather_aligned_patches": 4 * chunks, "pnp_refine": S * (F - 1),
                             "ransac": S * (F - 1)})
    if out.poses_wc.shape != (S, F, 4, 4) or not bool(torch.isfinite(out.poses_wc).all()):
        raise AssertionError(f"fleet poses {tuple(out.poses_wc.shape)}, finite {bool(torch.isfinite(out.poses_wc).all())}")
    runs = []
    for _ in range(2):  # each sequence's own run_slam on the card, twice
        runs.append([system.run_slam(torch.from_numpy(prng.key_slam_uniforms(keys[s], F, cfg.num_hypotheses)).to(device),
                                     tracking.FrameFeatures(*[x[s] for x in seqs]), cam, cfg).poses_wc.cpu().numpy()
                     for s in range(S)])
    poses = out.poses_wc.cpu().numpy()
    gap = max(float(np.abs(poses[s] - runs[0][s]).max()) for s in range(S))
    run_gap = max(float(np.abs(runs[1][s] - runs[0][s]).max()) for s in range(S))
    t0 = time.perf_counter()
    cpu = fleet.run_slam_fleet(keys, tracking.FrameFeatures(*[x.cpu() for x in seqs]), cam, cfg)
    cpu_s = time.perf_counter() - t0
    agree = np.array([poses_agree(poses[s][f:f + 1], cpu.poses_wc[s][f:f + 1].numpy())
                      for s in range(S) for f in range(F)])
    dt, dr = agree.max(0)
    misses = int(((agree[:, 0] > FLEET_POSE_TOL[0]) | (agree[:, 1] > FLEET_POSE_TOL[1])).sum())
    same = {name: bool(torch.equal(getattr(out, name).cpu(), getattr(cpu, name)))
            for name in ("num_matches", "is_keyframe")}
    inlier_gap = int((out.num_inliers.cpu() - cpu.num_inliers).abs().max())
    log(f"  {S} sequences of {F} frames (the TUM phase's 60 decoded frames of the ORB path's world), SlamConfig() "
        f"({cfg.num_landmarks} landmark slots): fleet {fleet_s:.2f} s on the card (frontend {frontend_s:.2f} s), "
        f"CPU fleet {cpu_s:.2f} s; keyframes {out.is_keyframe.sum(1).tolist()} inliers mean "
        f"{out.num_inliers.float().mean(1).tolist()}; launches {counts} ({card})")
    log(f"  fleet against each sequence's own run_slam on the card: max |pose difference| {gap!r} (two card runs "
        f"of run_slam: {run_gap!r}); card against the CPU fleet: equal {same}, inlier counts within "
        f"{inlier_gap}, poses within {dt:.3g} m, {dr:.3g} rad, {misses} of {S * F} frames beyond "
        f"{FLEET_POSE_TOL[0]} m / {FLEET_POSE_TOL[1]} rad (at most {FLEET_POSE_MISSES})")
    if not gap <= run_gap:
        raise AssertionError(f"the fleet's poses differ from each sequence's run_slam by {gap}, more than two runs "
                             f"of run_slam on the card ({run_gap})")
    if not (all(same.values()) and inlier_gap <= 1 and misses <= FLEET_POSE_MISSES):
        raise AssertionError(f"fleet card against CPU: equal {same}, inliers within {inlier_gap}, {misses} frames "
                             f"beyond the pose bounds (largest {dt} m, {dr} rad)")


def mesh_step(cfg, batch, mesh, device, reset_counts, read_counts, dtype: str = "bfloat16") -> dict:
    """One ViT-S/16 train step from the seeded weights: through the mesh
    code on ``mesh`` (the batch cut to this rank's slice), or without a
    mesh (``mesh`` None). Returns the step's figures, the full checkpoint
    arrays (moments, parameters, statistics), its device seconds, the peak
    memory and the kernel launches."""
    import torch

    from semantic_slam_master_tpu_torch.parallel import mesh as mesh_lib
    from semantic_slam_master_tpu_torch.train import trainer

    model, state = trainer.create_train_state(cfg, 16, device=device, dtype=getattr(torch, dtype))
    if mesh is None:
        tx = trainer.build_optimizer(cfg, 16, trainer.flax_order(state.trainable))
    else:
        tx = trainer.to_mesh(model, state, cfg, 16, mesh)
        batch = mesh_lib.shard_batch(mesh, batch)
    step = trainer.make_train_step(model, cfg, tx, mesh)
    b = trainer.to_device(batch, device)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    reset_counts()
    state, out = step(state, b)
    counts = read_counts()
    r = {"figures": {k: float(v) for k, v in out.items()}, "counts": counts,
         "step_s": None, "peak_bytes": None}
    if cuda:
        ev[1].record()
        torch.cuda.synchronize()
        r["step_s"] = ev[0].elapsed_time(ev[1]) / 1e3
        r["peak_bytes"] = torch.cuda.max_memory_allocated()
    r["tree"] = trainer.checkpoint_tree(model, state, mesh=mesh)
    return r


def tree_gaps(got: dict, want: dict) -> dict:
    """Largest |got - want| over each class of checkpoint arrays (Adam's
    moments, the parameters, the BatchNorm statistics), relative to the
    class's largest |want|."""
    out = {}
    for cls in ("opt_state/mu", "opt_state/nu", "params", "batch_stats"):
        keys = [k for k in want if k.startswith(cls + "/")]
        scale = max(float(np.abs(want[k]).max()) for k in keys)
        out[cls] = max(float(np.abs(got[k].astype(np.float64) - want[k]).max()) for k in keys) / scale
    return out


def mesh_rank(rank: int, port: int, cfg_path: str, batch_path: str, out_dir: str, device: str) -> None:
    """Phase 31: one of two gloo ranks on the one card, taking a step on each
    mesh of MESH_SHAPES at each of MESH_DTYPES in turn; writes
    ``rank<r>.pkl`` to ``out_dir``."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist

    from semantic_slam_master_tpu_torch.parallel import mesh as mesh_lib
    from semantic_slam_master_tpu_torch.train import config as config_mod

    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=MESH_COLLECTIVE_TIMEOUT_S))
    try:
        reset_counts, read_counts = kernel_counts()
        cfg = config_mod.load_config(cfg_path)
        with np.load(batch_path) as z:
            batch = {k: z[k] for k in z.files}
        results = {}
        for dtype in MESH_DTYPES:
            for shape in MESH_SHAPES:
                cfg.training.mesh_data, cfg.training.mesh_model = shape
                r = mesh_step(cfg, batch, mesh_lib.make_mesh(*shape), device, reset_counts, read_counts, dtype)
                if rank != 0:
                    del r["tree"]
                results[(dtype, *shape, "gloo", rank)] = r
                if device == "cuda":
                    torch.cuda.empty_cache()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_training_phase(torch, record, reset_counts, read_counts, card, device: str = "cuda") -> None:
    """Phase 31 (the module docstring): a ViT-S/16 step over a mesh, one
    NCCL rank and two gloo ranks on the one card, against the step without
    a mesh, at each of MESH_DTYPES."""
    import multiprocessing
    import pickle

    import torch.distributed as dist

    from semantic_slam_master_tpu_torch.cli import train_cli
    from semantic_slam_master_tpu_torch.parallel import mesh as mesh_lib
    from semantic_slam_master_tpu_torch.train import config as config_mod

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg_path = derive_config("vits", os.path.join(tmp, "save"), os.path.join(tmp, "vits.yaml"))
        cfg = config_mod.load_config(cfg_path)
        batch = next(iter(train_cli._synthetic_pair_batches(cfg, split_seed=0)(1)))
        batch_path = os.path.join(tmp, "batch.npz")
        np.savez(batch_path, **batch)
        refs, results = {}, {}
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1)
        try:
            for dtype in MESH_DTYPES:
                refs[dtype] = mesh_step(cfg, batch, None, device, reset_counts, read_counts, dtype)
                results[(dtype, 1, 1, "nccl", 0)] = mesh_step(cfg, batch, mesh_lib.make_mesh(1, 1), device,
                                                              reset_counts, read_counts, dtype)
        finally:
            dist.destroy_process_group()
        if device == "cuda":
            torch.cuda.empty_cache()
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        procs = [ctx.Process(target=mesh_rank, args=(r, port, cfg_path, batch_path, tmp, device)) for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(1.0, MESH_JOIN_TIMEOUT_S - (time.perf_counter() - t0)))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        if hung or any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"the two gloo ranks exited {[p.exitcode for p in procs]} "
                                 f"({len(hung)} killed after {MESH_JOIN_TIMEOUT_S} s)")
        log(f"  two gloo ranks on the card: {time.perf_counter() - t0:.2f} s for "
            f"{len(MESH_DTYPES) * len(MESH_SHAPES)} steps each, start-up and seeded inits included")
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.update(pickle.load(f))
        bound = MESH_GAP_FACTOR * RUN_GAP
        for (dtype, nd, nm, backend, r), res in results.items():
            name = f"train_mesh_{nd}x{nm}_{backend}_{dtype}_rank{r}"
            train_phase_launches(res["counts"], 1, name)
            record(name, res["counts"], {"gather_patches": 2})
            line = (f"  {dtype} {nd}x{nm} {backend} rank {r}: first step {res['step_s']} s (CUDA events), peak "
                    f"torch.cuda.max_memory_allocated {res['peak_bytes']} bytes ({card})")
            if "tree" in res:
                # 1x1 against the step without a mesh, the gloo ranks against 1x1
                ref, against = ((refs[dtype], "the step without a mesh") if backend == "nccl" else
                                (results[(dtype, 1, 1, "nccl", 0)], "1x1"))
                fig, key = figure_gap(res["figures"], ref["figures"])
                gaps = tree_gaps(res["tree"], ref["tree"])
                line += f"; against {against}: figures {fig!r} at {key}, arrays {gaps}"
                exact = dtype == "float32" or (nd, nm) == (1, 1)
                bad = {k: v for k, v in gaps.items() if not v <= bound} if exact else {}
                if res["figures"]["skipped"] != 0.0 or not fig <= (bound if exact else RESUME_GAP_BOUND) or bad:
                    raise AssertionError(f"{dtype} {nd}x{nm} {backend}: figures {fig} at {key}, arrays {gaps}")
            log(line)
        log(f"  bounds: at float32 (and 1x1 at bfloat16) every figure and array class within {bound:.6g} = "
            f"{MESH_GAP_FACTOR} x RUN_GAP; at bfloat16 the figures within {RESUME_GAP_BOUND:.4g}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU",
              file=sys.stderr)
        return 1
    from semantic_slam_master_tpu_torch.cli import evaluate_cli, run_slam_cli, run_tests_cli
    from semantic_slam_master_tpu_torch.data import native_io, prefetch, synthetic, tum
    from semantic_slam_master_tpu_torch.models import segmenter as seg_mod
    from semantic_slam_master_tpu_torch.models.selector import select_keypoints
    from semantic_slam_master_tpu_torch.ops.kernels import build
    from semantic_slam_master_tpu_torch.ops.kernels import fast_score as kfast
    from semantic_slam_master_tpu_torch.ops.kernels import gather_patches as kgather
    from semantic_slam_master_tpu_torch.ops import fast as fast_mod
    from semantic_slam_master_tpu_torch.ops import image
    from semantic_slam_master_tpu_torch.ops.kernels import patches as kpatch
    from semantic_slam_master_tpu_torch.core import prng
    from semantic_slam_master_tpu_torch.eval import ate_rpe
    from semantic_slam_master_tpu_torch.slam import loop_closing, online, system, tracking
    from semantic_slam_master_tpu_torch.train import config as config_mod

    reset_counts, read_counts = kernel_counts()

    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
        card = smi[0]
        log(card)
        kind = torch.cuda.get_device_name(0)
        log(f"  torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
            f"count {torch.cuda.device_count()} pyyaml "
            f"{'present' if importlib.util.find_spec('yaml') else 'absent'}")

    with phase("trained weights (export_weights.py)"):
        for path in (TINY_WEIGHTS, SEGMENTER_WEIGHTS, VITS_WEIGHTS):
            with np.load(path) as z:
                n, nbytes = len(z.files), sum(z[k].nbytes for k in z.files)
                dtypes = sorted({str(z[k].dtype) for k in z.files})
            log(f"  {path}: {os.path.getsize(path)} bytes on disk, {n} arrays, {nbytes} bytes of {dtypes}")
            if dtypes != ["float32"] or (path == VITS_WEIGHTS and n != VITS_ARRAYS):
                raise AssertionError(f"{path}: {n} arrays of {dtypes}, expected float32 only "
                                     f"({VITS_ARRAYS} arrays for {VITS_WEIGHTS})")
        log(f"  {VITS_WEIGHTS} form: every array float32 as restored from artifacts/frontend_vits "
            "(no leaf stored rounded to bf16)")

    with phase("build"):
        secs = build.build(force=True)
        build.library()
        log(f"  nvcc built {build.LIB_PATH.name} from {len(build.sources())} sources "
            f"in {secs:.2f} s")
        t0 = time.perf_counter()
        decoder = native_io.decoder()
        log(f"  native PNG loader (g++, {native_io.SOURCE.name}): {decoder} in {time.perf_counter() - t0:.2f} s")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    with phase("ORB path's kernel inputs (16 rendered frames, four pyramid levels)"):
        path = path_inputs(torch, synthetic, run_slam_cli.render_all, tracking, fast_mod, image)
    with phase("fast_score vs plain"):
        fast = check_fast(torch, kfast, gen, flush, path)
    with phase("gather_aligned_patches vs plain"):
        patches = check_patches(torch, kpatch, gen, flush, path)
    path_frames = path[0][1:]  # level 0 blurred, its detections (phase 25)
    del path
    with phase("gather_patches vs plain"):
        gather = check_gather(torch, kgather, gen, flush)
    del flush
    with phase("ORB frontend card vs cpu"):
        check_frontend(torch, tracking, synthetic, seg_mod)

    launches = {name: {} for name in read_counts()}

    def record(path: str, counts: dict, needed) -> None:
        """Keep one path's launch counts; fail if a kernel it runs (with
        the least launches it must make) stayed below that."""
        for name, least in needed.items():
            if counts[name] < least:
                raise AssertionError(f"{name} launched {counts[name]} times on the {path} path, "
                                     f"expected >= {least}")
            launches[name][path] = counts[name]

    with phase("ORB main path: run-slam --synthetic + evaluate"), \
            tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        reset_counts()
        with refine_inputs(torch) as refine_orb, ransac_inputs(torch) as ransac_orb:
            run, res = run_cli_path(torch, run_slam_cli, evaluate_cli, tmp,
                                    ["--synthetic", "--synthetic-frames", str(MAIN_FRAMES)])
        counts = read_counts()
        ate = res["ate"]["rmse"]
        chunks = -(-MAIN_FRAMES // run_slam_cli.FRONTEND_CHUNK)
        log(f"  frames={MAIN_FRAMES} (not cut) run_slam_wall_s={run['wall_s']:.2f} ate_rmse_m={ate:.5f} "
            f"rpe_trans_rmse_m={res.get('rpe', {}).get('translation', {}).get('rmse')} "
            f"launches={counts} frontend_chunks={chunks} run={run}")
        if not (ate == ate and ate < 0.05):
            raise AssertionError(f"ATE {ate} is not finite and below 0.05 m")
        record("orb", counts, {"fast_score": 4 * chunks, "gather_aligned_patches": 4 * chunks,
                               "pnp_refine": MAIN_FRAMES - 1, "ransac": MAIN_FRAMES - 1})
        for name in ("pnp_refine", "ransac"):
            if counts[name] != MAIN_FRAMES - 1:
                raise AssertionError(f"{name} launched {counts[name]} times on the ORB path, expected one a "
                                     f"tracked frame ({MAIN_FRAMES - 1})")
        counters = run["trace"]["counters"]
        log(f"  the run's trace: ransac_kernels={counters.get('ransac_kernels')} "
            f"refine_kernels={counters.get('refine_kernels')} host_syncs={counters.get('host_syncs')} "
            f"slam.ransac host_ms a frame={run['trace']['spans']['slam.ransac']['host_ms']:.4f}")
        if counters.get("ransac_kernels") != MAIN_FRAMES - 1:
            raise AssertionError(f"the ORB path's trace counts {counters.get('ransac_kernels')} ransac_kernels, "
                                 f"expected one a tracked frame ({MAIN_FRAMES - 1})")

    with phase("learned frontend + segmenter card vs cpu"):
        check_learned(torch, synthetic, run_slam_cli.render_all, tracking, config_mod, seg_mod,
                      select_keypoints)

    with phase("learned path: run-slam --frontend learned --checkpoint weights/frontend_vits.npz --semantics "
               "model --segmenter-checkpoint weights/segmenter.npz + evaluate"), \
            tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        reset_counts()
        with refine_inputs(torch) as refine_learned, ransac_inputs(torch) as ransac_learned:
            run, res = run_cli_path(torch, run_slam_cli, evaluate_cli, tmp, [
                "--synthetic", "--synthetic-frames", str(MAIN_FRAMES), "--frontend", "learned",
                "--train-config", VITS_CONFIG, "--checkpoint", VITS_WEIGHTS, "--semantics", "model",
                "--segmenter-checkpoint", SEGMENTER_WEIGHTS])
        counts = read_counts()
        ate = res["ate"]["rmse"]
        chunks = -(-MAIN_FRAMES // run_slam_cli.LEARNED_CHUNK)
        log(f"  frames={MAIN_FRAMES} ViT-S/16 ({VITS_WEIGHTS}) + segmenter ({SEGMENTER_WEIGHTS}) "
            f"run_slam_wall_s={run['wall_s']:.2f} fps={run['fps']} segmenter_s={run['segmenter_s']} "
            f"frontend_s={run['frontend_s']} slam_loop_s={run['backend_s']} model_load_s={run['model_load_s']} "
            f"render_s={run['render_s']} keyframes={run['keyframes']} "
            f"mean_inliers={run['mean_inliers']:.1f} ate_rmse_m={ate:.6f} (bound < {VITS_ATE_BOUND_M:.6f}; "
            f"JAX seeds 0-3 {VITS_ATE_JAX_M}) launches={counts} learned_chunks={chunks} ({card})")
        if not (run["finite_poses"] and ate == ate and ate < VITS_ATE_BOUND_M):
            raise AssertionError(f"trained ViT-S/16 learned path: ATE {ate} m is not finite and below "
                                 f"{VITS_ATE_BOUND_M} m")
        record("learned_vits", counts,
               {"gather_patches": chunks, "pnp_refine": MAIN_FRAMES - 1, "ransac": MAIN_FRAMES - 1})
        for name in ("pnp_refine", "ransac"):
            if counts[name] != MAIN_FRAMES - 1:
                raise AssertionError(f"{name} launched {counts[name]} times on the learned path, expected one a "
                                     f"tracked frame ({MAIN_FRAMES - 1})")
        split = learned_split(torch, synthetic, run_slam_cli.render_all, tracking, run_slam_cli,
                              select_keypoints)
        log("  learned path, device ms per 8-frame chunk (warm): "
            + " ".join(f"{k}={v:.3f}" for k, v in split.items())
            + f"; SLAM loop {1e3 * run['backend_s'] / MAIN_FRAMES:.2f} ms/frame (cold, host clock)")

    with phase("33. pnp_refine vs plain on what the ORB and learned paths' ransac_pose handed it"):
        refine = check_refine(torch, {"orb": refine_orb, "learned_vits": refine_learned})
    del refine_orb, refine_learned

    with phase("34. ransac vs plain on what the ORB and learned paths' ransac_pose handed it"):
        ransac = check_ransac(torch, {"orb": ransac_orb, "learned_vits": ransac_learned})
    del ransac_orb, ransac_learned

    with phase(f"dynamic path: run-slam --dynamic --seed {DYNAMIC_SEED}, --semantics gt and off, + evaluate"):
        ates = {}
        for semantics in ("gt", "off"):
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                reset_counts()
                run, res = run_cli_path(torch, run_slam_cli, evaluate_cli, tmp, [
                    "--synthetic", "--synthetic-frames", str(MAIN_FRAMES), "--dynamic", "--semantics",
                    semantics], seed=DYNAMIC_SEED)
                counts = read_counts()
            ates[semantics] = ate = res["ate"]["rmse"]
            chunks = -(-MAIN_FRAMES // run_slam_cli.FRONTEND_CHUNK)
            log(f"  --semantics {semantics}: frames={MAIN_FRAMES} run_slam_wall_s={run['wall_s']:.2f} "
                f"fps={run['fps']} ate_rmse_m={ate:.5f} keyframes={run['keyframes']} launches={counts}")
            record(f"dynamic_{semantics}", counts,
                   {"fast_score": 4 * chunks, "gather_aligned_patches": 4 * chunks, "pnp_refine": MAIN_FRAMES - 1,
                    "ransac": MAIN_FRAMES - 1})
        log(f"  dynamic ATE seed {DYNAMIC_SEED}: gt {ates['gt']:.5f} m (bound < {DYNAMIC_ATE_BOUND_M}), "
            f"off {ates['off']:.5f} m (bound > {DYNAMIC_OFF_ATE_FLOOR_M})")
        if not (ates["gt"] == ates["gt"] and ates["gt"] < DYNAMIC_ATE_BOUND_M):
            raise AssertionError(f"dynamic ATE with gt semantics {ates['gt']} is not finite and below "
                                 f"{DYNAMIC_ATE_BOUND_M} m")
        if not ates["off"] > DYNAMIC_OFF_ATE_FLOOR_M:
            raise AssertionError(f"dynamic ATE without semantics {ates['off']} m is not above "
                                 f"{DYNAMIC_OFF_ATE_FLOOR_M} m: the paired CPU runs' failure did not reproduce")

    with phase("trained tiny learned path: run-slam --frontend learned --checkpoint + evaluate"), \
            tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        reset_counts()
        run, res = run_cli_path(torch, run_slam_cli, evaluate_cli, tmp, [
            "--synthetic", "--synthetic-frames", str(MAIN_FRAMES), "--frontend", "learned",
            "--train-config", TINY_CONFIG, "--checkpoint", TINY_WEIGHTS])
        counts = read_counts()
        ate = res["ate"]["rmse"]
        chunks = -(-MAIN_FRAMES // run_slam_cli.LEARNED_CHUNK)
        log(f"  frames={MAIN_FRAMES} tiny frontend ({TINY_WEIGHTS}) run_slam_wall_s={run['wall_s']:.2f} "
            f"fps={run['fps']} frontend_s={run['frontend_s']} slam_loop_s={run['backend_s']} "
            f"render_s={run['render_s']} keyframes={run['keyframes']} mean_inliers="
            f"{run['mean_inliers']:.1f} ate_rmse_m={ate:.5f} (bound < {TINY_ATE_BOUND_M:.6f}) "
            f"launches={counts}")
        if not (run["finite_poses"] and ate == ate and ate < TINY_ATE_BOUND_M):
            raise AssertionError(f"trained tiny learned path: ATE {ate} m is not finite and below "
                                 f"{TINY_ATE_BOUND_M} m")
        record("learned_tiny", counts,
               {"gather_patches": chunks, "pnp_refine": MAIN_FRAMES - 1, "ransac": MAIN_FRAMES - 1})

    with phase(f"trained segmenter: run-slam --dynamic --seed {DYNAMIC_SEED} --semantics model "
               "--segmenter-checkpoint + evaluate"), \
            tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        reset_counts()
        run, res = run_cli_path(torch, run_slam_cli, evaluate_cli, tmp, [
            "--synthetic", "--synthetic-frames", str(MAIN_FRAMES), "--dynamic", "--semantics", "model",
            "--segmenter-checkpoint", SEGMENTER_WEIGHTS], seed=DYNAMIC_SEED)
        counts = read_counts()
        ate = res["ate"]["rmse"]
        chunks = -(-MAIN_FRAMES // run_slam_cli.FRONTEND_CHUNK)
        record("dynamic_model", counts, {"fast_score": 4 * chunks, "gather_aligned_patches": 4 * chunks,
                                         "pnp_refine": MAIN_FRAMES - 1, "ransac": MAIN_FRAMES - 1})
        recall, accuracy = segmenter_fidelity(torch, synthetic, run_slam_cli.render_all, seg_mod,
                                              run_slam_cli)
        log(f"  frames={MAIN_FRAMES} run_slam_wall_s={run['wall_s']:.2f} fps={run['fps']} "
            f"segmenter_s={run['segmenter_s']} ate_rmse_m={ate:.5f} (bound < {SEG_MODEL_ATE_BOUND_M:.6f}; "
            f"off {ates['off']:.5f}, gt {ates['gt']:.5f}) person_recall={recall:.6f} (bound >= "
            f"{SEG_PERSON_RECALL_MIN:.6f}; JAX {SEG_PERSON_RECALL_JAX}) label_accuracy={accuracy:.6f} "
            f"(JAX {SEG_LABEL_ACCURACY_JAX}) launches={counts}")
        if not (ate == ate and ate < SEG_MODEL_ATE_BOUND_M):
            raise AssertionError(f"--semantics model: ATE {ate} m is not finite and below "
                                 f"{SEG_MODEL_ATE_BOUND_M} m")
        if not recall >= SEG_PERSON_RECALL_MIN:
            raise AssertionError(f"segmenter person recall {recall} below {SEG_PERSON_RECALL_MIN}")

    with phase(f"loop path: {LOOP_FRAMES}-frame harsh loop, run_slam_online with and without closure"):
        loop = loop_path(torch, synthetic, run_slam_cli, system, online, prng, ate_rpe, reset_counts,
                         read_counts)
        chunks = -(-LOOP_FRAMES // run_slam_cli.FRONTEND_CHUNK)
        record("loop", loop["counts"], {"fast_score": 4 * chunks, "gather_aligned_patches": 4 * chunks,
                                        "pnp_refine": 2 * (LOOP_FRAMES - 1), "ransac": 2 * (LOOP_FRAMES - 1)})
        for name, r in loop["runs"].items():
            t = r["timings"]
            slam_s = [c["slam_s"] for c in t]
            closure_s = [c["closure_s"] for c in t]
            third = max(1, len(t) // 3)
            per_chunk = [a + b for a, b in zip(slam_s, closure_s)]
            ratio = sum(per_chunk[-third:]) / max(sum(per_chunk[:third]), 1e-9)
            log(f"  {name}: ate_rmse_m={r['ate']:.6f} loops={[(a, b, round(s, 3)) for a, b, s in r['loops']]} "
                f"wall_s={r['wall']:.2f} keyframes={int(r['out'].is_keyframe.sum())} chunk slam_s={slam_s} "
                f"closure_s={closure_s} last/first third of chunk times={ratio:.3f}")
        closure, odom = loop["runs"]["closure"], loop["runs"]["odometry"]
        log(f"  render_s={loop['render_s']:.2f} frontend_s={loop['frontend_s']:.2f} "
            f"launches={loop['counts']}; closure ATE {closure['ate']:.6f} m (bound < "
            f"{LOOP_ATE_BOUND_M:.6f}), odometry ATE {odom['ate']:.6f} m, {len(closure['loops'])} loops")
        if not (closure["finite"] and odom["finite"]):
            raise AssertionError("the loop path gave non-finite poses")
        if not closure["loops"]:
            raise AssertionError("the loop path closed no loop")
        if not closure["ate"] < LOOP_ATE_BOUND_M:
            raise AssertionError(f"loop closure ATE {closure['ate']} m not below {LOOP_ATE_BOUND_M} m")

    with phase("closing pass card vs cpu on identical features"):
        closing_pass_card_vs_cpu(torch, tracking, loop_closing, loop)
    del loop

    for mode in ("offline", "online"):
        with phase(f"CLI loop closing: run-slam --synthetic --loop-closure {mode} + evaluate"), \
                tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            reset_counts()
            run, res = run_cli_path(torch, run_slam_cli, evaluate_cli, tmp, [
                "--synthetic", "--synthetic-frames", str(MAIN_FRAMES), "--loop-closure", mode])
            counts = read_counts()
            ate = res["ate"]["rmse"]
            chunks = -(-MAIN_FRAMES // run_slam_cli.FRONTEND_CHUNK)
            log(f"  frames={MAIN_FRAMES} run_slam_wall_s={run['wall_s']:.2f} fps={run['fps']} "
                f"slam_loop_s={run['backend_s']} closure_s={run['closure_s']} loops_closed="
                f"{run['loops_closed']} loops={run['loops']} ate_rmse_m={ate:.6f} (bound < "
                f"{CLI_LOOP_ATE_BOUND_M}) launches={counts}")
            if not (run["finite_poses"] and ate == ate and ate < CLI_LOOP_ATE_BOUND_M):
                raise AssertionError(f"--loop-closure {mode}: ATE {ate} m is not finite and below "
                                     f"{CLI_LOOP_ATE_BOUND_M} m")
            record(f"cli_{mode}", counts, {"fast_score": 4 * chunks, "gather_aligned_patches": 4 * chunks,
                                           "pnp_refine": MAIN_FRAMES - 1, "ransac": MAIN_FRAMES - 1})

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tum_") as tum_root:
        with phase("TUM input: write, decode (native and plain), pinned frame_chunks to the card"):
            tum_frames = tum_input(torch, synthetic, tum, native_io, prefetch, tum_root)["frames"]

        with phase("TUM main path: run-slam --data-root + evaluate --data-root"), \
                tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            reset_counts()
            run, res = run_cli_path(torch, run_slam_cli, evaluate_cli, tmp,
                                    ["--data-root", tum_root, "--sequences", TUM_NAME],
                                    eval_argv=["--data-root", tum_root])
            counts = read_counts()
            ate = res["ate"]["rmse"]
            chunks = -(-MAIN_FRAMES // run_slam_cli.FRONTEND_CHUNK)
            log(f"  frames={run['frames']} decoder={run['decoder']} run_slam_wall_s={run['wall_s']:.2f} "
                f"fps={run['fps']} decode_s={run['decode_s']} frontend_s={run['frontend_s']} "
                f"slam_loop_s={run['backend_s']} keyframes={run['keyframes']} mean_inliers="
                f"{run['mean_inliers']:.1f} ate_rmse_m={ate:.6f} (bound < {TUM_ATE_BOUND_M:.6f}) "
                f"launches={counts} frontend_chunks={chunks} ({card})")
            if not (run["frames"] == MAIN_FRAMES and run["finite_poses"] and ate == ate and ate < TUM_ATE_BOUND_M):
                raise AssertionError(f"TUM path: ATE {ate} m is not finite and below {TUM_ATE_BOUND_M} m")
            for name in ("fast_score", "gather_aligned_patches"):
                if counts[name] != 4 * chunks:
                    raise AssertionError(f"{name} launched {counts[name]} times on the TUM path, expected "
                                         f"{4 * chunks}")
            record("tum", counts, {"fast_score": 4 * chunks, "gather_aligned_patches": 4 * chunks,
                                   "pnp_refine": MAIN_FRAMES - 1, "ransac": MAIN_FRAMES - 1})

        with phase("acceptance suite: run-tests --frontend orb-pyramid (TUM) and learned (--synthetic)"), \
                tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            reset_counts()
            run_suite(run_tests_cli, tmp, ["--frontend", "orb-pyramid", "--data-root", tum_root, "--sequences",
                                           TUM_NAME, "--difficulty", "normal"], "orb-pyramid", SUITE_TUM_JAX, card)
            record("suite_orb_pyramid", read_counts(), {"fast_score": 1, "gather_aligned_patches": 1})
            reset_counts()
            run_suite(run_tests_cli, tmp, ["--frontend", "learned", "--config", TINY_CONFIG, "--checkpoint",
                                           TINY_WEIGHTS, "--synthetic", "--difficulty", "normal"], "learned",
                      SUITE_LEARNED_JAX, card)
            record("suite_learned", read_counts(), {"gather_patches": 1})
            reset_counts()
            r = run_suite(run_tests_cli, tmp, ["--frontend", "learned", "--config", VITS_CONFIG, "--checkpoint",
                                               VITS_WEIGHTS, "--synthetic", "--difficulty", "normal"],
                          "learned-vits", SUITE_VITS_JAX, card)
            record("suite_learned_vits", read_counts(), {"gather_patches": 1})
            log("  the ViT-S/16 checkpoint's own figures on a TPU (artifacts/frontend_vits/test_results.json, "
                "context, not the bound): " + " ".join(f"{k}={v:.6f}" for k, v in SUITE_VITS_TPU.items())
                + "; the card minus them: " + " ".join(f"{k}={suite_figures(r)[k] - v:+.6f}"
                                                     for k, v in SUITE_VITS_TPU.items()))

    training_phases(torch, run_slam_cli, evaluate_cli, config_mod, record, reset_counts, read_counts, card)
    cli_tool_phases(torch, synthetic, tracking, record, reset_counts, read_counts, card, path_frames)
    del path_frames
    with phase(f"30. fleet SLAM: {FLEET_SEQUENCES} disjoint sequences of the ORB path's frames, run_slam_fleet "
               "on the card against each sequence's run_slam and the CPU fleet"):
        fleet_phase(torch, tum_frames, record, reset_counts, read_counts, card)
    del tum_frames
    with phase(f"31. a ViT-S/16 train step over a mesh at {' and '.join(MESH_DTYPES)}: 1x1 under NCCL, "
               f"{' and '.join(f'{d}x{m}' for d, m in MESH_SHAPES)} on two gloo ranks of the one card, against "
               "the step without a mesh"):
        mesh_training_phase(torch, record, reset_counts, read_counts, card)
    with phase(f"32. stage-2 warm start: train --init-from {VITS_WEIGHTS} (the trained ViT-S/16, 1 step of 8 "
               "pairs at 448 px), its first forward against the JAX package's"):
        warm_start_phase(torch, record, reset_counts, read_counts, card)

    kernels = []
    for name, src, replaces, r, timed_as in (
        ("fast_score", "semantic_slam_master_tpu_torch/csrc/fast_score.cu",
         "semantic_slam_master_tpu/ops/pallas/fast_score.py:102", fast,
         "sum of the four pyramid levels of one 16-frame frontend chunk of the rendered world at "
         "threshold 0.05; bound: bytes, or the 4-point test on every pixel plus the 16-point chain on "
         "the pass_share that passes it, at the f32 issue rate"),
        ("gather_aligned_patches", "semantic_slam_master_tpu_torch/csrc/aligned_patches.cu",
         "semantic_slam_master_tpu/ops/pallas/patches.py:206", patches,
         "sum of the four pyramid levels of one 16-frame frontend chunk of the rendered world (blurred "
         "levels, the path's detections); library_ms is one torch.gather over the precomputed index, "
         "the gather alone (no quantisation, f32 out)"),
        ("gather_patches", "semantic_slam_master_tpu_torch/csrc/gather_patches.cu",
         "semantic_slam_master_tpu/ops/pallas/patches.py:64", gather,
         "one 8-frame learned chunk: 8x500 windows of 21x21 from 480x640; library_ms is one "
         "torch.gather over the precomputed index, the gather alone"),
        ("pnp_refine", "semantic_slam_master_tpu_torch/csrc/pnp_refine.cu",
         "none: the slam.refine span of semantic_slam_master_tpu_torch/slam/pnp.py::ransac_pose", refine,
         "one call on the ORB path's middle tracked frame (N=512, as ransac_pose handed it); plain_ms on the "
         "host clock, synchronised (the plain version reads the device 12 times); bound: the bytes read and "
         "written once, the kernel is latency-bound (10 dependent Gauss-Newton steps)"),
        ("ransac", "semantic_slam_master_tpu_torch/csrc/ransac.cu",
         "none: the slam.ransac span of semantic_slam_master_tpu_torch/slam/pnp.py::ransac_pose", ransac,
         "the kernel alone on the ORB path's middle tracked frame (H=64, N=512, as ransac_pose handed it, the "
         "draw's cumsum taken before); plain_ms on the host clock, synchronised (the plain version reads the "
         "device twice); bound: the operations (~2,000 a fit, ~40 a reprojection) at the f32 issue rate, the "
         "kernel is latency-bound"),
    ):
        b_ms, b_by = bound(r["bytes"], r["ops"])
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(launches[name].values()), "launches_by_path": launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": r.get("library_ms"), "status": "checked", "timed_as": timed_as,
            **{k: r[k] for k in ("random_ms", "pass_share", "old_bound_ms") if k in r},
        })
    log(json.dumps({"kernels": kernels}))
    log(f"chip_smoke total {time.perf_counter() - T_START:.2f} s (target < {TARGET_TOTAL_S} s)")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--write-config", nargs=2, metavar=("KIND", "OUT"),
                        help="write a training phase's derived YAML (resume, init or vits; save_dir "
                        "'checkpoints') and exit, without a card")
    args = parser.parse_args()
    if args.write_config:
        derive_config(args.write_config[0], "checkpoints", args.write_config[1])
        sys.exit(0)
    sys.exit(main())
