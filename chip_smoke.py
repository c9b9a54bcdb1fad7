#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``dense_visual_odometry_torch``) on one GPU.

Run from the root of a checkout, on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. environment: torch, CUDA, nvcc, triton, and the card's name and power limit;
2. build: compiles ``ops/cuda/csrc/*.cu`` for sm_90a, one nvcc per source, all
   started together;
3. kernels: each CUDA kernel against its plain PyTorch version on the same
   inputs on the card, at the 640x480 main path's level shapes, with the
   tolerances stated in ``TOLERANCES``: the level kernel at levels 0 and 3
   for B=1, 8 and 64 (the batch sizes of the session, the kernel checks of
   earlier slices and the batched runs), without illumination, with the
   bias and with affine gain + bias, under both stopping rules, and with
   the depth term (without illumination and with the bias) and the motion
   prior (both energy forms, ``PRIOR_SIGMA``, toward the previous pair's
   true motion; each reports how far the prior moves the solve), and the
   row-block and tile variants (``BLOCK_CASES``: ``fast_blocks_ry2``'s 6 row
   blocks with the vertical radius 2, ``parity_tiles_r2``'s and
   ``slam_tiles_cb48``'s 8 x 10 tiles, without illumination, with the bias
   and, on tiles, with the depth term), and its runtime-stride variant at
   level 0 at grid strides 3 and 4 (``STRIDE_LEVEL_CASES``: without
   illumination, with the bias, with affine, with the depth term, and on
   8 x 10 tiles), each with
   the launch geometry it chose (cluster size, pixels per CTA, shared bytes,
   resident or streamed inputs, the clusters the card holds at once); the
   fused kernel at level 0 and at levels 1 and 2 of ``tpu_accurate``
   (``FUSED_LEVELS``) for the same batch sizes, without illumination and
   with the bias, on the level kernel's inputs, with its geometry, and at
   level 0 at strides 3 and 4; the stack kernel at levels 0 and 3 and at
   level 0 at strides 3 and 4, for the same batch sizes; the pyramid kernel
   (one pyramid step, ``median_pyr_down``) on the gray and depth images of
   levels 0 and 2 at B=1, 8, 64 and 256 (``PYRAMID_BATCHES``), equal to the
   plain network bit for bit, timed beside it; at B=8 and 64
   the level kernel (levels 0 and 3) and the fused kernel (level 0) also at
   every cluster size and input residency that fits, timed.  The level and
   fused kernels run each case twice and must repeat bit for bit, and up to
   B=8 must equal their plain versions bit for bit (the level kernel but in
   ``LAST_BIT_CASES``).  Kernel times,
   plain times (the plain level solver only up to B=8: at B=64 it is
   compared, not timed) and for the stack kernel the time of
   ``F.grid_sample`` on the same samples;
4. main path: ``batched_track_pair`` at B=64 on ``configs/tpu_fast.json``,
   ``configs/tpu_parity.json``, ``configs/tpu_slam.json``, the parity tier
   with affine illumination (``parity_affine``) and with ESM gradients
   (``parity_esm``), ``configs/tpu_accurate.json``,
   ``configs/tpu_accurate_illum.json`` (level 3 on the "packed" LM loop),
   ``configs/reference_default.json`` (the Gauss-Newton loop on the "plain"
   evaluation), ``tpu_fast`` with the motion prior (``fast_prior``: each
   pair anchored at the previous pair's true motion) and with the depth term
   (``fast_depth``), with row blocks and the vertical radius 2
   (``fast_blocks_ry2``), ``tpu_parity`` with 8 x 10 tiles at radius 2
   (``parity_tiles_r2``), ``tpu_slam`` with 8 x 10 tiles
   (``slam_tiles_cb48``), ``tpu_fast`` at grid strides (3, 2, 1, 1) and
   (4, 2, 1, 1) (``fast_stride3``, ``fast_stride4``) and the parity tier
   with ESM gradients at (4, 2, 1, 1) (``esm_stride4``), each over all 15
   pairs and, but for ``tpu_parity`` and
   ``reference_default``, over the pairs that stay on the level kernel at
   every level that has it; ``accurate_lm`` (``tpu_accurate`` with the level
   kernel off: one fused launch per LM iteration) over the kernel-path pairs
   of ``tpu_accurate``; a 16-frame ``OdometrySession`` on ``tpu_fast``, the
   two parity variants, ``tpu_accurate``, ``reference_default``,
   ``fast_prior``, ``fast_depth`` and ``slam_tiles_cb48``; and a 16-frame
   ``BatchedOdometrySession`` of 8 streams on ``tpu_accurate``, over a seeded
   synthetic 640x480 scene with exact ground truth; the kernels' launch counts
   (and the level kernel's row-block and tile launches, and each kernel's
   launches at a grid stride >= 3, among them) are zeroed just before this
   phase and read just after it; two pairs of each configuration, and of
   ``reference_prior`` (``reference_default`` with the reference oracle's
   binding prior), are cross-checked against the port's CPU plain path;
5. the command-line path: ``apps.make_dataset --source synthetic --motion
   handheld-fr1`` writes 30 frames at 640x480 into a temporary directory,
   ``apps.benchmark`` tracks it on the card under ``tpu_fast``,
   ``fast_stride4`` and ``esm_stride4`` and writes ``report.json`` and
   ``trajectory.txt``, ``apps.evaluate`` re-reads the trajectory (its ATE
   must be the report's), ATE and RPE within ``CLI_BOUNDS``, with its own
   launch counts; it prints the PNG read route, frames/s and ms per frame
   on lines of their own;
6. the SLAM back end under ``configs/tpu_slam.json``, with its own launch
   counts: (a) ``SlamSession`` direct and two-step over the 16 frames with
   ``SLAM_POLICY`` (at least ``SLAM_MIN_KEYFRAMES`` keyframes; errors of the
   front-end poses and of ``optimized_trajectory`` within ``SLAM_BOUNDS``;
   the same keyframes as the port's CPU path, poses within
   ``SLAM_POSE_ATOL``; the host reads of one step counted); (b) a sweep,
   blank frames and a revisit (``synthetic.revisit_sequence``): at least one loop
   closure and one relocalization; (c) ``optimize_full`` and
   ``refine_dense(update_depths=True)`` at grid stride 8 over (a)'s direct
   keyframes, on the card and on the CPU from the same checkpoint, poses
   within ``SLAM_POSE_ATOL``, timed, with the size of the Schur coupling
   ``y``; (d) a ``BatchedSlamSession`` of ``SLAM_STREAMS`` streams, each
   within ``STREAM_ATOL`` of its own ``SlamSession`` on the card, frames/s;
   (e) ``apps.benchmark -m slam`` on phase 5's directory, plain, with
   ``--slam-two-step`` and with ``--dense-refine``, ATE within
   ``SLAM_CLI_BOUNDS``, and ``refine_sensitivity``: the session on that
   directory on the card and on the CPU (the same keyframes, poses within
   ``SLAM_POSE_ATOL`` before the dense refinement), the refinement from
   each state, from one state and after a move of ``REFINE_PERTURB_M`` (ATE
   within the same bound); it prints each on a line of its own;
7. mapping, with its own launch counts: ``apps.reconstruct`` on phase 5's
   directory under ``configs/tpu_fast.json`` (``MAPPING_RUNS``): (a) the
   session's poses fused into the dense volume (``--resolution 192``) and
   (b) into the brick volume (``--brick``, ``.obj``), (c) ``-m
   track-model`` (keyframe renders, the splat), (d) with ``--track-kinfu``
   (a march every frame) and (e) with ``--track-brick`` too; each run's ATE
   and its mesh's median |z - true depth| in frame 0 within
   ``MAPPING_BOUNDS``; (a)'s and (b)'s 30 fusions repeated on the CPU from
   the same frames and poses (fields equal but for a bounded share of tie
   voxels); the splat and march renders of (a)'s volume and the brick march
   of (b)'s at frame 0's pose on the card and on the CPU from one volume
   (``MAPPING_RENDER_SHARE`` of the pixels within tolerance); at
   ``KINFU512``, the fusion kernel and the volume march kernel against their
   plain versions bit for bit, timed beside their bounds, and a KinectFusion
   tracker over the 30 frames whose every render launches the march
   kernel once (spans, ``map.render_kernel`` and launches agree); the level and
   fused kernels must launch in (c)-(e); it prints fusion ms a frame, render
   ms at 640x480, the track-model steps' median ms, frames/s and host reads
   of a step, mesh extraction s, vertices and faces, bricks used and dropped
   and volume bytes, each timing beside the card's name and power limit;
8. the sparse pipeline, with its own launch counts (none of the port's
   kernels is on it): (a) ``apps.benchmark -m sparse`` on phase 5's directory
   with ``--sparse-matcher zncc`` and ``learned`` (the LoFTR-lite matcher,
   the committed weights), ATE and RPE within ``SPARSE_CLI_BOUNDS``, every
   step's success counted; (b) ``SparseVO`` of each matcher over the first
   ``SPARSE_CROSS_FRAMES`` frames on the card and on the CPU from one seed:
   equal success flags, poses within ``SPARSE_POSE_ATOL``, and the learned
   matcher's coarse selections holding the same cells (ranks that part
   counted and printed); (c) each stage's device time at 640x480 (Harris,
   ZNCC each way, RANSAC, the refine; the backbone, each attention layer,
   the dual softmax with its selection, both fine stages), and a card
   session's median step, host reads and peak memory of a step;
9. training the LoFTR-lite matcher, with its own launch counts (none of the
   port's kernels is on it): (a) a bundled-format directory of 10 frames at
   640x480 (``bundled_dataset``: the synthetic scene, the TUM fr1 camera, a
   hand-held trajectory); (b) ``apps.train_matcher`` on the card at its
   default widths and schedule (800 steps), the holdout precision, recall
   and subpixel errors within ``TRAIN_BOUNDS``, with the dataset's build
   time, the first and median step, and the loss every
   ``TRAIN_LOSS_EVERY`` steps; (c) the first ``TRAIN_CROSS_STEPS`` steps at
   full width on the card and on the CPU from one init, losses and
   parameters within ``TRAIN_CROSS_LOSS_RTOL`` / ``TRAIN_CROSS_PARAM_ATOL``,
   and the peak memory of a step; (d) the trained file (keys and shapes of
   the committed JAX file's) serving ``SparseVO(matcher="learned")`` over
   ``TRAIN_SERVE_FRAMES`` frames of phase 5's directory on the card; (e)
   ``apps.visualize report`` of phase 5's ``tpu_fast`` run with ``--ply``
   on the card and with ``--platform cpu`` (with the figure and a GIF where
   matplotlib imports), the clouds within ``VISUALIZE_ATOL``; (f)
   ``TRAIN_PROFILED_STEPS`` steps in ``trace_span("train_step")`` under
   ``start_trace`` / ``stop_trace``: the spans in the trace, the kernels a
   step, the device's busy share of a step, ``device_memory_stats()``;
10. the multi-device back end, with its own launch counts
   (``run_distributed``): ``parallel.dryrun.dryrun_multichip`` on phase 4's
   B=64 rows under ``DIST_CONFIGS`` (``tpu_fast``, the tile level-kernel
   path ``slam_tiles_cb48`` and ``parity_esm``, so that all three kernels
   launch), the edge-sharded pose graph over the 64-pose tracked chain with
   ``DIST_LOOPS`` and the owner-sharded dense BA over 8 keyframes at grid
   stride 8 (P=4,800) and on the JAX package's planar test problem
   (``planar_ba_problem``): (a) at world 1 over NCCL in this process (a
   file store in a temporary directory), equal bit for bit to the
   single-device runs; (b) at world ``DIST_WORLD`` over gloo, spawned
   ranks all on the card, within ``dryrun.BOUNDS`` of (a)'s single-device
   runs (the scene's dense BA: its reduced system within
   ``DIST_SYSTEM_RTOL``) and equal across ranks, joined with a timeout; it
   prints each run's wall ms (world 4's as four ranks time-sharing one
   card), the bytes all-reduced a Gauss-Newton iteration and the launches.

Then the card's ``nvidia-smi`` line, one JSON line of per-kernel numbers (the
level kernel's row with a ``variants`` entry for its depth, prior, row-block
and tile variants; each kernel's with a ``strides`` entry for its
runtime-stride variant at strides 3 and 4, its ``cli_launches``, its
``slam_launches``, its ``mapping_launches``, its ``sparse_launches``, its
``train_launches`` and its ``distributed_launches``),
and last ``{"ok": true,
"device": {...}}``.  A failed check raises and exits
non-zero before that line; without a GPU the script exits non-zero at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from dense_visual_odometry_torch.camera import CameraModel
from dense_visual_odometry_torch.config import RobustDVOConfig
from dense_visual_odometry_torch.io import synthetic
from dense_visual_odometry_torch.models import robust
from dense_visual_odometry_torch.models.session import OdometrySession
from dense_visual_odometry_torch.ops.cuda import build, fused_iter, level_solver
from dense_visual_odometry_torch.ops.cuda.level_solver import lm_level, lm_level_plain
from dense_visual_odometry_torch.ops.cuda.stackwarp import stack_accumulate
from dense_visual_odometry_torch.ops.pyramid import median3x3
from dense_visual_odometry_torch.ops.shiftwarp import residual_displacements, tent_sample
from dense_visual_odometry_torch.parallel import batched_track_pair, stack_frame_data
from dense_visual_odometry_torch.utils.lie import se3

ROOT = Path(__file__).resolve().parent
CONFIGS = ROOT / "configs"
HEIGHT, WIDTH, LEVELS = 480, 640, 4
N_FRAMES = 16
KERNEL_BATCHES = (1, 8, 64)
SWEEP_BATCHES = (8, 64)  # batch sizes of the timed geometry sweeps
SUMMARY_BATCH = 8  # the batch size of the kernel summary line
PLAIN_TIMED_MAX_BATCH = 8
STRICT_MAX_BATCH = 8  # see level_agrees and fused_agrees
# The fused kernel's cases (level, configuration): level 0, where every
# configuration takes its level-0 Hessian, and levels 1 (stride 2) and 2
# (stride 1) of tpu_accurate, where accurate_lm evaluates through it at each
# LM iteration.
FUSED_LEVELS = ((0, "tpu_fast"), (1, "tpu_accurate"), (2, "tpu_accurate"))
MAIN_BATCH = 64
# The pyramid kernel's cases in phase 3: batch sizes (256: the benchmark's
# fast.b256.xyz) and input levels (480x640 and 120x160).
PYRAMID_BATCHES = (1, 8, 64, 256)
PYRAMID_LEVELS = (0, 2)
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s and FP32
# (non-tensor-core) operations/s; the kernels do plain FP32 arithmetic.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# FP32 operations per pixel per evaluation, counted from csrc/ (lower bounds):
# the warp of a template point (3x3 rotation + translation, projection,
# displacement, ball and bounds tests) on every pixel; on a valid pixel the
# <= 4 tent taps and the residual (29), the t-scale fixed point (7 per step,
# 3 steps) and the weighted normal equations (21 + 6 products and sums, the
# weight and error: 67), ~120 in all.  The stack kernel, per output pixel:
# two floors, per row tap its offset, range test and weight (7, twice), per
# tap its offset, range test, weight, product and sum (10, four times): 56.
OPS_WARP = 40
OPS_VALID = 120
OPS_STACK = 56

# The depth term's own FP32 operations per valid pixel per evaluation,
# counted from csrc/ the same way (the warp it needs is OPS_WARP's; that the
# kernel's depth pass recomputes it is not counted): it samples the depth
# window (29, as the photometric taps), forms the residual and Huber weight
# (6), the Jacobian (the gradients' focal scaling, 1/z', 1/z'^2 and the six
# entries: 37) and the weighted products and sums of its 29 sums (6 weights,
# 21 + 6 + 2 products, 29 sums: 64), 136 in all.
OPS_DEPTH = 136
# The motion prior of the kernel checks: strong enough at 640x480 to move
# the level kernel's solve (each check reports by how much), the value of the
# JAX package's own TPU smoke test (benchmarks/smoke_tpu.py:96).
PRIOR_SIGMA = 2e-7
# The level kernel's depth and prior variants in phase 3: (term,
# illumination, relative tolerance).  The prior's energy would stop a
# relative test at its first iteration, so its cases stop on the absolute
# tolerance.
TERM_CASES = (("depth", None, 0.01), ("depth", "bias", 0.01), ("prior", None, None),
              ("prior_reference", None, None))
# The level kernel's row-block and tile variants in phase 3: (configuration
# of VARIANTS, illumination, term), each at its configuration's stopping
# rule.
BLOCK_CASES = (("fast_blocks_ry2", None, None), ("fast_blocks_ry2", "bias", None),
               ("parity_tiles_r2", None, None), ("parity_tiles_r2", "bias", None),
               ("slam_tiles_cb48", None, "depth"))

# Kernel against plain version: same inputs, same arithmetic; the level and
# fused kernels' sums are float64 on both sides (level_agrees,
# fused_agrees).  Poses in metres / rotation entries; sums relative to the
# largest magnitude of their field.  The stack kernel
# sums no block: its samples on the valid pixels relative to the largest
# sample.
TOLERANCES = {"pose_atol": 1e-4, "sum_rtol": 1e-4, "scale_rtol": 1e-3,
              "sample_rtol": 1e-5}
# Up to B=8 every level-kernel case must equal its plain version bit for bit,
# but these, which part in the last bits on the smoke's data and are held to
# TOLERANCES instead: tpu_fast's (level, batch, illumination, term) and the
# block and tile cases' (configuration, level, batch, illumination, term).
# Float64 does not add every sum exactly, and there one float64 total,
# which the kernel and the plain version add in different orders, rounds to
# float32 the other way.  ``profile_port.py --bits`` shows it for each case:
# at the first iteration where they part (the state before it equal on both
# sides), the plain version on the card with that iteration's sums added
# exactly (``math.fsum``, rounded once) equals the plain version's row bit
# for bit, and the kernel's row sits 1 or 2 float32 steps away, on one
# element, in the t-scale lambda and the error (columns 32 and 34; with the
# depth term and bias at level 3 in the Hessian's entries too).  Every case
# below reads so.
LAST_BIT_CASES = {(0, 8, None, "depth"), (3, 1, "bias", "depth"), (3, 8, "bias", "depth"),
                  (0, 8, None, "prior_reference"),
                  ("parity_tiles_r2", 0, 8, None, None), ("parity_tiles_r2", 0, 8, "bias", None),
                  ("slam_tiles_cb48", 0, 8, None, "depth"),
                  ("fast_stride3", 0, 8, "bias", None), ("tiles_stride3", 0, 8, None, None),
                  ("fast_stride4", 0, 8, None, None), ("fast_stride4", 0, 8, "affine", None),
                  ("fast_stride4", 0, 8, None, "depth"), ("tiles_stride4", 0, 8, None, None)}
# Tracking-error bounds of the main path (per pair: median and largest
# translation error, largest rotation error; drift over a 16-frame
# session).  By default several times what the JAX package and the port's
# CPU plain path reach on the smoke's scene (tests/jax_smoke_scene.py): for
# tpu_fast median 0.03 mm, max 0.1 mm and 0.5 mm drift.  The motion prior
# and the depth term track worse there in the JAX package itself, and their
# bounds are three times its errors: at PRIOR_SIGMA the prior pulls each
# level toward its anchor again (all 15 pairs, each anchored at the
# previous pair's true motion: median 0.64 mm, max 12.6 mm, 0.44 deg; a
# session, whose constant-velocity start is its anchor too: 61.2 mm
# drift), and with the depth term median 0.66 mm, max 0.79 mm, 0.026 deg,
# 8.0 mm drift.  The grid-stride variants' are three times the JAX
# package's errors on the same scene too: fast_stride3 median 0.034 mm, max
# 0.105 mm, 0.0038 deg, 0.58 mm drift; fast_stride4 0.023, 0.117 mm, 0.0042
# deg, 0.55 mm; esm_stride4 0.018, 0.045 mm, 0.0015 deg, 0.11 mm.
BOUNDS = {
    "default": {"median_mm": 0.5, "max_mm": 2.0, "rotation_deg": 0.1, "drift_mm": 2.0},
    "fast_prior": {"median_mm": 2.0, "max_mm": 38.0, "rotation_deg": 1.4, "drift_mm": 184.0},
    "fast_depth": {"median_mm": 2.0, "max_mm": 2.4, "rotation_deg": 0.08, "drift_mm": 24.0},
    "fast_stride3": {"median_mm": 0.11, "max_mm": 0.32, "rotation_deg": 0.012, "drift_mm": 1.8},
    "fast_stride4": {"median_mm": 0.07, "max_mm": 0.36, "rotation_deg": 0.013, "drift_mm": 1.7},
    "esm_stride4": {"median_mm": 0.055, "max_mm": 0.14, "rotation_deg": 0.0045, "drift_mm": 0.35},
}
# The shipped configurations on the main path, read verbatim from configs/.
SHIPPED = ("tpu_fast", "tpu_parity", "tpu_slam", "tpu_accurate", "tpu_accurate_illum",
           "reference_default")
# Variants on the main path: a shipped configuration, then these overrides.
VARIANTS = {
    "parity_affine": ("tpu_parity", {"illumination": "affine"}),
    "parity_esm": ("tpu_parity", {"use_esm_gradients": True, "esm_levels": [0, 1, 2],
                                  "esm_fallback_max_rotation": 0.25}),
    "accurate_lm": ("tpu_accurate", {"use_level_kernel": False}),
    "fast_prior": ("tpu_fast", {"sigma": PRIOR_SIGMA}),
    "fast_depth": ("tpu_fast", {"use_depth_residuals": True}),
    # Row blocks with a smaller vertical radius (benchmarks/exp_blocks.py:105).
    "fast_blocks_ry2": ("tpu_fast", {"recenter_blocks": 6, "shift_stack_radius_y": 2}),
    # The parity tier's accuracy-max variant (benchmarks/RESULTS.md:1023).
    "parity_tiles_r2": ("tpu_parity", {"recenter_blocks": 8, "recenter_col_blocks": 10,
                                       "shift_stack_radius": 2}),
    # Tiles keep SLAM keyframe solves on the level kernel
    # (benchmarks/exp_slampareto.py:140-143).
    "slam_tiles_cb48": ("tpu_slam", {"recenter_blocks": 8, "recenter_col_blocks": 10,
                                     "fallback_max_rotation": 0.25,
                                     "recenter_center_bound": 48}),
    # Grid strides 3 and 4 at level 0 (the kernels' runtime-stride variant):
    # the fast tier on a 160x214 or 120x160 level-0 grid, and the parity
    # tier with ESM gradients, whose ESM levels sample through the stack
    # kernel, at stride 4.
    "fast_stride3": ("tpu_fast", {"grid_strides": [3, 2, 1, 1]}),
    "fast_stride4": ("tpu_fast", {"grid_strides": [4, 2, 1, 1]}),
    "esm_stride4": ("tpu_parity", {"use_esm_gradients": True, "esm_levels": [0, 1, 2],
                                   "esm_fallback_max_rotation": 0.25,
                                   "grid_strides": [4, 2, 1, 1]}),
}
# Phase 3 only: the level kernel's tiles at strides 3 and 4 (the JAX
# package refuses tiles at a stride above 2 in its tracker; its level kernel
# takes them).
KERNEL_ONLY = {
    f"tiles_stride{s}": ("tpu_fast", {"recenter_blocks": 8, "recenter_col_blocks": 10,
                                      "grid_strides": [s, 2, 1, 1]})
    for s in (3, 4)
}
# The runtime-stride variants in phase 3, at level 0, for each stride:
# the level kernel's (configuration, illumination, term) cases, and the
# configuration of the fused and stack kernels' cases.
STRIDES = (3, 4)
STRIDE_LEVEL_CASES = {
    s: ((f"fast_stride{s}", None, None), (f"fast_stride{s}", "bias", None),
        (f"fast_stride{s}", "affine", None), (f"fast_stride{s}", None, "depth"),
        (f"tiles_stride{s}", None, None))
    for s in STRIDES
}
# Cross-checked against the CPU only: reference_default with the binding
# prior of the reference oracle's ``approx_prior`` case
# (tests/reference_oracle/make_goldens.py:243-258).
CROSS_ONLY = {"reference_prior": ("reference_default", {"sigma": 1e-9,
                                                         "reference_prior_energy": True})}
PRIOR_CONFIGS = ("fast_prior", "reference_prior")  # anchored at the previous motion
SESSIONS = ("tpu_fast", "parity_affine", "parity_esm", "tpu_accurate", "reference_default",
            "fast_prior", "fast_depth", "slam_tiles_cb48")
# The Gauss-Newton loop (lm_lambda0 unset).
GN_CONFIGS = ("reference_default", "reference_prior")
STREAMS = 8  # streams of the batched session
# The CLI phase: a TUM directory of CLI_FRAMES 640x480 frames written by
# ``apps.make_dataset --source synthetic --motion handheld-fr1``, tracked by
# ``apps.benchmark`` under each of CLI_CONFIGS (a shipped file, or a variant
# written out as JSON).  Bounds on the report's ATE and RPE: three times what
# the JAX package's own CLI reaches on the same directory on the CPU
# (``python -m tests.jax_smoke_scene --cli``): ate_mm, rpe_mm (translation)
# and rpe_deg (rotation), RMSE over the frames.  The JAX package's: tpu_fast
# 2.571 mm, 0.386 mm, 0.0127 deg; fast_stride4 2.545 mm, 0.390 mm, 0.0127
# deg; esm_stride4 1.206 mm, 0.195 mm, 0.0065 deg (the port's CPU run within
# 3e-6 m of it on every pose).
CLI_FRAMES = 30
CLI_CONFIGS = ("tpu_fast", "fast_stride4", "esm_stride4")
CLI_BOUNDS = {
    "tpu_fast": {"ate_mm": 7.8, "rpe_mm": 1.2, "rpe_deg": 0.038},
    "fast_stride4": {"ate_mm": 7.7, "rpe_mm": 1.2, "rpe_deg": 0.039},
    "esm_stride4": {"ate_mm": 3.7, "rpe_mm": 0.59, "rpe_deg": 0.02},
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def phase_environment(smi: str) -> dict:
    nvcc = build.nvcc_path()
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[-1]
    try:
        import triton  # noqa: F401

        have_triton = True
    except ImportError:
        have_triton = False
    info = {
        "phase": "environment",
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc,
        "nvcc_version": nvcc_version,
        "triton": have_triton,
        "device": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
        "tf32_cudnn": torch.backends.cudnn.allow_tf32,
    }
    if info["tf32_matmul"] or info["tf32_cudnn"]:
        raise AssertionError("TF32 must be off: the geometry runs in full f32")
    return info


def phase_build() -> dict:
    names = ("level_solver", "fused_iter", "stackwarp", "pyramid")
    t0 = time.perf_counter()
    paths = build.build(names)
    seconds = time.perf_counter() - t0
    registers = {
        n: [ln.strip() for ln in build.build_logs.get(n, "").splitlines()
            if "Compiling entry function" in ln or "registers" in ln or "spill" in ln]
        for n in names
    }
    return {
        "phase": "build",
        "seconds": seconds,
        "compiled": sorted(build.build_logs),
        "libraries": {n: str(p.relative_to(ROOT)) for n, p in paths.items()},
        "ptxas": registers,
    }


# ---------------------------------------------------------------------------
# Data: a seeded 640x480 scene, a 16-frame hand-held trajectory, exact truth.
# ---------------------------------------------------------------------------


def variant_config(name: str) -> RobustDVOConfig:
    """A configuration of ``VARIANTS``, ``CROSS_ONLY`` or ``KERNEL_ONLY``:
    its shipped base with overrides."""
    base, overrides = {**VARIANTS, **CROSS_ONLY, **KERNEL_ONLY}[name]
    data = json.loads((CONFIGS / f"{base}.json").read_text())
    return RobustDVOConfig.from_dict({**data, **overrides})


def config(name: str) -> RobustDVOConfig:
    """A shipped configuration or one of ``VARIANTS``, ``CROSS_ONLY`` and
    ``KERNEL_ONLY``."""
    if name in VARIANTS or name in CROSS_ONLY or name in KERNEL_ONLY:
        return variant_config(name)
    return RobustDVOConfig.from_json(CONFIGS / f"{name}.json")


def kernel_levels(cfg: RobustDVOConfig) -> int:
    """How many levels the level kernel may solve under ``cfg``: every level
    in a package without ``robust.level_plan``, whose tracker had no other
    solver (``profile_port.py --wall`` on an older checkout)."""
    if not hasattr(robust, "level_plan"):
        return cfg.levels
    return sum(robust.level_plan(cfg, lv).level_kernel for lv in range(cfg.levels))


def make_sequence():
    gray, depth, k = synthetic.textured_scene(HEIGHT, WIDTH, seed=SEED)
    poses = synthetic.handheld_trajectory(N_FRAMES, seed=SEED)
    grays, depths = synthetic.render_sequence(gray, depth, k, poses)
    return grays, depths, k, poses


def gt_transform(poses, i, j) -> np.ndarray:
    """Maps camera_i points into camera_j (the tracker's convention)."""
    return np.linalg.inv(poses[j]) @ poses[i]


def previous_motions(poses, pairs, dev) -> torch.Tensor:
    """The prior's anchors of ``pairs`` (i, j): the true motion of frames
    (i-1, i), the identity for i = 0 -> (B, 4, 4)."""
    return torch.as_tensor(
        np.stack([gt_transform(poses, i - 1, i) if i > 0 else np.eye(4) for i, _ in pairs]),
        dtype=torch.float32, device=dev,
    )


def pose_errors(est: np.ndarray, gt: np.ndarray):
    """-> (translation error m, rotation error rad) of est against gt."""
    e = np.linalg.inv(gt.astype(np.float64)) @ est.astype(np.float64)
    r = e[..., :3, :3]
    skew = np.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                     r[..., 1, 0] - r[..., 0, 1]], axis=-1)
    ang = np.arctan2(0.5 * np.linalg.norm(skew, axis=-1),
                     0.5 * (np.trace(r, axis1=-2, axis2=-1) - 1))
    return np.linalg.norm(e[..., :3, 3], axis=-1), ang


# ---------------------------------------------------------------------------
# Kernels against their plain versions.
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int, dev) -> float:
    """Median device time of ``fn`` over ``reps`` runs, each after writing a
    buffer larger than the 50 MB L2 so that the inputs come from HBM, as
    they do on the main path.  The card then spins for about a millisecond
    before the start event, so that the host has queued the launch by the
    time the event is reached: a launch's host-side cost (tens of
    microseconds through the wrapper) is not counted as device time."""
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def field_errors(a: torch.Tensor, b: torch.Tensor, cols) -> dict:
    out = {}
    for name, sl in cols.items():
        x, y = a[:, sl].double(), b[:, sl].double()
        diff = float((x - y).abs().max())
        scale = float(y.abs().max())
        out[name] = {"max_abs": diff, "max_rel": diff / max(scale, 1e-30)}
    return out


LEVEL_FIELDS = {
    "est": slice(0, 12), "anchor": slice(16, 28), "wlam": slice(32, 33),
    "lm_lambda": slice(33, 34), "err": slice(34, 35), "count": slice(35, 36),
    "iterations": slice(36, 37),
}
FUSED_FIELDS = {
    "H": slice(0, 36), "rhs": slice(36, 42), "err": slice(42, 43),
    "count": slice(43, 44), "lam": slice(44, 45),
}


def kernel_batch(frames, poses, dev, batch):
    """``batch`` consecutive pairs (i, i+1), cycling over the sequence, for
    the kernel checks: -> (prev, curr, the true transforms, the pairs)."""
    pairs = [(i % (N_FRAMES - 1), i % (N_FRAMES - 1) + 1) for i in range(batch)]
    prev = stack_frame_data([frames[i] for i, _ in pairs])
    curr = stack_frame_data([frames[j] for _, j in pairs])
    gt = torch.as_tensor(
        np.stack([gt_transform(poses, i, j) for i, j in pairs]), dtype=torch.float32,
        device=dev,
    )
    return prev, curr, gt, pairs


def start_estimates(gt: torch.Tensor, level: int) -> torch.Tensor:
    """Level-start estimates: identity at the coarsest level; at level 0 the
    truth off by a seeded ~2 mm / 0.1 deg, as a coarse level leaves it."""
    b = gt.shape[0]
    if level == LEVELS - 1:
        return torch.eye(4, device=gt.device).expand(b, 4, 4).contiguous()
    rng = np.random.default_rng(SEED + level)
    xi = np.concatenate(
        [rng.normal(0, 2e-3, (b, 3)), rng.normal(0, 2e-3, (b, 3))], axis=1
    ).astype(np.float32)
    return se3.exp(torch.as_tensor(xi, device=gt.device)) @ gt


def level_case(prev, curr, gt, cam, dev, level, illum, rel, cfg_name="tpu_fast", term=None,
               anchors=None):
    """The level kernel's inputs at one level of the batch, from the
    level-start estimates, under the configuration ``cfg_name`` (with its
    row blocks or tiles, one window each): -> (args, kwargs) of
    ``lm_level``.  ``term``: "depth" adds the depth term's inputs at the
    configuration's weight and threshold; "prior" and "prior_reference" the
    motion prior (``PRIOR_SIGMA``, the consistent or the reference's energy)
    toward ``anchors`` (B, 4, 4)."""
    cfg = config(cfg_name)
    k = cam.at(level).to(dev)
    est0 = start_estimates(gt, level)
    depth = term == "depth"
    lv = robust.prepare_level(
        prev.gray[level], prev.depth_m[level], curr.gray[level], k, est0, cfg, level,
        depth_curr=curr.depth_m[level] if depth else None,
    )
    b = est0.shape[0]
    wlam0 = torch.full((b,), 1.0 / cfg.weighter.initial_sigma**2, device=dev)
    relt = None if rel is None else torch.full((b,), rel, device=dev)
    anchor0 = anchors if term in ("prior", "prior_reference") else est0
    inputs = robust.kernel_inputs(lv, est0, anchor0, wlam0, relt)
    kwargs = dict(
        robust.kernel_settings(cfg, level),
        image_h=curr.gray[level].shape[-2], image_w=curr.gray[level].shape[-1],
        illum_bias=illum == "bias", illum_affine=illum == "affine",
    )
    if depth:
        kwargs.update(depth_planes=inputs.depth_planes, zgrad=inputs.zgrad)
    elif term is not None:
        kwargs.update(sigma=PRIOR_SIGMA, reference_prior_energy=term == "prior_reference")
    return tuple(inputs[:5]), kwargs


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two float32 results are the same bit for bit: a kernel run
    twice on the same inputs must repeat (fixed summation order)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def level_agrees(out_k, out_p):
    """-> (ok, field errors, elements whose valid count or iterations
    differ) of level-kernel rows against plain rows.

    Up to B=8 (``STRICT_MAX_BATCH``) every field is held to its tolerance
    and counts and iterations must be equal.  At B=64 the transforms are
    held to ``pose_atol`` and the differing elements are counted, not
    refused.  Both sides add in float64 and round once, so their totals
    agree bit for bit unless a float64 total lies within its rounding
    error of a float32 rounding boundary; over 64 elements x 76,800
    pixels that happens now and then, the pose then differs in its last
    bit, a template pixel on a validity edge (the ball, the image bounds)
    is counted on one side only, and the LM runs may part by an
    iteration.  With float32 sums, whose totals depend on their order, the
    PR 2 kernel parted from the plain version on 2-8 of the 64 elements in
    every level-0 case (PERF.md)."""
    errs = field_errors(out_k, out_p, LEVEL_FIELDS)
    differing = int(((out_k[:, 35] != out_p[:, 35]) | (out_k[:, 36] != out_p[:, 36])).sum())
    ok = (
        bool(torch.isfinite(out_k).all())
        and errs["est"]["max_abs"] <= TOLERANCES["pose_atol"]
        and errs["anchor"]["max_abs"] <= TOLERANCES["pose_atol"]
    )
    if out_k.shape[0] <= STRICT_MAX_BATCH:
        ok = (
            ok
            and errs["err"]["max_rel"] <= TOLERANCES["scale_rtol"]
            and errs["wlam"]["max_rel"] <= TOLERANCES["scale_rtol"]
            and differing == 0
        )
    return ok, errs, differing


def check_level_geometries(prev, curr, gt, cam, dev, level):
    """The level kernel (affine, rel. tolerance) at every cluster size that
    fits the level, with resident and streamed inputs wherever they fit,
    against one plain run: the geometries the wrapper may choose at other
    batch sizes and on other cards."""
    args, kwargs = level_case(prev, curr, gt, cam, dev, level, "affine", 0.01)
    hp, wp = args[1].shape[-2:]
    out_p = lm_level_plain(*args, **kwargs)
    runs = []
    for geo in level_solver.geometries(hp, wp, level_solver.LEVEL_KERNEL):
        out_k = level_solver._launch(*args, **kwargs, geometry=geo)
        torch.cuda.synchronize()
        ok, errs, differing = level_agrees(out_k, out_p)
        ms = time_ms(lambda: level_solver._launch(*args, **kwargs, geometry=geo), 5, dev)
        runs.append({"cluster": geo.cluster, "inputs": "resident" if geo.resident else "streamed",
                     "ok": ok, "ms": ms, "elements_differing": differing,
                     "est_max_abs": errs["est"]["max_abs"],
                     "err_max_rel": errs["err"]["max_rel"],
                     "wlam_max_rel": errs["wlam"]["max_rel"],
                     "count_max_abs": errs["count"]["max_abs"],
                     "iterations_max_abs": errs["iterations"]["max_abs"]})
    return {"phase": "kernel", "kernel": "level_solver_geometries", "level": level,
            "batch": args[1].shape[0], "shape": [hp, wp], "illumination": "affine",
            "ok": all(r["ok"] for r in runs), "runs": runs}


def check_level_kernel(prev, curr, gt, cam, dev, level, illum, rel, term=None, anchors=None,
                       cfg_name="tpu_fast"):
    """The level kernel against its plain version on one case (``term``,
    ``anchors`` and ``cfg_name``: as ``level_case``); with the prior, also
    how far it moves the kernel's solve from the same case without it."""
    args, kwargs = level_case(prev, curr, gt, cam, dev, level, illum, rel, cfg_name, term=term,
                              anchors=anchors)
    points = args[1]
    b, s = points.shape[0], kwargs["grid_stride"]
    depth = term == "depth"
    # Imported here, so that profile_port.py can load this file on a
    # checkout older than row blocks.
    from dense_visual_odometry_torch.ops.shiftwarp import window_layout

    layout = window_layout(points.shape[-2], points.shape[-1], kwargs["radius"], s,
                           kwargs.get("n_blocks", 1), kwargs.get("n_blocks_x", 1),
                           kwargs.get("radius_y"))
    geo = level_solver.launch_geometry(points, s, kwargs["illum_bias"], kwargs["illum_affine"],
                                       depth=depth,
                                       centres=level_solver.centre_floats(layout))
    out_k = lm_level(*args, **kwargs)
    repeats = bit_equal(out_k, lm_level(*args, **kwargs))
    out_p = lm_level_plain(*args, **kwargs)
    torch.cuda.synchronize()
    ok, errs, differing = level_agrees(out_k, out_p)
    bit_equal_plain = bit_equal(out_k, out_p)
    ok = ok and repeats
    key = (level, b, illum, term)
    if cfg_name != "tpu_fast":
        key = (cfg_name, *key)
    if b <= STRICT_MAX_BATCH and key not in LAST_BIT_CASES:
        ok = ok and bit_equal_plain
    extra = {}
    if term in ("prior", "prior_reference"):
        plain_kw = {n: v for n, v in kwargs.items()
                    if n not in ("sigma", "reference_prior_energy")}
        moved = float((out_k[:, :12] - lm_level(*args, **plain_kw)[:, :12]).abs().max())
        extra = {"sigma": PRIOR_SIGMA, "prior_moved_max_abs": moved}
        # The prior binds, wherever an anchor is not the identity (B=1 holds
        # the sequence's first pair alone, whose anchor is).
        if bool((anchors - torch.eye(4, device=dev)).abs().max() > 0):
            ok = ok and moved > 1e-6
    its_k = out_k[:, 36].cpu().numpy()
    its_p = out_p[:, 36].cpu().numpy()
    ms = time_ms(lambda: lm_level(*args, **kwargs), 10, dev)
    plain_ms = None
    if b <= PLAIN_TIMED_MAX_BATCH:
        plain_ms = time_ms(lambda: lm_level_plain(*args, **kwargs), 2, dev)
    npx = points.shape[-2] * points.shape[-1]
    inputs = list(args[1:]) + ([kwargs["zgrad"]] if depth else [])
    nbytes = (4 * sum(t.numel() for t in inputs) + 4 * out_k.numel()
              + window_bytes(args, kwargs, 2 if depth else 1))
    per_valid = OPS_VALID + (OPS_DEPTH if depth else 0)
    ops = float(
        (out_k[:, 36].double() * (npx * OPS_WARP + out_k[:, 35].double() * per_valid)).sum()
    )
    return {
        "phase": "kernel", "kernel": "level_solver", "config": cfg_name, "level": level,
        "grid_stride": s, "batch": b, "shape": list(args[2].shape), "illumination": illum,
        "rel": rel, "term": term, **extra,
        "blocks": {"rows": layout.nby, "cols": layout.nbx, "block": [layout.t_y, layout.t_x],
                   "window": [layout.ph, layout.pw], "radius": [layout.radius, layout.radius_y]},
        "bit_equal_plain": bit_equal_plain,
        "geometry": {"cluster": geo.cluster, "pixels_per_cta": geo.band_pixels,
                     "shared_bytes": geo.shared_bytes,
                     "inputs": "resident" if geo.resident else "streamed",
                     "max_active_clusters": geo.max_active_clusters},
        "ok": ok, "repeats": repeats, "errors": errs, "elements_differing": differing,
        "iterations_kernel": its_k.tolist(), "iterations_plain": its_p.tolist(),
        "ms": ms, "plain_ms": plain_ms,
        "bytes": nbytes, "ops": ops, **bound(nbytes, ops),
    }


def fused_case(prev, curr, gt, cam, dev, illum, level=0, cfg_name="tpu_fast"):
    """The fused kernel's inputs at ``level`` under ``configs/<cfg_name>.json``:
    the level kernel's (``level_case``), whose level-start pose and lambda it
    evaluates; -> (args, kwargs) of ``fused_evaluation``."""
    args, kwargs = level_case(prev, curr, gt, cam, dev, level, illum, None, cfg_name)
    return args, dict(fused_iter.fused_settings(kwargs), image_h=kwargs["image_h"],
                      image_w=kwargs["image_w"])


def fused_agrees(out_k, out_p):
    """-> (ok, field errors, elements that differ in any field) of
    fused-kernel rows against plain rows.

    The warp and the masks depend on the pose alone, so the valid counts
    are always equal.  Up to B=8 (``STRICT_MAX_BATCH``) every field must be
    equal bit for bit, as both sides add in float64 and round once.  At
    B=64 the Hessian, rhs, error and lambda are held to ``sum_rtol`` of
    their largest magnitude and the elements that part are counted (a
    float64 total within its error of a float32 rounding boundary)."""
    errs = field_errors(out_k, out_p, FUSED_FIELDS)
    differing = int((out_k != out_p).any(dim=1).sum())
    ok = bool(torch.isfinite(out_k).all()) and errs["count"]["max_abs"] == 0.0
    if out_k.shape[0] <= STRICT_MAX_BATCH:
        ok = ok and differing == 0
    else:
        ok = ok and all(errs[f]["max_rel"] <= TOLERANCES["sum_rtol"]
                        for f in ("H", "rhs", "err", "lam"))
    return ok, errs, differing


def fused_geometry(points, kwargs):
    return level_solver.launch_geometry(points, kwargs["grid_stride"], kwargs["illum_bias"],
                                        kernel=fused_iter.FUSED_KERNEL)


def check_fused_kernel(prev, curr, gt, cam, dev, illum, level=0, cfg_name="tpu_fast"):
    args, kwargs = fused_case(prev, curr, gt, cam, dev, illum, level, cfg_name)
    points = args[1]
    b = points.shape[0]
    geo = fused_geometry(points, kwargs)
    out_k = fused_iter.fused_evaluation(*args, **kwargs)
    repeats = bit_equal(out_k, fused_iter.fused_evaluation(*args, **kwargs))
    out_p = fused_iter.fused_evaluation_plain(*args, **kwargs)
    torch.cuda.synchronize()
    ok, errs, differing = fused_agrees(out_k, out_p)
    ok = ok and repeats
    ms = time_ms(lambda: fused_iter.fused_evaluation(*args, **kwargs), 20, dev)
    plain_ms = time_ms(lambda: fused_iter.fused_evaluation_plain(*args, **kwargs), 3, dev)
    npx = points.shape[-2] * points.shape[-1]
    nbytes = (4 * sum(t.numel() for t in args[1:]) + 4 * out_k.numel()
              + window_bytes(args, kwargs))
    ops = float(b * npx * OPS_WARP + out_k[:, 43].double().sum() * OPS_VALID)
    return {
        "phase": "kernel", "kernel": "fused_iter", "config": cfg_name, "level": level,
        "grid_stride": kwargs["grid_stride"], "batch": b, "shape": list(args[2].shape),
        "illumination": illum,
        "geometry": {"cluster": geo.cluster, "pixels_per_cta": geo.band_pixels,
                     "shared_bytes": geo.shared_bytes,
                     "max_active_clusters": geo.max_active_clusters},
        "ok": ok, "repeats": repeats, "errors": errs, "elements_differing": differing,
        "ms": ms, "plain_ms": plain_ms, "bytes": nbytes, "ops": ops, **bound(nbytes, ops),
    }


def check_fused_geometries(prev, curr, gt, cam, dev):
    """The fused kernel (bias) at every cluster size that fits level 0,
    against one plain run, timed: the sweep the geometry rule follows."""
    args, kwargs = fused_case(prev, curr, gt, cam, dev, "bias")
    hp, wp = args[1].shape[-2:]
    out_p = fused_iter.fused_evaluation_plain(*args, **kwargs)
    runs = []
    for geo in level_solver.geometries(hp, wp, fused_iter.FUSED_KERNEL):
        out_k = fused_iter._launch(*args, **kwargs, geometry=geo)
        torch.cuda.synchronize()
        ok, errs, differing = fused_agrees(out_k, out_p)
        ms = time_ms(lambda: fused_iter._launch(*args, **kwargs, geometry=geo), 10, dev)
        runs.append({"cluster": geo.cluster, "ok": ok, "ms": ms,
                     "elements_differing": differing, "H_max_rel": errs["H"]["max_rel"]})
    return {"phase": "kernel", "kernel": "fused_iter_geometries", "level": 0,
            "batch": args[1].shape[0], "shape": [hp, wp], "illumination": "bias",
            "chosen": fused_geometry(args[1], kwargs).cluster,
            "ok": all(r["ok"] for r in runs), "runs": runs}


def stack_case(prev, curr, gt, cam, dev, level, cfg_name="tpu_parity"):
    """The stack kernel's inputs: the frozen window of a level at its start
    estimates under ``cfg_name`` (``configs/tpu_parity.json`` by default, a
    stride variant's at strides 3 and 4), the displacements of the
    template grid, and ``F.grid_sample`` on the same samples (the library
    yardstick, bilinear, zeros outside the image): -> (args of
    ``stack_accumulate``, valid pixels, the library call)."""
    cfg = config(cfg_name)
    s = cfg.stride_for_level(level)
    r = cfg.shift_stack_radius
    k = cam.at(level).to(dev)
    est0 = start_estimates(gt, level)
    image = curr.gray[level]
    fl = robust.prepare_level(
        prev.gray[level], prev.depth_m[level], image, k, est0, cfg, level
    )
    image_h, image_w = image.shape[-2:]
    du, dv, in_ball = residual_displacements(fl.u0, fl.v0, fl.cu, fl.cv, r, s, image_h, image_w)
    grid = torch.stack(
        [2.0 * fl.u0 / (image_w - 1) - 1.0, 2.0 * fl.v0 / (image_h - 1) - 1.0], dim=-1
    )

    def library():
        return F.grid_sample(image[:, None], grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)[:, 0]

    args = (fl.planes, du.contiguous(), dv.contiguous(), r, s)
    return args, in_ball & fl.valid_geom0, library


def check_stack_kernel(prev, curr, gt, cam, dev, level, cfg_name="tpu_parity"):
    """The stack kernel against ``tent_sample`` and ``F.grid_sample``."""
    args, valid, library = stack_case(prev, curr, gt, cam, dev, level, cfg_name)
    planes, du, dv, r, s = args
    out_k = stack_accumulate(*args)
    out_p = tent_sample(*args)
    out_l = library()
    torch.cuda.synchronize()
    kv, pv = out_k[valid].double(), out_p[valid].double()
    diff = float((kv - pv).abs().max())
    scale = float(pv.abs().max())
    errors = {"samples": {"max_abs": diff, "max_rel": diff / max(scale, 1e-30)}}
    ok = (
        bool(torch.isfinite(out_k[valid]).all())
        and int(valid.sum()) > 0
        and errors["samples"]["max_rel"] <= TOLERANCES["sample_rtol"]
    )
    ms = time_ms(lambda: stack_accumulate(*args), 20, dev)
    plain_ms = time_ms(lambda: tent_sample(*args), 5, dev)
    library_ms = time_ms(library, 20, dev)
    npx = du.numel()
    nbytes = 4 * 3 * npx + tap_bytes(planes, du, dv, r, r, s)
    ops = float(npx * OPS_STACK)
    return {
        "phase": "kernel", "kernel": "stackwarp", "config": cfg_name, "level": level,
        "grid_stride": s,
        "batch": du.shape[0], "shape": list(du.shape), "valid_pixels": int(valid.sum()),
        "ok": ok,
        "errors": errors,
        "library_max_abs_diff": float((out_l[valid].double() - kv).abs().max()),
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bytes": nbytes, "ops": ops, **bound(nbytes, ops),
    }


def check_pyramid_kernel(frames, dev, batch, level):
    """The pyramid kernel against the plain network (``median3x3`` then the
    even rows and columns) on the gray and the depth images of ``level``
    of ``batch`` frames (the sequence repeated): equal bit for bit; the
    times are the gray's.  Its bound: one read of the input and one write
    of the quarter-size output."""
    # Imported here, as in zero_launches and run: profile_port.py loads this
    # file on packages that predate the kernel.
    from dense_visual_odometry_torch.ops.cuda.pyramid import median_pyr_down

    idx = [i % len(frames) for i in range(batch)]
    images = {name: torch.stack([getattr(frames[i], name)[level] for i in idx])
              for name in ("gray", "depth_m")}

    def plain(x):
        return median3x3(x)[..., ::2, ::2].contiguous()

    equal = {}
    for name, x in images.items():
        before = median_pyr_down.launches
        out_k = median_pyr_down(x)
        if median_pyr_down.launches != before + 1:
            raise AssertionError("median_pyr_down did not launch its kernel")
        out_p = plain(x)
        torch.cuda.synchronize()
        equal[name] = bit_equal(out_k, out_p)
    gray = images["gray"]
    ms = time_ms(lambda: median_pyr_down(gray), 20, dev)
    plain_ms = time_ms(lambda: plain(gray), 10, dev)
    nbytes = 4 * (gray.numel() + gray[..., ::2, ::2].numel())
    return {
        "phase": "kernel", "kernel": "pyramid", "level": level, "batch": batch,
        "shape": list(gray.shape), "ok": all(equal.values()), "bit_equal": equal,
        "ms": ms, "plain_ms": plain_ms, "bytes": nbytes, **bound(nbytes, 0),
    }


def tap_bytes(planes, du, dv, radius, radius_y, s, valid=None, layout=None) -> int:
    """Bytes of the window taps a sampling must read: each distinct tap
    (floor(d) and floor(d) + 1 on each axis, inside [-r_y, r_y] x [-r, r],
    with a non-zero tent weight) of the pixels in ``valid`` (every pixel
    where None), once.  At strides 1 and 2 the pixels' taps cover about the
    whole window; at stride s >= 3 a pixel reads 2 x 2 of the s^2 parity
    planes' taps around it, and the rest of the window is never read."""
    b, ph, pw = planes.shape[0], planes.shape[-2], planes.shape[-1]
    hp, wp = du.shape[-2:]
    dev = du.device
    per_element = planes[0].numel()
    if layout is None or layout.blocks == 1:
        base = torch.zeros((), dtype=torch.int64, device=dev)
        ii, jj = torch.arange(hp, device=dev)[:, None], torch.arange(wp, device=dev)[None, :]
    else:
        from dense_visual_odometry_torch.ops.shiftwarp import block_index

        blk, il, jl = block_index(layout, hp, wp, dev)
        base, ii, jj = blk * (s * s * ph * pw), il[:, None], jl[None, :]
    finite = torch.isfinite(du) & torch.isfinite(dv)
    keep0 = finite if valid is None else finite & valid
    du, dv = torch.nan_to_num(du), torch.nan_to_num(dv)
    fy, fx = torch.floor(dv), torch.floor(du)
    element = torch.arange(b, device=dev)[:, None, None] * per_element
    taps = []
    for ty in (0, 1):
        ky = fy + ty
        wy = torch.clamp(1.0 - torch.abs(dv - ky), min=0.0)
        for tx in (0, 1):
            kx = fx + tx
            wx = torch.clamp(1.0 - torch.abs(du - kx), min=0.0)
            keep = (keep0 & (ky >= -radius_y) & (ky <= radius_y) & (kx >= -radius)
                    & (kx <= radius) & (wy * wx > 0))
            a = torch.clamp(radius_y + ky, 0, 2 * radius_y).long()
            c = torch.clamp(radius + kx, 0, 2 * radius).long()
            flat = (element + base + ((a % s) * s + c % s) * (ph * pw)
                    + (a // s + ii) * pw + (c // s + jj))
            taps.append(flat[keep])
    return 4 * int(torch.unique(torch.cat(taps)).numel())


def start_displacements(args, kwargs):
    """The displacements of a level or fused case's template grid at the
    pose of its scalar row, and the pixels its evaluation keeps (inside the
    ball, in bounds, in front): -> (du, dv, valid, layout), as
    ``level_solver.level_evaluation`` computes them."""
    from dense_visual_odometry_torch.ops.shiftwarp import window_layout

    planes, points, _, _, scal = args
    hp, wp = points.shape[-2:]
    s = kwargs["grid_stride"]
    layout = window_layout(hp, wp, kwargs["radius"], s, kwargs.get("n_blocks", 1),
                           kwargs.get("n_blocks_x", 1), kwargs.get("radius_y"))
    est = [scal[:, k][:, None, None] for k in range(12)]
    px, py, pz = points[:, 0], points[:, 1], points[:, 2]
    xp = est[0] * px + est[1] * py + est[2] * pz + est[3]
    yp = est[4] * px + est[5] * py + est[6] * pz + est[7]
    zp = est[8] * px + est[9] * py + est[10] * pz + est[11]
    in_front = zp > 1e-6
    z_safe = torch.where(in_front, zp, torch.ones_like(zp))
    fx, fy, cx, cy = (scal[:, k][:, None, None] for k in (33, 34, 35, 36))
    u = (fx * xp + cx * zp) / z_safe
    v = (fy * yp + cy * zp) / z_safe
    cu, cv = level_solver.centre_maps(scal, layout, hp, wp)
    col = torch.arange(wp, dtype=torch.float32, device=u.device)[None, None, :]
    row = torch.arange(hp, dtype=torch.float32, device=u.device)[None, :, None]
    du = u - (col * float(s) + cu)
    dv = v - (row * float(s) + cv)
    in_ball = ((du > -layout.radius) & (du < layout.radius) & (dv > -layout.radius_y)
               & (dv < layout.radius_y))
    in_bounds = ((torch.floor(u) >= 0) & (torch.floor(v) >= 0)
                 & (torch.floor(u) + 1 <= kwargs["image_w"] - 1)
                 & (torch.floor(v) + 1 <= kwargs["image_h"] - 1))
    return du, dv, in_ball & in_bounds & in_front, layout


def window_bytes(args, kwargs, windows: int = 1) -> int:
    """The bytes of ``windows`` frozen windows (the photometric one, and with
    the depth term the depth one, at the same taps) that a level or fused
    case's evaluation at its start pose reads (``tap_bytes``); the level
    kernel's later iterations move the pose by a fraction of a pixel."""
    du, dv, valid, layout = start_displacements(args, kwargs)
    return windows * tap_bytes(args[0], du, dv, layout.radius, layout.radius_y,
                               kwargs["grid_stride"], valid, layout)


def bound(nbytes: float, ops: float) -> dict:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


# ---------------------------------------------------------------------------
# The main path.
# ---------------------------------------------------------------------------


def batch_inputs(frames, poses, pairs, dev, anchored):
    """``batched_track_pair``'s inputs for ``pairs``: -> (prev, curr, the
    prior's anchors or None); ``anchored``: each pair's prior anchored at the
    previous pair's true motion (``previous_motions``)."""
    return (stack_frame_data([frames[i] for i, _ in pairs]),
            stack_frame_data([frames[j] for _, j in pairs]),
            previous_motions(poses, pairs, dev) if anchored else None)


def track(frames, poses, k, cfg, pairs, anchored):
    """``batched_track_pair`` on ``pairs`` (``anchored``: as ``batch_inputs``)."""
    prev, curr, last = batch_inputs(frames, poses, pairs, k.device, anchored)
    return batched_track_pair(prev, curr, k, cfg, last_transform=last)


def kernel_path_pairs(frames, poses, k, cfg, pairs, anchored=False) -> list:
    """The pairs that the hard-motion trigger passes, when tracked alone, at
    every level the level kernel may solve: their solves launch it once at
    each of those levels."""
    keep = []
    for pair in pairs:
        before = lm_level.launches
        track(frames, poses, k, cfg, [pair], anchored)
        if lm_level.launches - before == kernel_levels(cfg):
            keep.append(pair)
    return keep


def run_batched(frames, poses, k, cfg, pairs, reps=3, anchored=False):
    """-> (the run's row, its transforms (B, 4, 4)); ``anchored`` as
    ``batch_inputs``.  The batch is built before the warm-up, outside the
    timed calls."""
    rows = (pairs * (-(-MAIN_BATCH // len(pairs))))[:MAIN_BATCH]
    prev, curr, last = batch_inputs(frames, poses, rows, k.device, anchored)
    gt = np.stack([gt_transform(poses, i, j) for i, j in rows])
    before = lm_level.launches
    fused_before = fused_iter.fused_evaluation.launches
    result = batched_track_pair(prev, curr, k, cfg, last_transform=last)  # warm-up
    result.transform.cpu()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        result = batched_track_pair(prev, curr, k, cfg, last_transform=last)
        transform = result.transform.cpu().numpy()
        times.append(time.perf_counter() - t0)
    terr, rerr = pose_errors(transform, gt)
    return {
        "batch": MAIN_BATCH,
        "reps": reps,
        "frames_per_s": MAIN_BATCH / float(np.median(times)),
        "batch_ms": [t * 1e3 for t in times],
        "all_success": bool(result.success.all()),
        "finite": bool(np.isfinite(transform).all()),
        "translation_err_mm_median": float(np.median(terr) * 1e3),
        "translation_err_mm_max": float(np.max(terr) * 1e3),
        "rotation_err_deg_median": float(np.degrees(np.median(rerr))),
        "rotation_err_deg_max": float(np.degrees(np.max(rerr))),
        "iterations_per_level": result.diagnostics.iterations.cpu().tolist(),
        "level_kernel_launches_per_call": (lm_level.launches - before) / (reps + 1),
        "fused_launches_per_call":
            (fused_iter.fused_evaluation.launches - fused_before) / (reps + 1),
    }, transform


def run_session(grays, depths, cam, cfg, poses, dev):
    session = OdometrySession(cam, cfg, device=dev)
    frame_ms, est, success = [], [], []
    for g, d in zip(grays, depths):
        t0 = time.perf_counter()
        pose = session.step(g, d).matrix.cpu().numpy()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        est.append(pose)
        success.append(bool(session.last_output.success))
    gt = np.einsum("ij,njk->nik", np.linalg.inv(poses[0]), poses)
    terr, rerr = pose_errors(np.stack(est), gt)
    return {
        "frames": len(frame_ms),
        "median_frame_ms": float(np.median(frame_ms[2:])),
        "frame_ms": frame_ms,
        "all_success": all(success),
        "finite": bool(np.isfinite(np.stack(est)).all()),
        "translation_err_mm_max": float(np.max(terr) * 1e3),
        "translation_err_mm_final": float(terr[-1] * 1e3),
        "rotation_err_deg_max": float(np.degrees(np.max(rerr))),
    }


def run_batched_session(grays, depths, cam, cfg, poses, dev):
    """``STREAMS`` streams in lockstep through ``BatchedOdometrySession``:
    even streams play the sequence forwards, odd ones backwards."""
    # Imported here, so that profile_port.py can load this file on a
    # checkout older than the batched session.
    from dense_visual_odometry_torch.models.batched_session import BatchedOdometrySession

    order = [list(range(N_FRAMES))[:: 1 if s % 2 == 0 else -1] for s in range(STREAMS)]
    session = BatchedOdometrySession(cam, cfg, batch=STREAMS, device=dev)
    step_ms, est, success = [], [], []
    for t in range(N_FRAMES):
        images = np.stack([grays[o[t]] for o in order])
        depth = np.stack([depths[o[t]] for o in order])
        t0 = time.perf_counter()
        est.append(session.step(images, depth).cpu().numpy())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        success.append(bool(session.last_output.success.all()))
    est = np.stack(est, axis=1)  # (streams, frames, 4, 4)
    gt = np.stack([np.einsum("ij,njk->nik", np.linalg.inv(poses[o[0]]), poses[o]) for o in order])
    terr, rerr = pose_errors(est, gt)
    median_s = float(np.median(step_ms[2:])) / 1e3
    return {
        "streams": STREAMS, "frames": N_FRAMES,
        "median_step_ms": median_s * 1e3, "frames_per_s": STREAMS / median_s,
        "step_ms": step_ms,
        "all_success": all(success),
        "finite": bool(np.isfinite(est).all()),
        "translation_err_mm_max": float(np.max(terr) * 1e3),
        "rotation_err_deg_max": float(np.degrees(np.max(rerr))),
    }


def cli_dataset(root: Path):
    """Write the CLI phase's TUM directory into ``root`` with the port's
    ``make_dataset`` and a camera YAML beside it (the TUM fr1 pinhole, 5000
    DN per metre): -> (directory, camera YAML)."""
    from dense_visual_odometry_torch.apps import make_dataset

    make_dataset.main(["-o", str(root / "seq"), "--frames", str(CLI_FRAMES),
                       "--motion", "handheld-fr1", "--source", "synthetic",
                       "--seed", str(SEED)])
    cam = root / "camera.yaml"
    cam.write_text(f"intrinsics: {synthetic.TUM_FR1_INTRINSICS.astype(float).tolist()}\n"
                   f"depth_scale: {1.0 / make_dataset.TUM_DN_PER_M}\n")
    return root / "seq", cam


def config_file(name: str, root: Path) -> Path:
    """A configuration's JSON file: the shipped one, or a variant's base with
    its overrides written into ``root``."""
    if name not in VARIANTS:
        return CONFIGS / f"{name}.json"
    base, overrides = VARIANTS[name]
    path = root / f"{name}.json"
    path.write_text(json.dumps({**json.loads((CONFIGS / f"{base}.json").read_text()),
                                **overrides}))
    return path


def run_cli(root: Path) -> dict:
    """The CLI phase: ``make_dataset`` writes a TUM directory into ``root``,
    ``apps.benchmark`` tracks it on the card under each of ``CLI_CONFIGS``
    and writes its report and trajectory, ``apps.evaluate`` re-reads the
    trajectory; the launch counts zeroed just before the tracking and read
    just after.  Raises unless every run reports on the card, its ATE and
    RPE lie within ``CLI_BOUNDS``, ``evaluate`` agrees with the report's ATE,
    and each kernel launched (each at a grid stride >= 3 too)."""
    import contextlib
    import io

    from dense_visual_odometry_torch.apps import benchmark, evaluate
    from dense_visual_odometry_torch.io.datasets import frame_route, load_tum_sequence

    out = {"phase": "cli", "frames": CLI_FRAMES, "image": [HEIGHT, WIDTH]}
    t0 = time.perf_counter()
    seq_dir, cam = cli_dataset(root)
    out["make_dataset_s"] = time.perf_counter() - t0
    out["decode_route"] = frame_route()
    n_read = len(load_tum_sequence(seq_dir, camera_yaml=cam))
    zero_launches()
    for name in CLI_CONFIGS:
        run_dir = root / f"out_{name}"
        summary = benchmark.run(benchmark.parse_args(
            ["tum", "-d", str(seq_dir), "--camera", str(cam),
             "-c", str(config_file(name, root)), "-o", str(run_dir)]))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = evaluate.main([str(run_dir / "trajectory.txt"),
                                str(seq_dir / "groundtruth.txt")])
        scored = json.loads(buf.getvalue().strip().splitlines()[-1])
        out[name] = {
            **summary, "evaluate_rc": rc, "evaluate_ate_rmse_m": scored.get("ate_rmse_m"),
            "written": sorted(p.name for p in run_dir.iterdir()),
            "frames_per_total_s": summary["frames"] / summary["total_time_s"],
            "read_share": summary["read_s"] / summary["total_time_s"],
        }
    out["launches"], out["runtime_stride_launches"] = read_launches()
    emit(out)
    fast = out["tpu_fast"]
    print(f"cli decode route: {out['decode_route']}", flush=True)
    print(f"cli frames/s: {fast['fps']} (tpu_fast, {HEIGHT}x{WIDTH}, the tracking step after "
          f"the first frame); {fast['frames_per_total_s']} over the whole run, reading "
          f"{fast['read_share']} of it", flush=True)
    print(f"cli ms per frame: {fast['mean_frame_ms']} mean, {fast['median_frame_ms']} median, "
          f"first frame {fast['first_frame_s'] * 1e3} ms", flush=True)
    backend = f"cuda:{torch.cuda.get_device_name(0)}"
    for name in CLI_CONFIGS:
        r, bounds = out[name], CLI_BOUNDS[name]
        if r["backend"] != backend or r["frames"] != n_read:
            raise AssertionError(f"cli {name}: ran on {r['backend']} over {r['frames']} frames")
        if r["written"] != ["report.json", "trajectory.txt"] or r["evaluate_rc"] != 0:
            raise AssertionError(f"cli {name}: wrote {r['written']}, evaluate {r['evaluate_rc']}")
        if abs(r["evaluate_ate_rmse_m"] - r["ate_rmse_m"]) > 1e-5:
            raise AssertionError(f"cli {name}: evaluate's ATE {r['evaluate_ate_rmse_m']} is not "
                                 f"the report's {r['ate_rmse_m']}")
        if (r["ate_rmse_m"] * 1e3 > bounds["ate_mm"]
                or r["rpe_trans_rmse_m"] * 1e3 > bounds["rpe_mm"]
                or np.degrees(r["rpe_rot_rmse_rad"]) > bounds["rpe_deg"]):
            raise AssertionError(f"cli {name}: ATE / RPE above the expected bound")
    if min(out["launches"].values()) < 1 or min(out["runtime_stride_launches"].values()) < 1:
        raise AssertionError(f"cli: a kernel never launched (at a grid stride >= 3): "
                             f"{out['launches']}, {out['runtime_stride_launches']}")
    return out


# ---------------------------------------------------------------------------
# Phase 6: the SLAM back end.
# ---------------------------------------------------------------------------

# (a) SlamSession on the smoke's scene under configs/tpu_slam.json.  The
# thresholds come from the scene's true motion: promoting on the truth, they
# give keyframes at frames 0, 4, 7, 9, 11, 13 and 15, every decision at
# least 13% away from its threshold (translation and rotation of the log of
# each frame's motion against its keyframe's).
SLAM_CONFIG = "tpu_slam"
SLAM_POLICY = {"max_translation": 0.024, "max_rotation": 0.055}
SLAM_MODES = {"direct": {}, "two_step": {"two_step_tracking": True}}
SLAM_MIN_KEYFRAMES = 4
# Bounds on the largest translation (mm) and rotation (deg) error against the
# truth, of the front-end poses and of ``optimized_trajectory``: three times
# the JAX package's on the same scene on the CPU (``python -m
# tests.jax_smoke_scene --slam``: direct 0.1157 mm, 0.00370 deg and 0.1146
# mm, 0.00367 deg; two-step 0.1084 mm, 0.00351 deg and 0.1074 mm, 0.00350
# deg; the same keyframes and loop closures as the port's CPU run, whose
# poses it meets within 1.7e-6).
SLAM_BOUNDS = {
    "direct": {"front_mm": 0.347, "front_deg": 0.0111,
               "optimized_mm": 0.344, "optimized_deg": 0.0110},
    "two_step": {"front_mm": 0.325, "front_deg": 0.0105,
                 "optimized_mm": 0.322, "optimized_deg": 0.0105},
}
SLAM_POSE_ATOL = 1e-4  # the card against the port's CPU path
STREAM_ATOL = 1e-5  # a batched stream against a SlamSession on the card
# (b) The loop closure and the relocalization: ``synthetic.revisit_sequence``
# at 640x480 (a sweep, blank frames lost through the error gate, a view near
# the start relocalized at keyframe 0, returns to earlier views closing loops)
# under the policy it is built for, ``synthetic.REVISIT_POLICY``.
# (d) BatchedSlamSession: SLAM_STREAMS gentle hand-held sequences (a fifth of
# the smoke's per-frame motion, seeds 1-4) and thresholds that keep each
# frame within a few pixels of its keyframe, so that the batch-global
# hard-motion trigger does not fire and every stream equals its own session
# (on the CPU bit for bit; with a third of the motion and 12 mm / 0.012 rad
# the streams part from their sessions by up to 4e-5).
SLAM_STREAMS = 4
STREAM_MOTION = {"t_step": 0.003, "r_step": 0.0015}
STREAM_POLICY = {"max_translation": 0.008, "max_rotation": 0.01}
# (e) The CLI on phase 5's directory, -m slam under tpu_slam (the default
# policy).  Bounds on the ATE (mm): three times the JAX package's CLI on the
# same directory on the CPU (``python -m tests.jax_smoke_scene --slam``:
# 0.0784, 0.0731 and 0.751 mm; the dense BA moves translations only, and
# the refined trajectory is the worse one there too).
SLAM_CLI_RUNS = {"slam": [], "slam_two_step": ["--slam-two-step"],
                 "slam_dense_refine": ["--dense-refine"]}
SLAM_CLI_BOUNDS = {"slam": 0.235, "slam_two_step": 0.219, "slam_dense_refine": 2.25}


# (e) Where ``--dense-refine``'s trajectory parts between the card and the
# CPU (``refine_sensitivity``): the keyframe translations are also moved by
# REFINE_PERTURB_M, the order by which the card's session parts from the
# CPU's before the refinement (2.6e-6 m), to show how the refinement
# answers such a difference.
REFINE_PERTURB_M = 1e-6


def slam_policy(**kw):
    from dense_visual_odometry_torch.models.slam import KeyframePolicy

    return KeyframePolicy(**kw)


def stream_sequences():
    """Phase 6 (d)'s SLAM_STREAMS sequences of N_FRAMES frames -> [(grays,
    depths)]."""
    gray, depth, k = synthetic.textured_scene(HEIGHT, WIDTH, seed=SEED)
    out = []
    for s in range(SLAM_STREAMS):
        poses = synthetic.handheld_trajectory(N_FRAMES, seed=s + 1, **STREAM_MOTION)
        out.append(synthetic.render_sequence(gray, depth, k, poses))
    return out


def host_reads(fn) -> int:
    """How many synchronizing device-to-host reads ``fn()`` makes, as
    ``torch.cuda.set_sync_debug_mode`` reports them."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def slam_errors(est: np.ndarray, truths) -> dict:
    """Largest translation (mm) and rotation (deg) error of ``est`` against
    the truths relative to the first frame (frames without truth skipped)."""
    idx = [n for n, t in enumerate(truths) if t is not None]
    gt = np.stack([np.linalg.inv(truths[0]) @ truths[n] for n in idx])
    terr, rerr = pose_errors(est[idx], gt)
    return {"mm": float(terr.max() * 1e3), "deg": float(np.degrees(rerr.max()))}


def slam_run(frames, cam, cfg, policy, dev, reads_at=None) -> dict:
    """One ``SlamSession`` over ``frames`` on ``dev`` -> its row and the
    session; with ``reads_at`` the host reads of that step are counted.  The
    row splits the promotions' time between the loop-closure verification
    and the window BA (both read their results back, so the host clock
    spans their device work)."""
    from dense_visual_odometry_torch.models.slam import SlamSession

    sess = SlamSession(cam, cfg, policy, device=dev)
    spent = {"loop_closure_ms": [], "window_ba_ms": []}

    def timed(name, fn):
        def run(*args):
            t0 = time.perf_counter()
            fn(*args)
            spent[name].append((time.perf_counter() - t0) * 1e3)
        return run

    sess._try_loop_closures = timed("loop_closure_ms", sess._try_loop_closures)
    sess._optimize_window = timed("window_ba_ms", sess._optimize_window)
    step_ms, reads = [], None
    for n, (g, d) in enumerate(frames):
        t0 = time.perf_counter()
        if n == reads_at and dev.type == "cuda":
            reads = host_reads(lambda: sess.step(g, d))
        else:
            sess.step(g, d)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return {
        "frames": len(frames), "keyframe_indices": list(sess.keyframe_indices),
        "loop_closures": [[a, b, e] for a, b, e in sess.loop_closures],
        "relocalizations": [list(r) for r in sess.relocalizations],
        "median_step_ms": float(np.median(step_ms[2:])), "step_ms": step_ms,
        "host_reads_per_step": reads, **spent,
    }, sess


def refine_sensitivity(seq_dir: Path, cam_yaml: Path, cfg, dev, root: Path) -> dict:
    """Where ``-m slam --dense-refine``'s trajectory parts between the card
    and the CPU.  A ``SlamSession`` under the CLI's default policy over the
    directory on each, ``optimize_full``, then ``refine_dense(update_depths=
    True)`` as the CLI runs it: on each from its own state, on the CPU from
    the card's state (a checkpoint), and on the card and on the CPU from that
    state with every keyframe but the first (which the gauge holds) moved by
    REFINE_PERTURB_M along each axis.  -> the keyframe poses' largest
    differences before and after, and each refined trajectory's ATE (mm)."""
    from dense_visual_odometry_torch import metrics
    from dense_visual_odometry_torch.io import checkpoint
    from dense_visual_odometry_torch.io.datasets import load_tum_sequence
    from dense_visual_odometry_torch.models.slam import SlamSession

    cpu = torch.device("cpu")
    seq = load_tum_sequence(str(seq_dir), camera_yaml=str(cam_yaml))
    gt = np.einsum("ij,njk->nik", np.linalg.inv(seq.gt_poses[0]), seq.gt_poses)
    sessions = {}
    for name, device in (("card", dev), ("cpu", cpu)):
        sess = SlamSession(seq.camera, cfg, device=device)
        for rgb, depth in seq:
            sess.step(rgb, depth)
        sess.optimize_full()
        sessions[name] = sess
    ckpt = checkpoint.save_slam_session(root / "refine.npz", sessions["card"])
    for name, device in (("cpu_from_card", cpu), ("card_moved", dev), ("cpu_moved", cpu)):
        sessions[name] = checkpoint.load_slam_session(ckpt, SlamSession(seq.camera, cfg,
                                                                         device=device))
    for name in ("card_moved", "cpu_moved"):
        for pose in sessions[name].keyframe_poses[1:]:
            pose[:3, 3] += REFINE_PERTURB_M
    before = {k: np.stack(s.keyframe_poses) for k, s in sessions.items()}
    for sess in sessions.values():
        sess.refine_dense(update_depths=True)
    after = {k: np.stack(s.keyframe_poses) for k, s in sessions.items()}

    def gap(a, b):
        return float(np.abs(a - b).max())

    return {
        "keyframe_indices": {k: list(s.keyframe_indices) for k, s in sessions.items()},
        "input_card_vs_cpu": gap(before["card"], before["cpu"]),
        "refined_card_vs_cpu": gap(after["card"], after["cpu"]),
        "same_state_card_vs_cpu": gap(after["card"], after["cpu_from_card"]),
        "moved_response": gap(after["card"], after["card_moved"]),
        "cpu_moved_response": gap(after["cpu_from_card"], after["cpu_moved"]),
        "ate_mm": {k: metrics.ate_rmse(s.optimized_trajectory(), gt)[0] * 1e3
                   for k, s in sessions.items()},
    }


def run_slam(grays, depths, k_np, poses, dev, root: Path) -> dict:
    """Phase 6 on ``dev``: (a) ``SlamSession`` direct and two-step on the
    smoke's scene, against the truth and the port's CPU path; (b) a loop
    closure and a relocalization; (c) ``refine_dense`` on (a)'s keyframes,
    against the CPU; (d) a ``BatchedSlamSession`` of SLAM_STREAMS streams
    against one ``SlamSession`` a stream; (e) the CLI's ``-m slam`` on
    phase 5's directory, and ``refine_sensitivity`` there.  The launch counts are zeroed just before and read
    just after; the CPU runs launch no kernel.  Raises on any failed check."""
    from dense_visual_odometry_torch.apps import benchmark
    from dense_visual_odometry_torch.io import checkpoint
    from dense_visual_odometry_torch.models.batched_slam import BatchedSlamSession
    from dense_visual_odometry_torch.models.slam import SlamSession

    cpu = torch.device("cpu")
    cam = CameraModel.create(k_np, 1.0)  # rendered depth is already metric
    cfg = config(SLAM_CONFIG)
    frames = list(zip(grays, depths))
    truths = list(poses)
    out = {"phase": "slam", "image": [HEIGHT, WIDTH], "config": SLAM_CONFIG}
    zero_launches()
    t_phase = time.perf_counter()

    # (a) direct and two-step, then the card against the CPU.
    sessions = {}
    for mode, extra in SLAM_MODES.items():
        policy = slam_policy(**SLAM_POLICY, **extra)
        row, sess = slam_run(frames, cam, cfg, policy, dev, reads_at=N_FRAMES // 2)
        cpu_row, cpu_sess = slam_run(frames, cam, cfg, policy, cpu)
        front = np.stack(sess.frame_poses)
        optimized = sess.optimized_trajectory()
        row.update(
            front=slam_errors(front, truths), optimized=slam_errors(optimized, truths),
            cpu_keyframe_indices=cpu_row["keyframe_indices"],
            cpu_max_abs_pose_diff=float(max(
                np.abs(front - np.stack(cpu_sess.frame_poses)).max(),
                np.abs(optimized - cpu_sess.optimized_trajectory()).max())),
        )
        out[mode], sessions[mode] = row, sess

    # (b) a loop closure and a relocalization.
    k_rev, rev_frames, _ = synthetic.revisit_sequence(HEIGHT, WIDTH, seed=SEED)
    row, _ = slam_run(rev_frames, CameraModel.create(k_rev, 1.0), cfg,
                      slam_policy(**synthetic.REVISIT_POLICY), dev)
    out["revisit"] = row

    # (c) the dense refinement of (a)'s direct keyframes after the global pose
    # graph, on the card and on the CPU from the same state (a checkpoint).
    sess = sessions["direct"]
    sess.optimize_full()
    ckpt = checkpoint.save_slam_session(root / "slam.npz", sess)
    cpu_sess = checkpoint.load_slam_session(
        ckpt, SlamSession(cam, cfg, slam_policy(**SLAM_POLICY), device=cpu))
    t0 = time.perf_counter()
    result = sess.refine_dense(update_depths=True)  # reads its poses back
    dense_s = time.perf_counter() - t0
    cpu_sess.refine_dense(update_depths=True)
    kept = sum(fd is not None for fd in sess._kf_frames)
    points = result.inv_depth.shape[1]
    out["dense"] = {
        "keyframes": kept, "grid_points": points, "ms": dense_s * 1e3,
        "y_bytes": kept * points * kept * 6 * 4,
        "chi2_history": result.chi2_history.cpu().tolist(),
        "cpu_max_abs_pose_diff": float(np.abs(np.stack(sess.keyframe_poses)
                                              - np.stack(cpu_sess.keyframe_poses)).max()),
        "optimized": slam_errors(sess.optimized_trajectory(), truths),
    }

    # (d) the batched session against one session a stream, on the card.
    streams = stream_sequences()
    policy = slam_policy(**STREAM_POLICY)
    batched = BatchedSlamSession(cam, cfg, n_streams=SLAM_STREAMS, policy=policy, device=dev)
    step_ms = []
    for t in range(N_FRAMES):
        t0 = time.perf_counter()
        batched.step([s[0][t] for s in streams], [s[1][t] for s in streams])
        step_ms.append((time.perf_counter() - t0) * 1e3)
    gaps, singles = [], []
    for b, (g, d) in enumerate(streams):
        row, single = slam_run(list(zip(g, d)), cam, cfg, policy, dev)
        singles.append(row["keyframe_indices"])
        gaps.append(float(np.abs(np.stack(batched.sessions[b].frame_poses)
                                 - np.stack(single.frame_poses)).max()))
    out["batched"] = {
        "streams": SLAM_STREAMS, "frames": N_FRAMES,
        # frames over the steps after the first two (first frames, warm-up);
        # the median step is a per-layer statistic beside it
        "frames_per_s": SLAM_STREAMS * (N_FRAMES - 2) / (sum(step_ms[2:]) / 1e3),
        "median_step_ms": float(np.median(step_ms[2:])), "step_ms": step_ms,
        "keyframe_indices": [s.keyframe_indices for s in batched.sessions],
        "single_keyframe_indices": singles, "max_abs_pose_diff": gaps,
    }

    # (e) the CLI, -m slam, on phase 5's directory.
    seq_dir, cam_yaml = root / "seq", root / "camera.yaml"
    for name, flags in SLAM_CLI_RUNS.items():
        run_dir = root / f"out_{name}"
        summary = benchmark.run(benchmark.parse_args(
            ["tum", "-d", str(seq_dir), "--camera", str(cam_yaml), "-m", "slam",
             "-c", str(CONFIGS / f"{SLAM_CONFIG}.json"), "-o", str(run_dir), *flags]))
        out[name] = {**summary, "written": sorted(p.name for p in run_dir.iterdir())}
    out["launches"], _ = read_launches()
    out["refine_sensitivity"] = refine_sensitivity(seq_dir, cam_yaml, cfg, dev, root)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)

    for mode in SLAM_MODES:
        r = out[mode]
        print(f"slam {mode}: {r['median_step_ms']} ms a step (median), "
              f"{r['host_reads_per_step']} host reads in step {N_FRAMES // 2}, "
              f"keyframes {r['keyframe_indices']}", flush=True)
    print(f"slam dense BA: {out['dense']['ms']} ms over {out['dense']['keyframes']} keyframes, "
          f"y {out['dense']['y_bytes']} bytes", flush=True)
    print(f"slam batched: {out['batched']['frames_per_s']} frames/s ({SLAM_STREAMS} streams)",
          flush=True)
    for name in SLAM_CLI_RUNS:
        r = out[name]
        print(f"slam cli {name}: fps {r['fps']}, read_s {r['read_s']}, "
              f"keyframes {r['keyframes']}, ATE {r['ate_rmse_m'] * 1e3} mm", flush=True)
    r = out["refine_sensitivity"]
    print(f"slam refine_dense on the CLI's directory: ATE {r['ate_mm']} mm; keyframe poses "
          f"card vs CPU {r['input_card_vs_cpu']} before, {r['refined_card_vs_cpu']} after, "
          f"{r['same_state_card_vs_cpu']} from one state; {r['moved_response']} on the card "
          f"and {r['cpu_moved_response']} on the CPU after moving the keyframes by "
          f"{REFINE_PERTURB_M} m", flush=True)

    for mode in SLAM_MODES:
        r, bounds = out[mode], SLAM_BOUNDS[mode]
        if len(r["keyframe_indices"]) < SLAM_MIN_KEYFRAMES:
            raise AssertionError(f"slam {mode}: {r['keyframe_indices']} keyframes")
        if r["keyframe_indices"] != r["cpu_keyframe_indices"]:
            raise AssertionError(f"slam {mode}: keyframes {r['keyframe_indices']} on the card, "
                                 f"{r['cpu_keyframe_indices']} on the CPU")
        if r["cpu_max_abs_pose_diff"] > SLAM_POSE_ATOL:
            raise AssertionError(f"slam {mode}: the card and the CPU part")
        for which in ("front", "optimized"):
            if (r[which]["mm"] > bounds[f"{which}_mm"]
                    or r[which]["deg"] > bounds[f"{which}_deg"]):
                raise AssertionError(f"slam {mode}: {which} error above the expected bound")
    rev = out["revisit"]
    if not rev["loop_closures"] or not rev["relocalizations"]:
        raise AssertionError(f"slam revisit: loops {rev['loop_closures']}, "
                             f"relocalizations {rev['relocalizations']}")
    if out["dense"]["cpu_max_abs_pose_diff"] > SLAM_POSE_ATOL:
        raise AssertionError("slam dense BA: the card and the CPU part")
    bat = out["batched"]
    if (bat["keyframe_indices"] != bat["single_keyframe_indices"]
            or max(bat["max_abs_pose_diff"]) > STREAM_ATOL
            or min(len(k) for k in bat["keyframe_indices"]) < 2):
        raise AssertionError("slam batched: a stream parts from its own session")
    backend = f"cuda:{torch.cuda.get_device_name(0)}" if dev.type == "cuda" else "cpu"
    for name in SLAM_CLI_RUNS:
        r = out[name]
        if r["backend"] != backend or r["written"] != ["report.json", "trajectory.txt"]:
            raise AssertionError(f"slam cli {name}: ran on {r['backend']}, wrote {r['written']}")
        if r["ate_rmse_m"] * 1e3 > SLAM_CLI_BOUNDS[name]:
            raise AssertionError(f"slam cli {name}: ATE above the expected bound")
    if not out["slam_dense_refine"].get("dense_refined"):
        raise AssertionError("slam cli: --dense-refine did not refine")
    # The refinement's own output is not held card against CPU here: on this
    # directory its 8 iterations do not converge, and inputs 1e-6 m apart end
    # up to ~1e-3 m apart on either device (PERF.md, PR 9 review round).
    r = out["refine_sensitivity"]
    if (len({tuple(k) for k in r["keyframe_indices"].values()}) != 1
            or r["input_card_vs_cpu"] > SLAM_POSE_ATOL
            or max(r["ate_mm"].values()) > SLAM_CLI_BOUNDS["slam_dense_refine"]):
        raise AssertionError("slam refine_dense on the CLI's directory: the card and the CPU "
                             "part")
    if min(out["launches"]["level_solver"], out["launches"]["fused_iter"]) < 1:
        raise AssertionError(f"slam: a kernel of the SLAM path never launched: {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# Phase 7: mapping (apps.reconstruct on phase 5's directory).
# ---------------------------------------------------------------------------

# The five reconstruct runs under configs/tpu_fast.json: (a) the session's
# poses fused into the dense volume at the default --resolution 192, (b) the
# same into the brick volume (the default --pool 32768), (c)-(e) frame-to-model
# tracking: keyframe renders (splat), KinectFusion (a march every frame) on
# the dense and on the brick tracking volume; each mesh from the dense volume.
MAPPING_CONFIG = "tpu_fast"
MAPPING_RUNS = {
    "dense": ["-o", "dense.ply"],
    "brick": ["--brick", "-o", "brick.obj"],
    "track_model": ["-m", "track-model", "-o", "track_model.ply"],
    "track_kinfu": ["-m", "track-model", "--track-kinfu", "-o", "track_kinfu.ply"],
    "track_kinfu_brick": ["-m", "track-model", "--track-kinfu", "--track-brick",
                          "-o", "track_kinfu_brick.ply"],
}
TRACK_RUNS = ("track_model", "track_kinfu", "track_kinfu_brick")
# Three times the JAX package's errors on the same directory on the CPU
# (``tests/jax_smoke_scene.py --mapping``): the ATE of each run's poses and
# the median |z - true depth| of its mesh's vertices in frame 0, in mm.
MAPPING_BOUNDS = {
    "dense": {"ate_mm": 7.72, "surface_mm": 6.54},  # JAX 2.5715, 2.1794
    "brick": {"ate_mm": 7.72, "surface_mm": 6.54},  # JAX 2.5715, 2.1797
    "track_model": {"ate_mm": 1173.0, "surface_mm": 155.6},  # JAX 390.83, 51.855
    "track_kinfu": {"ate_mm": 24.28, "surface_mm": 25.68},  # JAX 8.0900, 8.5574
    "track_kinfu_brick": {"ate_mm": 25.20, "surface_mm": 23.17},  # JAX 8.3991, 7.7209
}
# The card against the port's CPU path from the same frames and poses: the
# fused fields (weights equal, gray within two float32 ulps at 128-256, the
# SDF within two ulps of a camera depth at 2-4 m once in meters) on all but
# the tie voxels (a projection at a half pixel may round to either neighbour
# when the pose parts by an ulp), at most MAPPING_TIE_SHARE of the observed
# voxels; renders of the final volume at frame 0's pose: the splat's
# validity and gray equal and depth within MAPPING_SPLAT_ATOL, the marches'
# depth within MAPPING_MARCH_ATOL, on MAPPING_RENDER_SHARE of the pixels.
MAPPING_GRAY_ATOL = 3.1e-5
MAPPING_TSDF_ATOL_M = 4.8e-7
MAPPING_TIE_SHARE = 1e-3
MAPPING_SPLAT_ATOL = 4.8e-7
MAPPING_MARCH_ATOL = 1e-5
MAPPING_RENDER_SHARE = 0.995
MAPPING_READS_AT = 10  # the track-model step whose host reads are counted


def true_depth0() -> np.ndarray:
    """Frame 0 of phase 5's directory before the sensor model: the source
    scene rendered at the first pose of its trajectory."""
    from dense_visual_odometry_torch.apps import make_dataset

    gray, depth, k = synthetic.textured_scene(make_dataset.SOURCE_HEIGHT,
                                              make_dataset.SOURCE_WIDTH, seed=SEED)
    pose0 = synthetic.handheld_trajectory(CLI_FRAMES, seed=SEED)[:1]
    return synthetic.render_sequence(gray, depth, k, pose0)[1][0]


def mesh_vertices(path: Path) -> np.ndarray:
    """(V, 3) vertices of an ASCII PLY or OBJ mesh as written by
    ``save_mesh_ply`` / ``save_mesh_obj`` (either package's)."""
    lines = path.read_text().splitlines()
    if path.suffix == ".obj":
        return np.array([[float(x) for x in ln.split()[1:4]] for ln in lines
                         if ln.startswith("v ")]).reshape(-1, 3)
    n = int(next(ln for ln in lines if ln.startswith("element vertex")).split()[-1])
    start = lines.index("end_header") + 1
    return np.array([[float(x) for x in ln.split()[:3]]
                     for ln in lines[start:start + n]]).reshape(-1, 3)


def mapping_errors(poses: np.ndarray, gt_poses: np.ndarray, mesh: Path, k: np.ndarray,
                   depth0: np.ndarray) -> dict:
    """ATE of ``poses`` against the truth relative to frame 0, and the median
    |z - true depth| of the mesh's vertices that project into frame 0 (the
    trajectory's origin) onto a pixel with depth, both in mm."""
    from dense_visual_odometry_torch import metrics

    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt_poses[0]), gt_poses)
    ate, _ = metrics.ate_rmse(poses, gt_rel)
    v = mesh_vertices(mesh)
    z = v[:, 2]
    front = z > 1e-6
    u = np.round(k[0, 0] * v[front, 0] / z[front] + k[0, 2]).astype(np.int64)
    w = np.round(k[1, 1] * v[front, 1] / z[front] + k[1, 2]).astype(np.int64)
    h_img, w_img = depth0.shape
    inside = (u >= 0) & (u < w_img) & (w >= 0) & (w < h_img)
    truth = depth0[w[inside], u[inside]]
    seen = truth > 0
    err = np.abs(z[front][inside][seen] - truth[seen])
    return {"ate_mm": float(ate * 1e3), "surface_mm": float(np.median(err) * 1e3),
            "surface_vertices": int(err.size), "vertices": int(len(v))}


def reconstruct_argv(seq_dir: Path, cam: Path, out: Path, name: str, dev=None) -> list:
    """``apps.reconstruct``'s arguments for a run of MAPPING_RUNS (on the
    GPU, or with ``dev`` the CPU, on the CPU)."""
    flags = list(MAPPING_RUNS[name])
    flags[flags.index("-o") + 1] = str(out / flags[flags.index("-o") + 1])
    if dev is not None and dev.type == "cpu":
        flags += ["--platform", "cpu"]
    return ["tum", "-d", str(seq_dir), "--camera", str(cam),
            "-c", str(CONFIGS / f"{MAPPING_CONFIG}.json"), *flags]


def wall_ms(fn, reps: int, dev) -> float:
    """Median host-to-host time of ``fn`` (a chain of many launches) over
    ``reps`` runs after one warm-up, synchronized."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fn()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def field_parts(card, cpu, truncation: float) -> dict:
    """Voxels of two volumes' (tsdf, weight, gray) that part beyond the
    MAPPING_* tolerances, against the observed voxels."""
    tsdf_a, tsdf_b = card.tsdf.cpu().double(), cpu.tsdf.double()
    parts = ((card.weight.cpu() != cpu.weight)
             | ((card.gray.cpu() - cpu.gray).abs() > MAPPING_GRAY_ATOL)
             | ((tsdf_a - tsdf_b).abs() * truncation > MAPPING_TSDF_ATOL_M))
    observed = int((cpu.weight > 0).sum())
    return {"parted_voxels": int(parts.sum()), "observed_voxels": observed,
            "max_abs_tsdf": float((tsdf_a - tsdf_b).abs().max()),
            "ok": int(parts.sum()) <= MAPPING_TIE_SHARE * max(observed, 1)}


def render_parts(card, cpu, splat: bool) -> dict:
    """The share of pixels on which two renders (depth, gray) agree."""
    (dc, gc), (dp, gp) = [tuple(t.cpu().numpy() for t in r) for r in (card, cpu)]
    if splat:
        agree = ((dc > 0) == (dp > 0)) & (gc == gp) & (np.abs(dc - dp) <= MAPPING_SPLAT_ATOL)
        share = float(agree.mean())
    else:
        valid = (dc > 0) | (dp > 0)
        share = float((np.abs(dc - dp)[valid] <= MAPPING_MARCH_ATOL).mean())
    return {"agree_share": share, "valid_share": float((dc > 0).mean()),
            "ok": share >= MAPPING_RENDER_SHARE}


# The fusion kernel at kinfu512.b1.desk's volume (portbench/configs/
# fr1-kinfu512.json): 512^3 voxels over 3 m, the first camera 0.3 m before
# the front face's centre, truncation 30 mm, weight cap 128.
KINFU512 = dict(dims=(512, 512, 512), voxel_size=3.0 / 512, origin=(-1.5, -1.5, 0.3),
                truncation=0.03, max_weight=128.0)
KINFU512_FUSIONS = 4
KINFU512_RENDERS = 4  # the march check renders at the poses of frames 1 to 4


def check_tsdf_kernel(frames, poses, k, dev) -> dict:
    """The dense fusion kernel against the plain version
    (``tsdf.integrate_plain``) at KINFU512: the first KINFU512_FUSIONS
    ``frames`` ((depth_m, gray) pairs) fused at ``poses`` (camera-to-world,
    relative to the first) into two volumes, the three fields equal bit for
    bit after each fusion and one launch a fusion; then the kernel's and
    the plain version's time a fusion against ``roofline_map.fuse_bound_ms``
    (the three fields of every voxel read and written, and the frame)."""
    from dense_visual_odometry_torch.models import tsdf
    from dense_visual_odometry_torch.ops.cuda.tsdf import integrate_volume
    from dense_visual_odometry_torch.utils.lie import se3
    from portbench import roofline_map

    cfg = tsdf.TSDFConfig(**KINFU512)
    vol, ref = tsdf.make_volume(cfg, dev), tsdf.make_volume(cfg, dev)
    k_dev = torch.as_tensor(np.asarray(k, np.float32), device=dev)
    first = np.linalg.inv(poses[0])
    inputs = [tuple(torch.as_tensor(np.asarray(a, np.float32), device=dev) for a in frame)
              + (torch.as_tensor(np.asarray(first @ pose, np.float32), device=dev),)
              for frame, pose in zip(frames[:KINFU512_FUSIONS], poses[:KINFU512_FUSIONS])]
    equal, launched = [], []
    for depth_m, gray, pose in inputs:
        before = integrate_volume.launches
        tsdf.integrate(vol, depth_m, gray, k_dev, pose, cfg)
        launched.append(integrate_volume.launches - before)
        tsdf.integrate_plain(ref, depth_m, gray, k_dev, se3.inverse(pose), cfg)
        torch.cuda.synchronize()
        equal.append(all(bit_equal(a, b) for a, b in zip(vol, ref)))
    depth_m, gray, pose = inputs[-1]
    ms = time_ms(lambda: tsdf.integrate(vol, depth_m, gray, k_dev, pose, cfg), 20, dev)
    plain_ms = time_ms(lambda: tsdf.integrate_plain(ref, depth_m, gray, k_dev,
                                                    se3.inverse(pose), cfg), 5, dev)
    voxels, pixels = int(np.prod(cfg.dims)), int(depth_m.numel())
    bound_ms = roofline_map.fuse_bound_ms(voxels, pixels)
    return {"phase": "kernel", "kernel": "tsdf_fuse", "dims": list(cfg.dims),
            "frame": list(depth_m.shape), "fusions": len(inputs),
            "observed_voxels": int((vol.weight > 0).sum()), "bit_equal": equal,
            "launches": launched, "ok": all(equal) and launched == [1] * len(inputs),
            "ms": ms, "plain_ms": plain_ms, "bytes": roofline_map.fuse_bytes(voxels, pixels),
            "bound_ms": bound_ms, "bound_by": "bytes", "roofline_pct": 100.0 * bound_ms / ms}


def march_voxels(volume, k, pose, cfg, shape, n_steps: int, step: float, depth,
                 min_weight: float = 1.0, max_depth: float = 10.0):
    """-> (the distinct voxels that the volume march samples from ``pose``,
    each ray up to its first crossing (that sample included), the distinct
    corners of the trilinear gray at the render's hits ``depth``): what a
    render has to read of the tsdf and the weight, and of the gray, at
    least.  The sphere-tracing steps' taps that fall outside the sampled
    voxels are left out, so the bound is low."""
    from dense_visual_odometry_torch.models import tsdf

    dev = volume.tsdf.device
    d, hh, ww = cfg.dims
    rays = tsdf.pixel_rays(k, pose, shape)
    t_in = tsdf.volume_ray_entry(cfg, rays, max_depth).reshape(-1)
    origin = torch.tensor(cfg.origin, dtype=torch.float32, device=dev)
    base = ((rays.origin - origin) / cfg.voxel_size - 0.5)[:, None]
    slope = torch.stack([rays.dwx, rays.dwy, rays.dwz]).reshape(3, -1) / cfg.voxel_size
    top = torch.tensor([ww - 1, hh - 1, d - 1], dtype=torch.float32, device=dev)[:, None]
    stride = torch.tensor([1, ww, hh * ww], dtype=torch.int64, device=dev)[:, None]
    phi_field = torch.where(volume.weight >= min_weight, volume.tsdf,
                            torch.ones_like(volume.tsdf)).reshape(-1)
    alive = torch.ones_like(t_in, dtype=torch.bool)
    prev, read = None, []
    for i in range(n_steps + 1 if n_steps > 0 else 0):
        f = torch.round(base + slope * (t_in + step * i))
        inside = ((f >= 0.0) & (f <= top)).all(0)
        flat = (torch.minimum(torch.clamp(f, min=0.0), top).long() * stride).sum(0)
        phi = torch.where(inside, phi_field[flat], torch.ones_like(t_in))
        read.append(flat[alive & inside])
        if prev is not None:
            alive &= ~((phi < 0.0) & (prev >= 0.0))
        prev = phi
    voxels = int(torch.unique(torch.cat(read)).numel()) if read else 0
    hit = (depth > 0).reshape(-1)
    corners = [((iz * hh + iy) * ww + ix).reshape(-1)[hit]
               for ix, iy, iz, _ in tsdf.trilinear_corners(cfg, rays, depth)]
    return voxels, int(torch.unique(torch.cat(corners)).numel())


def check_raycast_kernel(frames, poses, k, dev) -> dict:
    """The volume march kernel against the plain march
    (``tsdf.raycast_view_march_volume_plain``) at KINFU512: the first
    KINFU512_FUSIONS ``frames`` fused at ``poses`` (relative to the first),
    then a render by both at the poses of frames 1 to KINFU512_RENDERS, depth
    and gray equal bit for bit and one launch a render; then the kernel's
    and the plain march's device time (after an L2 flush) and host-to-host
    time of the last render, against a bound by bytes: one read of the tsdf
    and the weight of every distinct voxel that the rays sample up to their
    crossing and of the gray at the hits' trilinear corners
    (``march_voxels``), and the two images written, at 3.35 TB/s."""
    from dense_visual_odometry_torch.models import tsdf
    from dense_visual_odometry_torch.ops.cuda.tsdf import raycast_volume

    cfg = tsdf.TSDFConfig(**KINFU512)
    vol = tsdf.make_volume(cfg, dev)
    k_dev = torch.as_tensor(np.asarray(k, np.float32), device=dev)
    first = np.linalg.inv(poses[0])
    rel = [first @ pose for pose in poses]
    for (depth_m, gray), pose in zip(frames[:KINFU512_FUSIONS], rel):
        tsdf.integrate(vol, *(torch.as_tensor(np.asarray(a, np.float32), device=dev)
                              for a in (depth_m, gray)), k_dev,
                       torch.as_tensor(np.asarray(pose, np.float32), device=dev), cfg)
    shape = tuple(np.asarray(frames[0][0]).shape)
    step = tsdf.VOLUME_MARCH_STEP * cfg.truncation
    equal, launched, steps, valid = [], [], [], []
    for pose in rel[1:1 + KINFU512_RENDERS]:
        n = tsdf.volume_march_steps(cfg, pose, step)
        pose_dev = torch.as_tensor(np.asarray(pose, np.float32), device=dev)
        args = (vol, k_dev, pose_dev, cfg, shape, n, step)
        before = raycast_volume.launches
        out = tsdf.raycast_view_march_volume(*args)
        launched.append(raycast_volume.launches - before)
        ref = tsdf.raycast_view_march_volume_plain(*args)
        torch.cuda.synchronize()
        equal.append(all(bit_equal(a, b) for a, b in zip(out, ref)))
        steps.append(n)
        valid.append(float((out[0] > 0).double().mean()))
    ms = time_ms(lambda: tsdf.raycast_view_march_volume(*args), 20, dev)
    plain_ms = time_ms(lambda: tsdf.raycast_view_march_volume_plain(*args), 5, dev)
    host_ms = wall_ms(lambda: tsdf.raycast_view_march_volume(*args), 10, dev)
    plain_host_ms = wall_ms(lambda: tsdf.raycast_view_march_volume_plain(*args), 5, dev)
    voxels, gray_voxels = march_voxels(vol, k_dev, pose_dev, cfg, shape, n, step, out[0])
    nbytes = 8 * voxels + 4 * gray_voxels + 8 * shape[0] * shape[1]
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"phase": "kernel", "kernel": "raycast_volume", "dims": list(cfg.dims),
            "frame": list(shape), "fusions": KINFU512_FUSIONS, "steps": steps,
            "valid_share": valid, "bit_equal": equal, "launches": launched,
            "ok": all(equal) and launched == [1] * len(equal), "ms": ms, "plain_ms": plain_ms,
            "host_ms": host_ms, "plain_host_ms": plain_host_ms, "voxels_read": voxels,
            "gray_voxels_read": gray_voxels,
            "bytes": nbytes, "bound_ms": bound_ms, "bound_by": "bytes",
            "roofline_pct": 100.0 * bound_ms / ms}


def check_render_path(frames, k, dev) -> dict:
    """The main path's renders at KINFU512: a KinectFusion tracker
    (``FrameToModelTracker``, a volume-march render every frame) over
    ``frames`` on the card, traced, with the launch counts zeroed just
    before.  Every ``map.render`` span must have launched the march kernel
    once: ``map.render_kernel``, ``raycast_volume.launches`` and the spans
    agree, one a frame after the first."""
    from dense_visual_odometry_torch.models import frame_to_model, tsdf
    from dense_visual_odometry_torch.ops.cuda.tsdf import raycast_volume
    from dense_visual_odometry_torch.utils import profiling

    policy = frame_to_model.ModelTrackerPolicy(render_every_frame=True, raycast="volume")
    tracker = frame_to_model.FrameToModelTracker(
        CameraModel.create(np.asarray(k, np.float32), 1.0), config(MAPPING_CONFIG),
        tsdf.TSDFConfig(**KINFU512), policy, device=dev)
    profiling.disable_tracing()
    profiling.drain()
    zero_launches()
    profiling.enable_tracing()
    try:
        for depth_m, gray in frames:
            tracker.step(gray, depth_m)
    finally:
        profiling.disable_tracing()
    drained = profiling.drain()
    spans = sum(s["name"] == "map.render" for s in drained["spans"])
    counted = drained["counters"].get("map.render_kernel", 0)
    launches = raycast_volume.launches
    return {"phase": "kernel", "path": "kinfu_render", "dims": list(KINFU512["dims"]),
            "frames": len(frames), "render_spans": spans, "render_kernel": counted,
            "launches": launches, "failures": tracker.failures,
            "ok": spans == counted == launches == len(frames) - 1}


class _StepReads:
    """Counts the host reads of one ``FrameToModelTracker.step`` (the
    ``at``-th call) while installed."""

    def __init__(self, at: int):
        from dense_visual_odometry_torch.models import frame_to_model

        self.cls, self.at, self.calls, self.reads = frame_to_model.FrameToModelTracker, at, 0, None
        self.orig = self.cls.step

    def __enter__(self):
        probe, orig = self, self.orig

        def step(tracker, image, depth):
            probe.calls += 1
            if probe.calls != probe.at or tracker.device.type != "cuda":
                return orig(tracker, image, depth)
            out = []
            probe.reads = host_reads(lambda: out.append(orig(tracker, image, depth)))
            return out[0]

        self.cls.step = step
        return self

    def __exit__(self, *exc):
        self.cls.step = self.orig


def run_mapping(dev, root: Path, smi: str) -> dict:
    """Phase 7 on ``dev``: the five MAPPING_RUNS of ``apps.reconstruct`` on
    phase 5's directory, each held to MAPPING_BOUNDS; (a)'s and (b)'s fusion
    repeated on the CPU from the same frames and poses; the splat and march
    renders of (a)'s final volume and the brick march of (b)'s at frame 0's
    pose on the card and on the CPU from one volume; on the card, the
    KINFU512 kernels against their plain versions and a KinectFusion
    tracker's renders through the march kernel.  The launch counts are
    zeroed just before and read just after each run; the level and fused
    kernels must launch in (c)-(e).  Raises on any failed check."""
    from dense_visual_odometry_torch.apps import reconstruct
    from dense_visual_odometry_torch.io.datasets import load_tum_sequence
    from dense_visual_odometry_torch.models import brick_tsdf, tsdf
    from dense_visual_odometry_torch.ops.cuda.tsdf import integrate_volume

    cpu = torch.device("cpu")
    seq_dir, cam_yaml = root / "seq", root / "camera.yaml"
    gt_poses = load_tum_sequence(seq_dir, camera_yaml=cam_yaml).gt_poses
    depth0 = true_depth0()
    out_dir = root / "mapping"
    out = {"phase": "mapping", "image": [HEIGHT, WIDTH], "frames": CLI_FRAMES,
           "config": MAPPING_CONFIG, "runs": {}}
    t_phase = time.perf_counter()
    zero_launches()
    recs = {}
    for name in MAPPING_RUNS:
        before, _ = read_launches()
        fusions = integrate_volume.launches
        t0 = time.perf_counter()
        with _StepReads(MAPPING_READS_AT) as probe:
            rec = reconstruct.run(reconstruct.parse_args(
                reconstruct_argv(seq_dir, cam_yaml, out_dir, name, dev)))
        wall = time.perf_counter() - t0
        after, _ = read_launches()
        s = rec.summary
        row = {k: v for k, v in s.items() if k != "step_ms"}
        row.update(wall_s=wall, launches={n: after[n] - before[n] for n in after},
                   fusion_launches=integrate_volume.launches - fusions,
                   **mapping_errors(rec.poses, gt_poses, Path(s["output"]), rec.intrinsics,
                                    depth0))
        if name in TRACK_RUNS:
            steps = np.asarray(s["step_ms"][2:])
            row.update(median_step_ms=float(np.median(steps)),
                       frames_per_s=float(len(steps) / (steps.sum() / 1e3)),
                       host_reads_per_step=probe.reads, step_ms=s["step_ms"])
        out["runs"][name], recs[name] = row, rec
    out["launches"], _ = read_launches()

    # The card against the CPU: (a)'s and (b)'s fusion from the same inputs.
    for name, make, fuse in (("dense", tsdf.make_volume, tsdf.integrate),
                             ("brick", brick_tsdf.make_brick_volume, brick_tsdf.integrate_brick)):
        rec = recs[name]
        vol = make(rec.volume_config, cpu)
        t0 = time.perf_counter()
        for (depth_m, gray), pose in zip(rec.frames, rec.fused_poses):
            fuse(vol, depth_m, gray, rec.intrinsics, pose, rec.volume_config)
        row = field_parts(rec.volume, vol, rec.volume_config.truncation)
        row["cpu_fuse_s"] = time.perf_counter() - t0
        if name == "brick":
            row["tables_equal"] = all(bool(torch.equal(getattr(rec.volume, f).cpu(),
                                                       getattr(vol, f)))
                                      for f in ("table", "brick_zyx", "n_used", "n_dropped"))
            row["ok"] = row["ok"] and row["tables_equal"]
        frame = [torch.as_tensor(a, device=dev) for a in rec.frames[0]]
        k_dev = torch.as_tensor(rec.intrinsics, device=dev)
        pose_dev = torch.as_tensor(np.asarray(rec.fused_poses[0], np.float32), device=dev)
        scratch = make(rec.volume_config, dev)
        row["fuse_ms_per_frame_device"] = wall_ms(
            lambda: fuse(scratch, *frame, k_dev, pose_dev, rec.volume_config), 5, dev)
        out[f"fusion_{name}"] = row

    # The fusion kernel against the plain version on the card at 512^3.
    if dev.type == "cuda":
        out["fusion_kernel"] = check_tsdf_kernel(recs["dense"].frames,
                                                 recs["dense"].fused_poses,
                                                 recs["dense"].intrinsics, dev)

    # The volume march kernel against the plain march on the card at 512^3.
    if dev.type == "cuda":
        out["raycast_kernel"] = check_raycast_kernel(recs["dense"].frames,
                                                     recs["dense"].fused_poses,
                                                     recs["dense"].intrinsics, dev)

    # A KinectFusion tracker's renders at 512^3 go through the kernel.
    if dev.type == "cuda":
        out["render_path"] = check_render_path(recs["dense"].frames,
                                               recs["dense"].intrinsics, dev)

    # Renders of the final volumes at frame 0's pose, card and CPU.
    eye = np.eye(4, dtype=np.float32)
    renders = {
        "splat": (recs["dense"], tsdf.raycast_view),
        "march": (recs["dense"], tsdf.raycast_view_march),
        "brick_march": (recs["brick"], brick_tsdf.raycast_view_march_brick),
    }
    for name, (rec, render) in renders.items():
        args = (rec.intrinsics, eye, rec.volume_config, (HEIGHT, WIDTH))
        card = render(rec.volume, *args)
        host = render(type(rec.volume)(*(t.cpu() for t in rec.volume)), *args)
        row = render_parts(card, host, splat=name == "splat")
        row["ms"] = wall_ms(lambda: render(rec.volume, *args), 5, dev)  # noqa: B023
        out[f"render_{name}"] = row
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)

    for name in ("dense", "brick"):
        r, f = out["runs"][name], out[f"fusion_{name}"]
        print(f"mapping fusion {name}: {r['fuse_ms_per_frame']} ms a frame from the host "
              f"({f['fuse_ms_per_frame_device']} with the frame on the card), "
              f"{r['fused_frames']} frames, volume {r['volume_dims']} {r['volume_bytes']} bytes "
              f"[{smi}]", flush=True)
        print(f"mapping mesh {name}: {r['mesh_s']} s, {r['vertices']} vertices, {r['faces']} faces "
              f"[{smi}]", flush=True)
    f = out.get("fusion_kernel")
    if f is not None:
        print(f"mapping fusion kernel at {f['dims']}: {f['ms']} ms a fusion against a "
              f"{f['bound_ms']} ms bound ({f['roofline_pct']}%), plain {f['plain_ms']} ms, "
              f"bit for bit {f['bit_equal']} [{smi}]", flush=True)
    r = out.get("raycast_kernel")
    if r is not None:
        print(f"mapping march kernel at {r['dims']}: {r['ms']} ms a render against a "
              f"{r['bound_ms']} ms bound ({r['roofline_pct']}%), plain {r['plain_ms']} ms; host "
              f"to host {r['host_ms']} ms, plain {r['plain_host_ms']} ms; bit for bit "
              f"{r['bit_equal']} [{smi}]", flush=True)
    r = out.get("render_path")
    if r is not None:
        print(f"mapping kinfu renders at {r['dims']}: {r['render_spans']} map.render spans, "
              f"{r['render_kernel']} map.render_kernel, {r['launches']} march kernel launches "
              f"over {r['frames']} frames", flush=True)
    b = out["runs"]["brick"]
    print(f"mapping bricks: {b['bricks_used']} used of {b['pool']}, {b['bricks_dropped']} dropped",
          flush=True)
    for name in renders:
        print(f"mapping render {name}: {out[f'render_{name}']['ms']} ms at {HEIGHT}x{WIDTH} "
              f"[{smi}]", flush=True)
    for name in TRACK_RUNS:
        r = out["runs"][name]
        print(f"mapping {name}: {r['median_step_ms']} ms a step (median), {r['frames_per_s']} "
              f"frames/s, {r['host_reads_per_step']} host reads in step {MAPPING_READS_AT}, "
              f"{r.get('renders')} renders [{smi}]", flush=True)
    for name in MAPPING_RUNS:
        r = out["runs"][name]
        print(f"mapping {name}: ATE {r['ate_mm']} mm, surface {r['surface_mm']} mm, "
              f"launches {r['launches']}", flush=True)
    print(f"mapping phase: {out['seconds']} s", flush=True)

    backend = f"cuda:{torch.cuda.get_device_name(0)}" if dev.type == "cuda" else "cpu"
    for name, r in out["runs"].items():
        bounds = MAPPING_BOUNDS[name]
        if r["backend"] != backend or r["frames"] != CLI_FRAMES or r["faces"] < 1000:
            raise AssertionError(f"mapping {name}: ran on {r['backend']} over {r['frames']} "
                                 f"frames, {r['faces']} faces")
        if r["ate_mm"] > bounds["ate_mm"] or r["surface_mm"] > bounds["surface_mm"]:
            raise AssertionError(f"mapping {name}: ATE or surface error above the expected bound")
        if name in TRACK_RUNS and (r["failures"] or min(r["launches"]["level_solver"],
                                                        r["launches"]["fused_iter"]) < 1):
            raise AssertionError(f"mapping {name}: {r['failures']} failed solves, launches "
                                 f"{r['launches']}")
        # A dense volume's fusions launch the fusion kernel, a brick volume's
        # not: the output map's, one a frame unless it is bricks (``--brick``),
        # and a dense tracking volume's besides (not ``--track-brick``).
        flags = MAPPING_RUNS[name]
        output = 0 if "--brick" in flags else r["fused_frames"]
        launches = r["fusion_launches"]
        if name in TRACK_RUNS and "--track-brick" not in flags:
            expected = launches > output
        else:
            expected = launches == output
        if dev.type == "cuda" and not expected:
            raise AssertionError(f"mapping {name}: {launches} fusion kernel launches, "
                                 f"{r['fused_frames']} frames in the output map")
    for key in ("fusion_dense", "fusion_brick", *(f"render_{n}" for n in renders)):
        if not out[key]["ok"]:
            raise AssertionError(f"mapping {key}: the card and the CPU part: {out[key]}")
    if dev.type == "cuda" and not out["fusion_kernel"]["ok"]:
        raise AssertionError(f"mapping: the fusion kernel parts from the plain version: "
                             f"{out['fusion_kernel']}")
    if dev.type == "cuda" and not out["raycast_kernel"]["ok"]:
        raise AssertionError(f"mapping: the march kernel parts from the plain march: "
                             f"{out['raycast_kernel']}")
    if dev.type == "cuda" and not out["render_path"]["ok"]:
        raise AssertionError(f"mapping: a KinectFusion render missed the march kernel: "
                             f"{out['render_path']}")
    return out


# ---------------------------------------------------------------------------
# Phase 8: the sparse pipeline and the LoFTR-lite matcher.
# ---------------------------------------------------------------------------

SPARSE_MATCHERS = ("zncc", "learned")
# (a) apps.benchmark -m sparse on phase 5's directory: three times the JAX
# package's errors there on the CPU (``tests/jax_smoke_scene.py --sparse``;
# the packages draw RANSAC's samples from different random streams).
SPARSE_CLI_BOUNDS = {
    "zncc": {"ate_mm": 57.23, "rpe_mm": 29.32, "rpe_deg": 1.172},  # JAX 19.076, 9.775, 0.3908
    "learned": {"ate_mm": 127.8, "rpe_mm": 56.60, "rpe_deg": 2.134},  # JAX 42.616, 18.868, 0.7115
}
# (b) SparseVO over the first SPARSE_CROSS_FRAMES frames on the card and on
# the CPU from one seed: equal success flags, poses within SPARSE_POSE_ATOL,
# and with the learned matcher the same coarse selections.  The learned
# sessions draw RANSAC's samples by source cell (``cell_sampler``): the two
# devices' probabilities part by rounding, near-equal confidences may rank
# apart, and a draw by rank would then fit other rows.
SPARSE_CROSS_FRAMES = 4
SPARSE_POSE_ATOL = 1e-4
SPARSE_READS_AT = 10  # the step whose host reads and peak memory are counted


class _SparseSteps:
    """Records each ``SparseVO.step``'s success while installed (the step
    has read it already)."""

    def __init__(self):
        from dense_visual_odometry_torch.models import sparse

        self.cls, self.success = sparse.SparseVO, []
        self.orig = self.cls.step

    def __enter__(self):
        probe, orig = self, self.orig

        def step(vo, gray, depth):
            pose = orig(vo, gray, depth)
            if vo.last_result is not None and vo.steps > len(probe.success):
                probe.success.append(bool(vo.last_result.success))
            return pose

        self.cls.step = step
        return self

    def __exit__(self, *exc):
        self.cls.step = self.orig


def record_coarse(vo) -> list:
    """Wrap the learned session's ``match_coarse`` to keep each pair's
    selection -> the list it appends to."""
    kept, coarse = [], vo.model.match_coarse

    def recording(g1, g2, **kw):
        kept.append(coarse(g1, g2, **kw))
        return kept[-1]

    vo.model.match_coarse = recording
    return kept


def cell_sampler(kept: list, width: int, seed: int = SEED):
    """A ``SparseVO`` sampler for the learned matcher that draws by source
    cell: the Gumbel noise of pair ``step`` comes from a CPU generator seeded
    with (seed, step), one value per hypothesis and cell, and a row takes its
    cell's, so the draw does not depend on the rows' ranks."""
    from dense_visual_odometry_torch.models.matcher import STRIDE
    from dense_visual_odometry_torch.utils.ransac import first_top_k, sample_probabilities

    wc = width // STRIDE

    def sampler(step, mask, hypotheses, size):
        uv = kept[-1].uv_prev
        cells = (torch.div(uv[:, 1], STRIDE, rounding_mode="floor") * wc
                 + torch.div(uv[:, 0], STRIDE, rounding_mode="floor")).long()
        gen = torch.Generator().manual_seed(seed * 100003 + step)
        noise = torch.empty((hypotheses, (HEIGHT // STRIDE) * wc)).exponential_(generator=gen)
        gumbel = (-torch.log(noise)).to(mask.device)[:, cells]
        probs = sample_probabilities(mask, mask.shape[0], mask.device)
        return first_top_k(gumbel + torch.log(probs), size)

    return sampler


def selection_parts(card, cpu) -> dict:
    """How the card's coarse selection of a pair parts from the CPU's: the
    source cells only one of them selected, and the ranks that hold another
    match (near-equal confidences ranked apart)."""
    from dense_visual_odometry_torch.models.matcher import selection_order

    a = {tuple(uv) for uv in card.uv_prev.cpu().tolist()}
    b = {tuple(uv) for uv in cpu.uv_prev.cpu().tolist()}
    out = {"parted_cells": len(a ^ b), "swapped_ranks": None}
    if not out["parted_cells"]:
        order = selection_order(cpu, card)
        out["swapped_ranks"] = int((order != torch.arange(len(order))).sum())
        out["max_abs_confidence"] = float(
            (card.confidence.cpu()[order] - cpu.confidence).abs().max())
    return out


def sparse_cross(frames, cam, dev) -> dict:
    """(b): SparseVO of each matcher over the first SPARSE_CROSS_FRAMES
    frames on ``dev`` and on the CPU, step by step from one seed."""
    from dense_visual_odometry_torch.models.sparse import SparseVO

    out = {}
    for matcher in SPARSE_MATCHERS:
        sess = {side: SparseVO(cam, seed=SEED, matcher=matcher, device=d)
                for side, d in (("card", dev), ("cpu", torch.device("cpu")))}
        kept = {}
        if matcher == "learned":
            for side, vo in sess.items():
                kept[side] = record_coarse(vo)
                vo.sampler = cell_sampler(kept[side], WIDTH)
        row = {"success": {"card": [], "cpu": []}, "max_abs_pose_diff": 0.0, "cpu_step_s": []}
        for gray, depth in frames[:SPARSE_CROSS_FRAMES]:
            poses = {}
            for side, vo in sess.items():
                t0 = time.perf_counter()
                poses[side] = vo.step(gray, depth).cpu()
                if vo.last_result is not None:
                    row["success"][side].append(bool(vo.last_result.success))
                    if side == "cpu":
                        row["cpu_step_s"].append(time.perf_counter() - t0)
            row["max_abs_pose_diff"] = max(row["max_abs_pose_diff"],
                                           float((poses["card"] - poses["cpu"]).abs().max()))
        if matcher == "learned":
            row["selections"] = [selection_parts(a, b)
                                 for a, b in zip(kept["card"], kept["cpu"])]
        out[matcher] = row
    return out


def sparse_stage_times(frames, cam, dev) -> dict:
    """(c): each stage of a pair at 640x480 on frames 0 and 1, device ms
    (``time_ms``: CUDA events after an L2 flush)."""
    from dense_visual_odometry_torch.models import matcher as matcher_mod
    from dense_visual_odometry_torch.models import sparse
    from dense_visual_odometry_torch.ops.pyramid import preprocess_depth
    from dense_visual_odometry_torch.utils.ransac import ransac_rigid

    reps = 10
    k = cam.intrinsics.to(dev)
    (g0, d0), (g1, d1) = [
        (torch.as_tensor(g, dtype=torch.float32, device=dev),
         preprocess_depth(torch.as_tensor(d.astype(np.int64), device=dev), cam.depth_scale))
        for g, d in frames[:2]]
    t = {}
    corners, scores = sparse.harris_corners(g0, k=1024)
    t["harris"] = time_ms(lambda: sparse.harris_corners(g0, k=1024), reps, dev)
    fwd = sparse.match_patches(g0, g1, corners)
    t["zncc_forward"] = time_ms(lambda: sparse.match_patches(g0, g1, corners), reps, dev)
    t["zncc_backward"] = time_ms(lambda: sparse.match_patches(g1, g0, fwd.uv_curr), reps, dev)
    src, dst, valid, pts_prev = sparse.ransac_inputs(fwd, d0, d1, k, 0.03)
    gen = torch.Generator().manual_seed(SEED)
    res = ransac_rigid(src, dst, generator=gen, num_hypotheses=64, sample_mask=valid,
                       weights=fwd.confidence * valid)
    t["ransac"] = time_ms(lambda: ransac_rigid(
        src, dst, generator=gen, num_hypotheses=64, sample_mask=valid,
        weights=fwd.confidence * valid), reps, dev)
    w = fwd.confidence * (valid & res.inliers)
    t["refine"] = time_ms(lambda: sparse.refine_reprojection(
        res.fit.transform, pts_prev, fwd.uv_curr, w, k), reps, dev)

    model = matcher_mod.load_matcher(device=dev)
    with torch.no_grad():
        f1, f2 = model._backbone(g0), model._backbone(g1)
        t["backbone"] = time_ms(lambda: model._backbone(g0), reps, dev)
        for layer in range(model.layers):
            t[f"attention_layer{layer}"] = time_ms(
                lambda: model.transformer_layer(layer, f1, f2), reps, dev)  # noqa: B023
            f1, f2 = model.transformer_layer(layer, f1, f2)
        hc, wc = HEIGHT // matcher_mod.STRIDE, WIDTH // matcher_mod.STRIDE
        t["dual_softmax_select"] = time_ms(
            lambda: model.select(model.dual_softmax(f1, f2), hc, wc), reps, dev)
        coarse = model.select(model.dual_softmax(f1, f2), hc, wc)
        t["fine_zncc"] = time_ms(lambda: sparse.match_patches(
            g0, g1, coarse.uv_prev, centers_curr=coarse.uv_curr, search=6, min_zncc=0.5),
            reps, dev)
        t["fine_learned"] = time_ms(lambda: model.refine_matches_fine(g0, g1, coarse), reps, dev)
    return t


def sparse_session_costs(frames, cam, dev) -> dict:
    """(c): a card session of each matcher over every frame: the median
    host-to-host step, the host reads and the peak memory of step
    SPARSE_READS_AT (above what was allocated before it)."""
    from dense_visual_odometry_torch.models.sparse import SparseVO

    out = {}
    for matcher in SPARSE_MATCHERS:
        vo = SparseVO(cam, seed=SEED, matcher=matcher, device=dev)
        steps = []
        for n, (gray, depth) in enumerate(frames):
            if n == SPARSE_READS_AT:
                torch.cuda.synchronize(dev)
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                reads = host_reads(lambda: vo.step(gray, depth))  # noqa: B023
                torch.cuda.synchronize(dev)
                peak = torch.cuda.max_memory_allocated(dev) - base
                continue
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            vo.step(gray, depth)
            steps.append((time.perf_counter() - t0) * 1e3)
        out[matcher] = {"median_step_ms": float(np.median(steps[2:])),
                        "host_reads_per_step": reads, "peak_bytes_per_step": int(peak),
                        "step_ms": steps}
    return out


def run_sparse(dev, root: Path, smi: str) -> dict:
    """Phase 8 on ``dev``: (a) ``apps.benchmark -m sparse`` with each matcher
    on phase 5's directory (ATE and RPE within SPARSE_CLI_BOUNDS), (b) the
    card against the CPU, (c) the stages' device times, the step's median,
    host reads and peak memory.  The launch counts are zeroed just before
    and read just after (a).  Raises on any failed check."""
    from dense_visual_odometry_torch.apps import benchmark
    from dense_visual_odometry_torch.io.datasets import host_gray_u8, load_tum_sequence

    seq_dir, cam_yaml = root / "seq", root / "camera.yaml"
    out = {"phase": "sparse", "image": [HEIGHT, WIDTH], "frames": CLI_FRAMES, "cli": {}}
    t_phase = time.perf_counter()
    zero_launches()
    for matcher in SPARSE_MATCHERS:
        run_dir = root / f"sparse_{matcher}"
        with _SparseSteps() as probe:
            summary = benchmark.run(benchmark.parse_args(
                ["tum", "-d", str(seq_dir), "--camera", str(cam_yaml), "-m", "sparse",
                 "--sparse-matcher", matcher, "-o", str(run_dir)]))
        out["cli"][matcher] = {
            **summary, "successful_steps": sum(probe.success), "steps": len(probe.success),
            "written": sorted(p.name for p in run_dir.iterdir())}
    out["launches"], _ = read_launches()

    seq = load_tum_sequence(seq_dir, camera_yaml=cam_yaml)
    frames = [(host_gray_u8(rgb).astype(np.float32), depth) for rgb, depth in seq]
    out["cross"] = sparse_cross(frames, seq.camera, dev)
    out["stage_ms"] = sparse_stage_times(frames, seq.camera, dev)
    out["session"] = sparse_session_costs(frames, seq.camera, dev)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)

    for matcher in SPARSE_MATCHERS:
        r, s = out["cli"][matcher], out["session"][matcher]
        print(f"sparse {matcher}: fps {r['fps']}, total {r['total_time_s']} s, read "
              f"{r['read_s']} s, {r['successful_steps']} of {r['steps']} steps succeed, ATE "
              f"{r['ate_rmse_m'] * 1e3} mm, RPE {r['rpe_trans_rmse_m'] * 1e3} mm "
              f"{np.degrees(r['rpe_rot_rmse_rad'])} deg [{smi}]", flush=True)
        print(f"sparse {matcher} session: median step {s['median_step_ms']} ms, "
              f"{s['host_reads_per_step']} host reads and {s['peak_bytes_per_step']} peak bytes "
              f"in step {SPARSE_READS_AT} [{smi}]", flush=True)
        c = out["cross"][matcher]
        print(f"sparse {matcher} card vs CPU: success {c['success']}, max |pose diff| "
              f"{c['max_abs_pose_diff']}, selections {c.get('selections')}", flush=True)
    print(f"sparse stage ms at {HEIGHT}x{WIDTH}: {json.dumps(out['stage_ms'])} [{smi}]",
          flush=True)
    print(f"sparse launches of the port's kernels: {out['launches']}", flush=True)
    print(f"sparse phase: {out['seconds']} s", flush=True)

    backend = f"cuda:{torch.cuda.get_device_name(0)}" if dev.type == "cuda" else "cpu"
    for matcher in SPARSE_MATCHERS:
        r, bounds = out["cli"][matcher], SPARSE_CLI_BOUNDS[matcher]
        if r["backend"] != backend or r["frames"] != CLI_FRAMES or r["steps"] != CLI_FRAMES - 1:
            raise AssertionError(f"sparse {matcher}: ran on {r['backend']} over {r['frames']} "
                                 f"frames, {r['steps']} steps")
        if r["written"] != ["report.json", "trajectory.txt"]:
            raise AssertionError(f"sparse {matcher}: wrote {r['written']}")
        if (r["ate_rmse_m"] * 1e3 > bounds["ate_mm"]
                or r["rpe_trans_rmse_m"] * 1e3 > bounds["rpe_mm"]
                or np.degrees(r["rpe_rot_rmse_rad"]) > bounds["rpe_deg"]):
            raise AssertionError(f"sparse {matcher}: ATE / RPE above the expected bound")
        c = out["cross"][matcher]
        if c["success"]["card"] != c["success"]["cpu"]:
            raise AssertionError(f"sparse {matcher}: success flags part: {c['success']}")
        if c["max_abs_pose_diff"] > SPARSE_POSE_ATOL:
            raise AssertionError(f"sparse {matcher}: card and CPU poses part by "
                                 f"{c['max_abs_pose_diff']}")
        if any(s["parted_cells"] for s in c.get("selections", [])):
            raise AssertionError(f"sparse {matcher}: coarse selections part: {c['selections']}")
    return out


# ---------------------------------------------------------------------------
# Phase 9: training the LoFTR-lite matcher.
# ---------------------------------------------------------------------------

TRAIN_FRAMES = 10  # the bundled set's length


def bundled_dataset(root: Path, height: int = HEIGHT, width: int = WIDTH,
                    frames: int = TRAIN_FRAMES, seed: int = SEED) -> Path:
    """Write a bundled-format directory (``ground_truth.json`` of 4x4
    camera-to-world poses, ``camera_intrinsics.yaml``, RGB and 16-bit depth
    PNGs at 5000 DN per metre) into ``root``: the seeded synthetic scene with
    the TUM fr1 camera along ``handheld_trajectory(frames, seed)``."""
    from dense_visual_odometry_torch.apps.make_dataset import TUM_DN_PER_M
    from dense_visual_odometry_torch.io import png

    gray, depth, k = synthetic.textured_scene(height, width, seed=seed)
    poses = synthetic.handheld_trajectory(frames, seed=seed)
    grays, depths = synthetic.render_sequence(gray, depth, k, poses)
    for sub in ("rgb", "depth"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    gt = {}
    for i, (g, d, pose) in enumerate(zip(grays, depths, poses)):
        g8 = np.clip(np.round(g), 0, 255).astype(np.uint8)
        png.write(root / f"rgb/{i}.png", np.stack([g8] * 3, axis=-1))
        png.write(root / f"depth/{i}.png",
                  np.clip(np.round(d * TUM_DN_PER_M), 0, 65535).astype(np.uint16))
        gt[str(i)] = {"rgb": f"rgb/{i}.png", "depth": f"depth/{i}.png",
                      "transformation": pose.tolist()}
    (root / "ground_truth.json").write_text(json.dumps(gt))
    (root / "camera_intrinsics.yaml").write_text(
        f"intrinsics: {np.asarray(k, float).tolist()}\ndepth_scale: {1.0 / TUM_DN_PER_M}\n")
    return root


# (b) apps.train_matcher at its defaults (dim 64, two layers, scale 0.5:
# 320x240, 1,200 tokens a frame; 48 pairs, 8 held out, 800 steps, lr 1e-3,
# fine weight 0.25).  Bounds from both packages' CPU runs of the same
# arguments on the same directory (``tests/jax_smoke_scene.py --train``):
# JAX precision 0.9377, recall 0.4359, fine 1.632 px, final loss 2.281; the
# port 0.9631, 0.4495, 1.611 px, 2.325.  Training in float32 parts any two
# runs, and the packages' initial weights come from different streams, so
# the margins are wide: precision 0.1 below the JAX run's, recall and the
# fine error a quarter worse, the loss half again.  The coarse-centre
# baseline depends on the data alone: the JAX run's within 1e-6 px.
TRAIN_BOUNDS = {"holdout_precision_min": 0.84, "holdout_recall_min": 0.33,
                "holdout_fine_px_max": 2.04, "holdout_coarse_px": 2.9755408316850662,
                "final_loss_max": 3.42}
TRAIN_LOSS_EVERY = 100
# (c) The first TRAIN_CROSS_STEPS steps at full width on the card and on the
# CPU from one init.  cuDNN's convolution algorithms and the gather's atomic
# backward sum in other orders than the CPU, so the two part by rounding:
# the first step's gradients, each parameter's within TRAIN_CROSS_GRAD_RTOL
# of its CPU gradient's norm; each step's loss within TRAIN_CROSS_LOSS_RTOL.
# Adam divides by the root of the second moment, so an element whose
# gradient's sign rounding decides moves by up to the rate either way each
# step: the parameters within TRAIN_CROSS_PARAM_ATOL, twice the rate times
# the steps, and the whole update within TRAIN_CROSS_UPDATE_RTOL (the norm
# of the card-CPU difference over the norm of the card's update).  Measured
# on an H100: gradients 5.1e-5, losses 1.6e-5, parameters 1.7e-3 (14
# elements above a tenth of the rate, the largest in ``l0_self_k``, whose
# gradient has a null direction: adding one vector to every key leaves each
# query's softmax as it is), the update 1.8e-3.
TRAIN_CROSS_STEPS = 5
TRAIN_CROSS_GRAD_RTOL = 5e-4
TRAIN_CROSS_LOSS_RTOL = 1e-4
TRAIN_CROSS_PARAM_ATOL = 2 * 1e-3 * TRAIN_CROSS_STEPS
TRAIN_CROSS_UPDATE_RTOL = 0.02
# (d) The trained file serves SparseVO(matcher="learned") over the first
# TRAIN_SERVE_FRAMES frames of phase 5's directory.
TRAIN_SERVE_FRAMES = 4
# (e) apps.visualize on phase 5's tpu_fast report: the card's cloud against
# the CPU's.
VISUALIZE_ATOL = 1e-5
# (f) Profiled training steps.
TRAIN_PROFILED_STEPS = 10


def train_cross(data, dev) -> dict:
    """(c): the first TRAIN_CROSS_STEPS training steps on ``dev`` and on the
    CPU from one ``init_params`` draw, the pairs of the tool's own stream;
    the peak memory of a card step above what was allocated before it."""
    from dense_visual_odometry_torch.apps import train_matcher
    from dense_visual_odometry_torch.models import matcher

    args = train_matcher.parse_args([])
    params = matcher.init_params(torch.Generator().manual_seed(SEED), dim=args.dim,
                                 layers=args.layers)
    sides = {}
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model = matcher.LoFTRLite.from_numpy(params, d)
        opt, sched = train_matcher.make_optimizer(model, args.lr, args.steps)
        sides[side] = (model, opt, sched, train_matcher.upload(data, d))
    pick = np.random.default_rng(args.seed + 1)
    out = {"losses": {"card": [], "cpu": []}}
    for step in range(TRAIN_CROSS_STEPS):
        i = int(pick.choice(np.arange(args.pairs)))
        for side, (model, opt, sched, tensors) in sides.items():
            if side == "card" and step == TRAIN_CROSS_STEPS - 1:
                torch.cuda.synchronize(dev)
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            loss = train_matcher.train_step(model, opt, sched, tensors, i, args.fine_weight)
            out["losses"][side].append(float(loss))
            if side == "card" and step == TRAIN_CROSS_STEPS - 1:
                out["peak_bytes_per_step"] = int(torch.cuda.max_memory_allocated(dev) - base)
        if step == 0:  # the gradients at the init, each parameter against its norm
            grads = {side: {n: p.grad.cpu() for n, p in sides[side][0].named_parameters()}
                     for side in sides}
            out["grad_rel_diff"] = {n: float((grads["card"][n] - g).abs().max()
                                             / max(float(g.norm()), 1e-30))
                                    for n, g in grads["cpu"].items()}
    card, cpu = (matcher.params_to_numpy(dict(sides[s][0].named_parameters()))
                 for s in ("card", "cpu"))
    diff = {k: np.abs(card[k] - cpu[k]) for k in card}
    out["loss_rel_diff"] = [abs(a - b) / abs(b) for a, b in
                            zip(out["losses"]["card"], out["losses"]["cpu"])]
    out["max_grad_rel_diff"] = max(out.pop("grad_rel_diff").values())
    worst = max(diff, key=lambda k: diff[k].max())
    out["max_abs_param_diff"] = {"value": float(diff[worst].max()), "parameter": worst,
                                 "elements_above_rate_over_10": int(sum(
                                     (d > args.lr / 10).sum() for d in diff.values()))}
    moved = np.sqrt(sum(float(((card[k] - params[k]) ** 2).sum()) for k in card))
    out["update_rel_diff"] = float(np.sqrt(sum(float((d ** 2).sum()) for d in diff.values()))
                                   / moved)
    return out


def profile_training(data, dev, root: Path) -> dict:
    """(f): TRAIN_PROFILED_STEPS steps, each in ``trace_span("train_step")``
    and ending in the loss's read as ``train_matcher.main`` does, under
    ``start_trace`` / ``stop_trace``: the device kernels each step launched
    (by the correlation ids of the launches inside its span), their summed
    time over the step's span (the device's busy share), and the allocator's
    statistics."""
    from dense_visual_odometry_torch.apps import train_matcher
    from dense_visual_odometry_torch.models import matcher
    from dense_visual_odometry_torch.utils import profiling

    args = train_matcher.parse_args([])
    model = matcher.LoFTRLite.from_numpy(matcher.init_params(
        torch.Generator().manual_seed(SEED), dim=args.dim, layers=args.layers), dev)
    opt, sched = train_matcher.make_optimizer(model, args.lr, args.steps)
    tensors = train_matcher.upload(data, dev)
    float(train_matcher.train_step(model, opt, sched, tensors, 0, args.fine_weight))  # warm-up
    profiling.enable_tracing()
    profiling.start_trace(root / "train_trace")
    for i in range(TRAIN_PROFILED_STEPS):
        with profiling.trace_span("train_step"):
            float(train_matcher.train_step(model, opt, sched, tensors, i % args.pairs,
                                           args.fine_weight))
    trace = profiling.stop_trace()
    profiling.disable_tracing()
    profiling.drain()
    events = json.loads(trace.read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "train_step" and e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    launches = [e for e in events if e.get("cat") == "cuda_runtime" and e.get("ph") == "X"]
    kernels = {e["args"].get("correlation"): e for e in events
               if e.get("cat") == "kernel" and e.get("ph") == "X"}
    steps = []
    for span in spans:
        lo, hi = span["ts"], span["ts"] + span["dur"]
        ids = {e["args"].get("correlation") for e in launches if lo <= e["ts"] <= hi}
        mine = [kernels[c] for c in ids if c in kernels]
        steps.append({"span_us": span["dur"], "kernels": len(mine),
                      "kernel_us": sum(k["dur"] for k in mine)})
    stats = profiling.device_memory_stats(dev)
    return {
        "trace": str(trace.relative_to(root)), "spans": len(spans), "steps": steps,
        "kernels_per_step": float(np.median([s["kernels"] for s in steps])) if steps else 0.0,
        "busy_share": (sum(s["kernel_us"] for s in steps) / sum(s["span_us"] for s in steps)
                       if steps else 0.0),
        "memory_stats": None if stats is None else {
            k: stats[k] for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")},
    }


def visualize_clouds(report: Path, dev, root: Path) -> dict:
    """(e): ``apps.visualize report <report> --ply`` on ``dev`` and on the
    CPU (with the figure and a GIF where matplotlib imports here), and the
    two clouds ``build_cloud`` gives, compared."""
    from dense_visual_odometry_torch.apps import visualize

    try:
        import matplotlib  # noqa: F401

        drawn = True
    except ImportError:
        drawn = False
    out = {"matplotlib": drawn}
    est, _, info = visualize.load_poses("report", report)
    seq = visualize.load_sequence(info.get("type", "test"), info)
    clouds = {}
    for side, platform in (("card", dev.type), ("cpu", "cpu")):
        ply = root / f"cloud_{side}.ply"
        argv = ["report", str(report), "--ply", str(ply), "--platform", platform,
                "-o", str(root / f"trajectory_{side}.png")]
        if drawn:
            visualize.main([*argv, "--animate", str(root / f"replay_{side}.gif"),
                            "--animate-stride", "5"])
        else:  # main's steps without the figure
            pts, cols = visualize.build_cloud(est, seq, 3, 200_000, platform)
            visualize.write_ply(ply, pts, cols)
        clouds[side] = visualize.build_cloud(est, seq, 3, 200_000, platform)
        out[f"{side}_written"] = sorted(p.name for p in root.glob(f"*_{side}.*"))
    out["points"] = len(clouds["card"][0])
    out["same_colours"] = bool(np.array_equal(clouds["card"][1], clouds["cpu"][1]))
    out["max_abs_point_diff"] = float(np.abs(clouds["card"][0] - clouds["cpu"][0]).max())
    out["ply_equal"] = (root / "cloud_card.ply").read_bytes() == (root / "cloud_cpu.ply").read_bytes()
    return out


def run_train(dev, root: Path, smi: str) -> dict:
    """Phase 9 on ``dev``: (a) a bundled-format directory, (b)
    ``apps.train_matcher`` at its defaults on it (holdout within
    TRAIN_BOUNDS), (c) the card against the CPU over the first steps, (d) the
    trained file serving ``SparseVO(matcher="learned")`` on phase 5's
    directory, (e) ``apps.visualize`` on phase 5's report, card against
    CPU, (f) profiled steps.  The launch counts are zeroed just before (b)
    and read just after (f).  Raises on any failed check."""
    from dense_visual_odometry_torch.apps import train_matcher
    from dense_visual_odometry_torch.io.datasets import host_gray_u8, load_tum_sequence
    from dense_visual_odometry_torch.models import matcher
    from dense_visual_odometry_torch.models.sparse import SparseVO

    out = {"phase": "train", "image": [HEIGHT, WIDTH], "frames": TRAIN_FRAMES}
    t_phase = time.perf_counter()
    data_dir = bundled_dataset(root / "bundled")
    out["write_dataset_s"] = time.perf_counter() - t_phase
    weights = root / "trained" / "loftr_lite.npz"
    zero_launches()
    summary = train_matcher.main(["--data-dir", str(data_dir), "-o", str(weights)])
    losses, step_s = summary.pop("losses"), summary.pop("step_s")
    out["dataset_s"] = summary.pop("dataset_s")
    out["summary"] = summary
    out["first_step_ms"] = step_s[0] * 1e3
    out["median_step_ms"] = float(np.median(step_s[1:])) * 1e3
    out["loss_at"] = {str(t): losses[t] for t in
                      (*range(0, len(losses), TRAIN_LOSS_EVERY), len(losses) - 1)}

    data = train_matcher.build_dataset(train_matcher.parse_args(["--data-dir", str(data_dir)]))
    out["cross"] = train_cross(data, dev)

    seq = load_tum_sequence(root / "seq", camera_yaml=root / "camera.yaml")
    trained, committed = matcher.load_params(weights), matcher.load_params()
    out["same_layout_as_committed"] = (
        {k: v.shape for k, v in trained.items()} == {k: v.shape for k, v in committed.items()})
    vo = SparseVO(seq.camera, seed=SEED, matcher="learned", matcher_weights=weights, device=dev)
    served, poses = [], []
    for n in range(TRAIN_SERVE_FRAMES):
        rgb, depth = seq.frame(n)
        poses.append(vo.step(host_gray_u8(rgb).astype(np.float32), depth).cpu())
        if vo.last_result is not None:
            served.append(bool(vo.last_result.success))
    out["serve"] = {"success": served, "finite": bool(torch.isfinite(torch.stack(poses)).all()),
                    "translation_m": float(torch.stack(poses)[-1, :3, 3].norm()),
                    "model_device": str(next(vo.model.parameters()).device)}

    out["visualize"] = visualize_clouds(root / "out_tpu_fast" / "report.json", dev, root)
    out["profile"] = profile_training(data, dev, root)
    out["launches"], _ = read_launches()
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)

    c, p, v = out["cross"], out["profile"], out["visualize"]
    print(f"train dataset: {TRAIN_FRAMES} frames written in {out['write_dataset_s']} s, "
          f"the training pairs rendered in {out['dataset_s']} s", flush=True)
    print(f"train steps: first {out['first_step_ms']} ms, median {out['median_step_ms']} ms, "
          f"peak {c['peak_bytes_per_step']} bytes a step, {p['kernels_per_step']} kernels a "
          f"step, device busy {p['busy_share']} of a step [{smi}]", flush=True)
    print(f"train loss: {json.dumps(out['loss_at'])}", flush=True)
    print(f"train holdout: {json.dumps(summary)}", flush=True)
    print(f"train card vs CPU: first gradients' max rel diff {c['max_grad_rel_diff']}; over "
          f"{TRAIN_CROSS_STEPS} steps loss rel diff {c['loss_rel_diff']}, max |param diff| "
          f"{json.dumps(c['max_abs_param_diff'])}, update rel diff {c['update_rel_diff']}",
          flush=True)
    print(f"train serve: {json.dumps(out['serve'])}", flush=True)
    print(f"visualize: matplotlib {'imports' if v['matplotlib'] else 'does not import'}; "
          f"{v['points']} points, max |card - cpu| {v['max_abs_point_diff']}, PLY equal "
          f"{v['ply_equal']}", flush=True)
    print(f"train launches of the port's kernels: {out['launches']}", flush=True)
    print(f"train phase: {out['seconds']} s", flush=True)

    b = TRAIN_BOUNDS
    if (summary["holdout_precision"] < b["holdout_precision_min"]
            or summary["holdout_recall"] < b["holdout_recall_min"]
            or summary["holdout_fine_px"] > b["holdout_fine_px_max"]
            or abs(summary["holdout_coarse_px"] - b["holdout_coarse_px"]) > 1e-6
            or not summary["final_loss"] <= b["final_loss_max"]):
        raise AssertionError(f"train: the holdout is outside TRAIN_BOUNDS: {summary}")
    if len(losses) != summary["steps"] or not np.isfinite(losses).all():
        raise AssertionError("train: a loss is missing or not finite")
    if (c["max_grad_rel_diff"] > TRAIN_CROSS_GRAD_RTOL
            or max(c["loss_rel_diff"]) > TRAIN_CROSS_LOSS_RTOL
            or c["max_abs_param_diff"]["value"] > TRAIN_CROSS_PARAM_ATOL
            or c["update_rel_diff"] > TRAIN_CROSS_UPDATE_RTOL):
        raise AssertionError(f"train: the card and the CPU part: {c}")
    if not out["same_layout_as_committed"]:
        raise AssertionError("train: the trained file's keys or shapes are not the committed's")
    if (len(served) != TRAIN_SERVE_FRAMES - 1 or not out["serve"]["finite"]
            or out["serve"]["model_device"] != str(dev)):
        raise AssertionError(f"train: the trained file did not serve: {out['serve']}")
    if v["max_abs_point_diff"] > VISUALIZE_ATOL or not v["same_colours"] or not v["points"]:
        raise AssertionError(f"visualize: the card's and the CPU's clouds part: {v}")
    if any(not v[f"{side}_written"] for side in ("card", "cpu")):
        raise AssertionError(f"visualize: nothing written: {v}")
    if p["spans"] != TRAIN_PROFILED_STEPS or not p["kernels_per_step"]:
        raise AssertionError(f"profile: the spans or their kernels are missing: {p}")
    if p["memory_stats"] is None:
        raise AssertionError("profile: device_memory_stats() is None on the card")
    return out


# ---------------------------------------------------------------------------
# Phase 10: the multi-device back end (torch.distributed).
# ---------------------------------------------------------------------------

# (a) runs these over a world of one rank (NCCL, in this process) at phase 4's
# B=64, and (b) over DIST_WORLD spawned ranks (gloo: the only way to run
# several ranks on one card) that all drive cuda:0: 16 pairs a rank.
DIST_CONFIGS = ("tpu_fast", "slam_tiles_cb48", "parity_esm")
DIST_WORLD = 4
# The pose graph: the chain of the first 63 tracked tpu_fast transforms (64
# poses) and a loop edge every 4 poses to the pose 8 on, each off the chain
# by a seeded twist of scale 1e-3.
DIST_LOOPS = tuple((t, t + 8) for t in range(0, 56, 4))
DIST_GRAPH_ITERS = 10
# The dense BA: BASELINE config 4's 8-keyframe window at phase 6 (c)'s scale,
# every second frame of the scene, the true poses but pose 0 moved by a
# seeded perturbation (DIST_BA_NOISE_M of translation, a tenth of it in rad).
DIST_BA_KEYFRAMES = tuple(range(0, 16, 2))
DIST_BA_STRIDE, DIST_BA_WINDOW, DIST_BA_ITERS = 8, 2, 8
DIST_BA_NOISE_M = 0.004
# That reduced pose system is ill-conditioned in float32 (its rotation
# columns are zero, as the JAX package's are, and only the damping holds
# them): a sum taken in another order moves its step by ~1e-2 of itself, and
# the Huber weights and validity tests amplify that over the iterations.  So
# at world DIST_WORLD the scene's reduced system is held to the single-device
# one within DIST_SYSTEM_RTOL of each array's largest entry (float32 sums in
# another order), its 8-iteration result is reported beside the
# single-device run's own response to its poses moved by DIST_BA_NUDGE_M,
# and the JAX package's bounds (``dryrun.BOUNDS``) hold the dense BA on the
# JAX package's own sharded test problem (``planar_ba_problem``).
DIST_SYSTEM_RTOL = 1e-5
DIST_BA_NUDGE_M = 1e-7
DIST_REPEATS = 3  # timed runs of each world-1 check
DIST_TIMEOUT_S = 300.0


def dist_inputs(frames, poses, k_dev, grays, depths, k_np, dev) -> dict:
    """Phase 10's inputs on ``dev``: phase 4's B=64 rows of the 15 pairs,
    the pose graph over their tracked chain and the dense BA problem."""
    from dense_visual_odometry_torch.models.dense_ba import build_dense_ba_data
    from dense_visual_odometry_torch.parallel.dryrun import chain_graph

    pairs = [(i, i + 1) for i in range(N_FRAMES - 1)]
    rows = (pairs * (-(-MAIN_BATCH // len(pairs))))[:MAIN_BATCH]
    prev, curr, _ = batch_inputs(frames, poses, rows, dev, False)
    chain = batched_track_pair(prev, curr, k_dev, config("tpu_fast")).transform[:-1]
    graph = chain_graph(chain, DIST_LOOPS, seed=SEED)
    rng = np.random.default_rng(SEED)
    kf_poses = np.stack([poses[i] for i in DIST_BA_KEYFRAMES]).astype(np.float32)
    for t in range(1, len(DIST_BA_KEYFRAMES)):
        twist = np.concatenate([rng.normal(size=3) * DIST_BA_NOISE_M,
                                rng.normal(size=3) * DIST_BA_NOISE_M / 10])
        kf_poses[t] = se3.exp(torch.tensor(twist, dtype=torch.float32)).numpy() @ kf_poses[t]
    data = build_dense_ba_data([grays[i] for i in DIST_BA_KEYFRAMES],
                               [depths[i] for i in DIST_BA_KEYFRAMES], k_np,
                               grid_stride=DIST_BA_STRIDE, window=DIST_BA_WINDOW, device=dev)
    return {"prev": prev, "curr": curr, "k": k_dev, "graph": graph,
            "ba": {"scene": (torch.tensor(kf_poses, device=dev), data),
                   "planar": planar_ba_problem(dev)}}


def planar_ba_problem(dev):
    """The JAX package's sharded dense BA test problem
    (``tests/unit/test_dense_ba.py``: ``test_sharded_matches_single_device``):
    8 keyframes of a textured plane at 2 m, 48x64, the camera stepping 1.5 cm
    in x, grid stride 6, every pose but the first moved by up to 5 mm in x
    -> (poses, data)."""
    from dense_visual_odometry_torch.models.dense_ba import build_dense_ba_data

    h, w, fx, z0, tx, k = 48, 64, 60.0, 2.0, 0.015, 8
    k_mat = np.array([[fx, 0.0, (w - 1) / 2], [0.0, fx, (h - 1) / 2], [0.0, 0.0, 1.0]],
                     np.float32)
    v, u = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64),
                       indexing="ij")
    shift = fx * tx / z0
    grays, poses = [], []
    for i in range(k):
        ui = u - i * shift
        grays.append((120.0 + 45.0 * np.sin(2 * np.pi * ui / 23.0)
                      + 35.0 * np.cos(2 * np.pi * v / 17.0)
                      + 20.0 * np.sin(2 * np.pi * (ui + 2 * v) / 41.0)).astype(np.float32))
        pose = np.eye(4)
        pose[0, 3] = -i * tx
        poses.append(pose)
    poses = np.stack(poses)
    poses[1:, 0, 3] += np.random.default_rng(1).uniform(-0.005, 0.005, size=k - 1)
    data = build_dense_ba_data(grays, [np.full((h, w), z0, np.float32)] * k, k_mat,
                               grid_stride=6, device=dev)
    return torch.tensor(poses, dtype=torch.float32, device=dev), data


def _to(tree, dev):
    """Every tensor of nested dicts, tuples and NamedTuples moved to ``dev``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(x, dev) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(x, dev) for x in tree)
    return tree


def _dist_run(dev, inputs, single, repeats, unheld=()):
    """This rank's dry run on ``dev``, its launch counts zeroed just before
    and read just after."""
    from dense_visual_odometry_torch.models.dense_ba import DenseBAConfig
    from dense_visual_odometry_torch.parallel import make_mesh
    from dense_visual_odometry_torch.parallel.dryrun import dryrun_multichip

    mesh = make_mesh(dev.type)
    configs = {name: config(name) for name in DIST_CONFIGS}
    zero_launches()
    run = dryrun_multichip(mesh, inputs["prev"], inputs["curr"], inputs["k"], configs,
                           inputs["graph"], inputs["ba"], DIST_GRAPH_ITERS,
                           DenseBAConfig(max_iterations=DIST_BA_ITERS), single=single,
                           repeats=repeats, unheld=unheld)
    launches, _ = read_launches()
    return run, launches


def _dist_rank(rank, world, inputs, single, device_type):
    """Phase 10 (b): one spawned rank, on the card's first device."""
    dev = torch.device(device_type, 0) if device_type == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    from dense_visual_odometry_torch.models.dense_ba import DenseBAConfig, reduced_system_sharded
    from dense_visual_odometry_torch.parallel import make_mesh

    inputs = _to(inputs, dev)
    run, launches = _dist_run(dev, inputs, _to(single, dev), 1, unheld=("dense_ba_scene",))
    system = reduced_system_sharded(make_mesh(dev.type), *inputs["ba"]["scene"],
                                    DenseBAConfig(max_iterations=DIST_BA_ITERS))
    return {"sharded": _to(run.sharded, "cpu"), "errors": run.errors, "wall_ms": run.wall_ms,
            "launches": launches, "scene_system": _to(system, "cpu")}


def _results_equal(a, b) -> bool:
    """Every tensor of two results equal bit for bit."""
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and bool(torch.equal(a.cpu(), b.cpu()))
    return all(_results_equal(x, y) for x, y in zip(a, b))


def run_distributed(frames, poses, k_dev, grays, depths, k_np, dev, smi) -> dict:
    """Phase 10 on ``dev``: the dry run of the multi-device back end
    (``parallel.dryrun``: sharded tracking under DIST_CONFIGS, the
    edge-sharded pose graph, the owner-sharded dense BA on the scene and on
    ``planar_ba_problem``), (a) at world 1 over NCCL (gloo on the CPU) in
    this process, equal bit for bit to the single-device runs, with its own
    launch counts; (b) at world DIST_WORLD over gloo, spawned ranks all on
    ``dev``, within ``dryrun.BOUNDS`` of (a)'s single-device runs but for
    the scene's dense BA (see DIST_SYSTEM_RTOL), and equal across ranks.
    Raises on any failed check."""
    import torch.distributed as dist

    from dense_visual_odometry_torch.models.dense_ba import (
        DenseBAConfig,
        build_reduced_system,
        optimize_dense_ba,
    )
    from dense_visual_odometry_torch.parallel.distributed import default_backend, spawn_ranks
    from dense_visual_odometry_torch.parallel.dryrun import single_device

    out = {"phase": "distributed", "image": [HEIGHT, WIDTH], "batch": MAIN_BATCH,
           "configs": list(DIST_CONFIGS), "world": DIST_WORLD}
    t_phase = time.perf_counter()
    inputs = dist_inputs(frames, poses, k_dev, grays, depths, k_np, dev)
    configs = {name: config(name) for name in DIST_CONFIGS}
    ba_cfg = DenseBAConfig(max_iterations=DIST_BA_ITERS)
    single, single_ms = single_device(
        inputs["prev"], inputs["curr"], inputs["k"], configs, inputs["graph"], inputs["ba"],
        DIST_GRAPH_ITERS, ba_cfg, repeats=DIST_REPEATS)
    scene_poses, scene_data = inputs["ba"]["scene"]
    scene_system = build_reduced_system(scene_poses, scene_data.inv_depth0, scene_data,
                                        ba_cfg)[:3]
    nudged_poses = scene_poses.clone()
    nudged_poses[1:, :3, 3] += DIST_BA_NUDGE_M
    nudged = optimize_dense_ba(nudged_poses, scene_data, ba_cfg)
    ref = single["dense_ba_scene"]
    out["scene_ba_nudged"] = {
        "nudge_m": DIST_BA_NUDGE_M,
        "ba_poses": float((nudged.poses - ref.poses).abs().max()),
        "ba_inv_depth": float((nudged.inv_depth - ref.inv_depth).abs().max()),
        "ba_chi2_rel": abs(float(nudged.chi2) - float(ref.chi2)) / abs(float(ref.chi2)),
    }

    # (a) world 1 in this process.
    with tempfile.TemporaryDirectory(prefix="dvo_dist_") as tmp:
        dist.init_process_group(default_backend(dev), init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            run1, launches = _dist_run(dev, inputs, single, DIST_REPEATS)
        finally:
            dist.destroy_process_group()
    out["world1"] = {
        "backend": default_backend(dev), "launches": launches, "errors": run1.errors,
        "bit_equal": {name: _results_equal(run1.sharded[name], single[name])
                      for name in single},
        "sharded_ms": {name: w["sharded"] for name, w in run1.wall_ms.items()},
        "single_ms": single_ms,
    }
    # One all_reduce a Gauss-Newton iteration of (chi2, H or A', b or b').
    sizes = {"pose_graph": inputs["graph"][0].shape[0],
             **{f"dense_ba_{n}": p.shape[0] for n, (p, _) in inputs["ba"].items()}}
    out["all_reduce_bytes_per_iteration"] = {
        name: {"H": k * k * 36 * 4, "rhs": k * 6 * 4, "chi2": 4,
               "total": (1 + k * k * 36 + k * 6) * 4}
        for name, k in sizes.items()}
    out["pose_graph"] = {"poses": sizes["pose_graph"],
                         "edges": int(inputs["graph"][1].i.shape[0]),
                         "iterations": int(single["pose_graph"].iterations)}
    out["dense_ba"] = {n: {"keyframes": p.shape[0], "grid_points": int(d.grid_u.shape[0])}
                       for n, (p, d) in inputs["ba"].items()}

    # (b) DIST_WORLD spawned ranks over gloo, all on dev.
    t0 = time.perf_counter()
    ranks = spawn_ranks(_dist_rank, DIST_WORLD,
                        (_to(inputs, "cpu"), _to(single, "cpu"), dev.type),
                        backend="gloo", timeout_s=DIST_TIMEOUT_S)
    system_err = {
        name: max(float((r["scene_system"][i] - want.cpu()).abs().max()) for r in ranks)
        / float(want.abs().max())
        for i, (name, want) in enumerate(zip(("chi2", "A", "b"), scene_system))}
    out["world4"] = {
        "backend": "gloo", "device": str(dev), "spawn_s": time.perf_counter() - t0,
        "max_errors": {check: {f: max(r["errors"][check][f] for r in ranks)
                               for f in ranks[0]["errors"][check]}
                       for check in ranks[0]["errors"]},
        "scene_system_rel_err": system_err,
        "ranks_equal": {name: all(_results_equal(r["sharded"][name], ranks[0]["sharded"][name])
                                  for r in ranks) for name in single},
        "sharded_ms_time_shared": [{n: w["sharded"] for n, w in r["wall_ms"].items()}
                                   for r in ranks],
        "launches": [r["launches"] for r in ranks],
    }
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)

    w1, w4 = out["world1"], out["world4"]
    for name in single:
        print(f"distributed {name}: world 1 ({w1['backend']}) {w1['sharded_ms'][name]} ms "
              f"against single-device {single_ms[name]} ms (overhead "
              f"{w1['sharded_ms'][name] - single_ms[name]} ms) [{smi}]", flush=True)
    for name in single:
        print(f"distributed {name}: world {DIST_WORLD} (gloo, {DIST_WORLD} ranks time-sharing "
              f"one card, not a scaling figure) ms by rank "
              f"{[r[name] for r in w4['sharded_ms_time_shared']]}", flush=True)
    print(f"distributed all_reduce bytes per Gauss-Newton iteration: "
          f"{json.dumps(out['all_reduce_bytes_per_iteration'])}", flush=True)
    print(f"distributed world {DIST_WORLD} max errors against single-device: "
          f"{json.dumps(w4['max_errors'])}", flush=True)
    print(f"distributed scene dense BA: world {DIST_WORLD}'s reduced system within "
          f"{json.dumps(system_err)} of each array's largest entry; the single-device run "
          f"moved by {json.dumps(out['scene_ba_nudged'])} when its poses move "
          f"{DIST_BA_NUDGE_M} m", flush=True)
    print(f"distributed launches of the port's kernels: world 1 {launches}; world "
          f"{DIST_WORLD} by rank {w4['launches']}", flush=True)
    print(f"distributed phase: {out['seconds']} s (spawned world {w4['spawn_s']} s)", flush=True)

    if not all(w1["bit_equal"].values()):
        raise AssertionError(f"distributed: world 1 is not single-device bit for bit: "
                             f"{w1['bit_equal']}")
    if not all(w4["ranks_equal"].values()):
        raise AssertionError(f"distributed: the ranks' results differ: {w4['ranks_equal']}")
    if not max(system_err.values()) <= DIST_SYSTEM_RTOL:
        raise AssertionError(f"distributed: the scene's reduced system parts: {system_err}")
    scene = w4["max_errors"]["dense_ba_scene"]
    if not all(np.isfinite(v) for v in scene.values()):
        raise AssertionError(f"distributed: the scene's dense BA is not finite: {scene}")
    if min(launches.values()) < 1:
        raise AssertionError(f"distributed: a kernel never launched at world 1: {launches}")
    return out


def zero_launches() -> None:
    """Every launch count of the port's kernels to 0."""
    from dense_visual_odometry_torch.ops.cuda.pyramid import median_pyr_down
    from dense_visual_odometry_torch.ops.cuda.tsdf import integrate_volume, raycast_volume

    lm_level.launches = 0
    lm_level.block_launches = 0
    lm_level.tile_launches = 0
    for fn in (lm_level, fused_iter.fused_evaluation, stack_accumulate):
        fn.launches = 0
        fn.runtime_stride_launches = 0
    median_pyr_down.launches = 0
    integrate_volume.launches = 0
    raycast_volume.launches = 0


def read_launches():
    """-> ({kernel: launches}, {kernel: launches at a grid stride >= 3})."""
    fns = {"level_solver": lm_level, "fused_iter": fused_iter.fused_evaluation,
           "stackwarp": stack_accumulate}
    return ({n: fn.launches for n, fn in fns.items()},
            {n: fn.runtime_stride_launches for n, fn in fns.items()})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "needs a CUDA GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi_line()
    emit(phase_environment(smi))
    emit(phase_build())
    kernels = run(dev, smi)
    print(f"smoke total: {time.perf_counter() - t_start} s", flush=True)
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def kernel_checks(frames, poses, cam, dev) -> list:
    """Phase 3: every kernel against its plain version at the main path's
    level shapes and batch sizes; raises if one disagrees."""
    checks = []
    for batch in PYRAMID_BATCHES:
        for level in PYRAMID_LEVELS:
            checks.append(check_pyramid_kernel(frames, dev, batch, level))
            emit(checks[-1])
    for batch in KERNEL_BATCHES:
        prev, curr, gt, pairs = kernel_batch(frames, poses, dev, batch)
        anchors = previous_motions(poses, pairs, dev)
        for level in (0, LEVELS - 1):
            for illum in (None, "bias", "affine"):
                for rel in (0.01, None):
                    checks.append(
                        check_level_kernel(prev, curr, gt, cam, dev, level, illum, rel))
                    emit(checks[-1])
            for term, illum, rel in TERM_CASES:
                checks.append(check_level_kernel(prev, curr, gt, cam, dev, level, illum, rel,
                                                 term, anchors))
                emit(checks[-1])
            for cfg_name, illum, term in BLOCK_CASES:
                rel = config(cfg_name).relative_tolerance
                checks.append(check_level_kernel(prev, curr, gt, cam, dev, level, illum, rel,
                                                 term, cfg_name=cfg_name))
                emit(checks[-1])
            checks.append(check_stack_kernel(prev, curr, gt, cam, dev, level))
            emit(checks[-1])
        for level, cfg_name in FUSED_LEVELS:
            for illum in (None, "bias"):
                checks.append(
                    check_fused_kernel(prev, curr, gt, cam, dev, illum, level, cfg_name))
                emit(checks[-1])
        # The runtime-stride variants (strides 3 and 4) at level 0.
        for s in STRIDES:
            for cfg_name, illum, term in STRIDE_LEVEL_CASES[s]:
                rel = config(cfg_name).relative_tolerance
                checks.append(check_level_kernel(prev, curr, gt, cam, dev, 0, illum, rel,
                                                 term, cfg_name=cfg_name))
                emit(checks[-1])
            for illum in (None, "bias"):
                checks.append(check_fused_kernel(prev, curr, gt, cam, dev, illum, 0,
                                                 f"fast_stride{s}"))
                emit(checks[-1])
            checks.append(check_stack_kernel(prev, curr, gt, cam, dev, 0, f"fast_stride{s}"))
            emit(checks[-1])
        if batch in SWEEP_BATCHES:
            for level in (0, LEVELS - 1):
                checks.append(check_level_geometries(prev, curr, gt, cam, dev, level))
                emit(checks[-1])
            checks.append(check_fused_geometries(prev, curr, gt, cam, dev))
            emit(checks[-1])
    failed = [c for c in checks if not c["ok"]]
    if failed:
        raise AssertionError(f"{len(failed)} kernel checks disagree with the plain versions")
    return checks


def run(dev: torch.device, smi: str) -> list:
    """Phases 3 and 4 on ``dev``; -> the per-kernel summary rows."""
    grays, depths, k_np, poses = make_sequence()
    cam = CameraModel.create(k_np, 1.0)  # rendered depth is already metric
    configs = {name: config(name) for name in (*SHIPPED, *VARIANTS)}
    cross_configs = {**configs, **{name: config(name) for name in CROSS_ONLY}}
    fast = configs["tpu_fast"]
    frames = [
        robust.preprocess_frame(g, d, cam, levels=LEVELS, max_distance=fast.max_distance,
                                device=dev)
        for g, d in zip(grays, depths)
    ]

    checks = kernel_checks(frames, poses, cam, dev)

    pairs = [(i, i + 1) for i in range(N_FRAMES - 1)]
    k_dev = cam.intrinsics.to(dev)
    # One pair that trips the hard-motion trigger sends the whole batch to
    # the gather path at that level; a batch of the pairs that pass it at
    # every level the level kernel may solve shows the kernel path alone.
    # Each configuration picks them with its own trigger (ESM relaxes the
    # rotation threshold); ``accurate_lm`` takes those of ``tpu_accurate``.
    kernel_path = {
        name: kernel_path_pairs(frames, poses, k_dev, cfg, pairs, name in PRIOR_CONFIGS)
        for name, cfg in configs.items()
        if kernel_levels(cfg) and name != "tpu_parity"
    }
    kernel_path["accurate_lm"] = kernel_path["tpu_accurate"]
    if not all(kernel_path.values()):
        raise AssertionError(f"a configuration has no kernel-path pairs: {kernel_path}")

    # Phase 4: the main path, with the launch counts zeroed just before it.
    zero_launches()
    main = {"phase": "main_path", "image": [HEIGHT, WIDTH], "pairs": len(pairs),
            "kernel_path_pairs": kernel_path}
    batched, transforms = [], {}
    variant_launches = {}  # level-kernel launches of each configuration's runs
    for name, cfg in configs.items():
        # The reference tier runs up to 100 Gauss-Newton iterations a level.
        reps = 1 if name == "reference_default" else 3
        runs = [("", pairs)] if name != "accurate_lm" else []
        if name in kernel_path:
            runs.append(("_kernel_path", kernel_path[name]))
        before = lm_level.launches
        for suffix, sel in runs:
            key = f"batched_{name}{suffix}"
            batched.append(key)
            main[key], transforms[key] = run_batched(frames, poses, k_dev, cfg, sel, reps,
                                                     anchored=name in PRIOR_CONFIGS)
        variant_launches[name] = lm_level.launches - before
    # The fused kernel once per LM iteration at levels 0-2, against the level
    # kernel on the same pairs.
    main["accurate_lm_vs_level_kernel_max_abs"] = float(np.abs(
        transforms["batched_accurate_lm_kernel_path"]
        - transforms["batched_tpu_accurate_kernel_path"]).max())
    # How far the prior moves tpu_fast's tracks, all pairs.
    main["prior_moved_max_abs"] = float(np.abs(
        transforms["batched_fast_prior"] - transforms["batched_tpu_fast"]).max())
    sessions = [f"session_{name}" for name in SESSIONS]
    for name, key in zip(SESSIONS, sessions):
        before = lm_level.launches
        main[key] = run_session(grays, depths, cam, configs[name], poses, dev)
        variant_launches[name] += lm_level.launches - before
    main["batched_session_tpu_accurate"] = run_batched_session(
        grays, depths, cam, configs["tpu_accurate"], poses, dev)
    launches, stride_launches = read_launches()
    main["launches"] = launches
    # Of the level kernel's launches, those on row blocks and on tiles.
    block_launches = {"blocks": lm_level.block_launches, "tiles": lm_level.tile_launches}
    main["level_solver_launches"] = block_launches
    # Of each kernel's launches, those of its runtime-stride variant.
    main["runtime_stride_launches"] = stride_launches
    # The pyramid kernel: two launches a level but the first, a frame.
    from dense_visual_odometry_torch.ops.cuda.pyramid import median_pyr_down

    main["pyramid_launches"] = median_pyr_down.launches
    emit(main)
    if min(*launches.values(), main["pyramid_launches"]) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}, "
                             f"pyramid {main['pyramid_launches']}")
    if min(block_launches.values()) < 1:
        raise AssertionError(f"the level kernel never launched on blocks or tiles: "
                             f"{block_launches}")
    if min(stride_launches.values()) < 1:
        raise AssertionError(f"a kernel never launched at a grid stride >= 3: "
                             f"{stride_launches}")
    # The level kernel's depth and prior variants ran on the main path.
    if min(variant_launches["fast_depth"], variant_launches["fast_prior"]) < 1:
        raise AssertionError(f"a variant of the level kernel never launched: {variant_launches}")
    # accurate_lm evaluates levels 0-2 through the fused kernel at each LM
    # iteration: more launches per call than the one level-0 Hessian.
    if main["batched_accurate_lm_kernel_path"]["fused_launches_per_call"] <= 1:
        raise AssertionError("accurate_lm did not launch the fused kernel per iteration")
    if main["accurate_lm_vs_level_kernel_max_abs"] > TOLERANCES["pose_atol"]:
        raise AssertionError("accurate_lm and the level kernel part")
    # Bounds on the noise-free synthetic scene, several times what the
    # port's CPU plain path reaches on it (``BOUNDS``; the cross-check below
    # reports it on two pairs for every configuration, reference_default
    # included).
    for name in configs:
        bounds = BOUNDS.get(name, BOUNDS["default"])
        for key in (k for k in batched if k in (f"batched_{name}", f"batched_{name}_kernel_path")):
            r = main[key]
            if not (r["finite"] and r["all_success"]):
                raise AssertionError(f"{key}: non-finite or failed tracks")
            if (r["translation_err_mm_median"] > bounds["median_mm"]
                    or r["translation_err_mm_max"] > bounds["max_mm"]
                    or r["rotation_err_deg_max"] > bounds["rotation_deg"]):
                raise AssertionError(f"{key}: tracking error above the expected bound")
    for name, key in (*zip(SESSIONS, sessions),
                      ("tpu_accurate", "batched_session_tpu_accurate")):
        sess = main[key]
        if (not (sess["finite"] and sess["all_success"])
                or sess["translation_err_mm_max"] > BOUNDS.get(name, BOUNDS["default"])["drift_mm"]):
            raise AssertionError(f"{key}: drift above the expected bound")

    # Cross-check: two pairs on the card against the port's CPU plain path.
    two = [(0, 1), (7, 8)]
    cpu_frames = {i: robust.FrameData(tuple(g.cpu() for g in frames[i].gray),
                                      tuple(d.cpu() for d in frames[i].depth_m))
                  for pair in two for i in pair}
    cross = {"phase": "cpu_cross_check", "pairs": two}
    gt_two = np.stack([gt_transform(poses, i, j) for i, j in two])
    for name, cfg in cross_configs.items():
        anchored = name in PRIOR_CONFIGS
        g_res = track(frames, poses, k_dev, cfg, two, anchored)
        c_res = track(cpu_frames, poses, cam.intrinsics, cfg, two, anchored)
        diff = float((g_res.transform.cpu() - c_res.transform).abs().max())
        cpu_terr, _ = pose_errors(c_res.transform.numpy(), gt_two)
        cross[name] = {"max_abs_transform_diff": diff,
                       "cpu_translation_err_mm": (cpu_terr * 1e3).tolist(),
                       "iterations_gpu": g_res.diagnostics.iterations.cpu().tolist(),
                       "iterations_cpu": c_res.diagnostics.iterations.tolist()}
        cross[name]["same_iterations"] = (
            cross[name]["iterations_gpu"] == cross[name]["iterations_cpu"])
    emit(cross)
    for name in cross_configs:
        if cross[name]["max_abs_transform_diff"] > TOLERANCES["pose_atol"]:
            raise AssertionError(f"{name}: GPU and CPU transforms differ")
        # The Gauss-Newton loop stops where the error moved less than the
        # tolerance, a decision at the float32 quantum of the error, and the
        # card's plain-PyTorch sums run in another order than the CPU's:
        # reference_default's counts are reported, not required equal.
        if name not in GN_CONFIGS and not cross[name]["same_iterations"]:
            raise AssertionError(f"{name}: GPU and CPU iteration counts differ")

    with tempfile.TemporaryDirectory(prefix="dvo_cli_") as tmp:
        cli = run_cli(Path(tmp))
        slam = run_slam(grays, depths, k_np, poses, dev, Path(tmp))
        mapping = run_mapping(dev, Path(tmp), smi)
        sparse = run_sparse(dev, Path(tmp), smi)
        train = run_train(dev, Path(tmp), smi)
    distributed = run_distributed(frames, poses, k_dev, grays, depths, k_np, dev, smi)

    # Per-kernel summary (level-0 cases; times from phase 3).
    def summary(name, source, replaces, check, fields):
        errs = [c["errors"][f] for c in checks if c["kernel"] == name for f in fields]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(e["max_abs"] for e in errs),
            "max_rel_err": max(e["max_rel"] for e in errs),
            "compared": list(fields),
            "ms": check["ms"], "plain_ms": check["plain_ms"],
            "bound_ms": check["bound_ms"], "bound_by": check["bound_by"],
            "library_ms": check.get("library_ms"), "shape": check["shape"],
            "card": smi,
        }

    def level_check(term, rel, cfg_name="tpu_fast"):
        return next(c for c in checks if c["kernel"] == "level_solver" and c["level"] == 0
                    and c["batch"] == SUMMARY_BATCH and c["illumination"] is None
                    and c["rel"] == rel and c["term"] == term and c["config"] == cfg_name)

    level0 = level_check(None, 0.01)
    single = [c for c in checks if c["kernel"] == "level_solver" and c["config"] == "tpu_fast"]
    fused0 = next(c for c in checks if c["kernel"] == "fused_iter" and c["level"] == 0
                  and c["illumination"] is None and c["batch"] == SUMMARY_BATCH
                  and c["config"] == "tpu_fast")
    stack0 = next(c for c in checks if c["kernel"] == "stackwarp" and c["level"] == 0
                  and c["batch"] == SUMMARY_BATCH and c["config"] == "tpu_parity")
    # The level kernel's depth and prior variants: level 0 at B=8, their
    # errors over every case of the term, their launches on the main path
    # (fast_depth's and fast_prior's runs).
    variants = {}
    for term, config_name, rel in (("depth", "fast_depth", 0.01), ("prior", "fast_prior", None)):
        check = level_check(term, rel)
        errs = [c["errors"][f] for c in single
                if (c["term"] or "").startswith(term) for f in ("est", "anchor")]
        variants[term] = {
            "launches": variant_launches[config_name],
            "max_abs_err": max(e["max_abs"] for e in errs),
            "max_rel_err": max(e["max_rel"] for e in errs),
            "ms": check["ms"], "plain_ms": check["plain_ms"], "bound_ms": check["bound_ms"],
            "bound_by": check["bound_by"], "library_ms": None, "shape": check["shape"],
        }
    # The row-block and tile variants: level 0 at B=8 of fast_blocks_ry2 and
    # parity_tiles_r2 without illumination, their errors over every case of
    # their layout, their launches on the main path.
    for kind, config_name, rel in (("blocks", "fast_blocks_ry2", 0.01),
                                   ("tiles", "parity_tiles_r2", None)):
        check = level_check(None, rel, config_name)
        errs = [c["errors"][f] for c in checks if c["kernel"] == "level_solver"
                and (c["blocks"]["cols"] > 1) == (kind == "tiles")
                and c["config"] in {name for name, _, _ in BLOCK_CASES}
                for f in ("est", "anchor")]
        variants[kind] = {
            "launches": block_launches[kind],
            "max_abs_err": max(e["max_abs"] for e in errs),
            "max_rel_err": max(e["max_rel"] for e in errs),
            "ms": check["ms"], "plain_ms": check["plain_ms"], "bound_ms": check["bound_ms"],
            "bound_by": check["bound_by"], "library_ms": None, "shape": check["shape"],
        }
    # The runtime-stride variant of each kernel: its level-0 case at B=8 at
    # each stride (the level kernel's without illumination or term), its
    # errors over every case at that stride, its launches on the main path.
    def strides(name, fields):
        out = {"runtime_stride_launches": stride_launches[name]}
        for st in STRIDES:
            cases = [c for c in checks if c["kernel"] == name and c["grid_stride"] == st]
            check = next(c for c in cases if c["batch"] == SUMMARY_BATCH
                         and c.get("illumination") is None and c.get("term") is None
                         and c["config"] == f"fast_stride{st}")
            errs = [c["errors"][f] for c in cases for f in fields]
            out[str(st)] = {
                "max_abs_err": max(e["max_abs"] for e in errs),
                "max_rel_err": max(e["max_rel"] for e in errs),
                "ms": check["ms"], "plain_ms": check["plain_ms"],
                "bound_ms": check["bound_ms"], "bound_by": check["bound_by"],
                "library_ms": check.get("library_ms"), "shape": check["shape"],
            }
        return out

    kernels = [
        {**summary("level_solver", "dense_visual_odometry_torch/ops/cuda/csrc/level_solver.cu",
                   "dense_visual_odometry_tpu/ops/pallas/level_solver.py:268", level0,
                   ("est", "anchor")), "variants": variants,
         "strides": strides("level_solver", ("est", "anchor"))},
        {**summary("fused_iter", "dense_visual_odometry_torch/ops/cuda/csrc/fused_iter.cu",
                   "dense_visual_odometry_tpu/ops/pallas/fused_iter.py:56", fused0,
                   ("H", "rhs", "err", "lam")),
         "strides": strides("fused_iter", ("H", "rhs", "err", "lam"))},
        {**summary("stackwarp", "dense_visual_odometry_torch/ops/cuda/csrc/stackwarp.cu",
                   "dense_visual_odometry_tpu/ops/pallas/stackwarp.py:38", stack0,
                   ("samples",)),
         "strides": strides("stackwarp", ("samples",))},
    ]
    for row in kernels:
        row["cli_launches"] = cli["launches"][row["name"]]
        row["slam_launches"] = slam["launches"][row["name"]]
        row["mapping_launches"] = mapping["launches"][row["name"]]
        row["sparse_launches"] = sparse["launches"][row["name"]]
        row["train_launches"] = train["launches"][row["name"]]
        row["distributed_launches"] = distributed["launches"][row["name"]]
    return kernels


if __name__ == "__main__":
    sys.exit(main())
