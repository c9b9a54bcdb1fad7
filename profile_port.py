#!/usr/bin/env python3
"""Where the port's time goes on one GPU: a torch.profiler breakdown.

Run from the root of a checkout on a machine with a CUDA GPU and nvcc:

    python3 profile_port.py [CONFIG ...]
    python3 profile_port.py --kernels
    python3 profile_port.py --wall [CONFIG ...]
    python3 profile_port.py --bits

CONFIG is ``tpu_fast`` (the default), any other name under ``configs/``, or
one of ``chip_smoke.VARIANTS`` (``parity_affine``, ``parity_esm``,
``accurate_lm``, ``fast_prior``, whose batched pairs are anchored as the
smoke anchors them, ``fast_depth``, ``fast_blocks_ry2``, ``parity_tiles_r2``,
``slam_tiles_cb48``, ``fast_stride3``, ``fast_stride4``, ``esm_stride4``).  Builds the kernels, then profiles, over the seeded
640x480 scene of ``chip_smoke.py``, ``batched_track_pair`` at B=64 over all
15 consecutive pairs and, where the configuration has level-kernel levels,
over the pairs that its hard-motion trigger passes at each of them
(``chip_smoke.kernel_path_pairs``), and for the configurations of
``chip_smoke.SESSIONS`` the 16-frame ``OdometrySession`` (B=1).  Each run is done once unprofiled as a warm-up.
Prints one JSON line per run: wall time, device kernel time and its share
of the wall time, the number of device kernels the run launched and how
many of each name, the kernels that took the most device time, the device
time and launches of each of the port's own kernels, and whether the
profiled run's result equals the warm-up's bit for bit.

``--kernels`` instead times the level, fused and stack kernels on the
inputs of ``chip_smoke.py``'s kernel checks (levels 0 and 3, B=1, 8 and 64,
every illumination variant and stopping rule of the level kernel, and its
depth and prior cases; the fused
kernel at level 0 without illumination and with the bias; ``F.grid_sample``
beside the stack kernel) with its yardstick ``chip_smoke.time_ms``, one
JSON line each, and says how far each level-kernel run is from the plain
version (``chip_smoke.level_agrees``).  The inputs come from the
``chip_smoke.py`` beside this script and the kernels from whichever package
is imported, so another checkout's kernels (say, the parent commit unpacked
under ``out/parent``) are timed on the same inputs by running this script
without its own directory on the path; the inputs are built through that
package's ``robust.prepare_level`` and ``robust.kernel_settings``, so it
must have them:

    PYTHONPATH=out/parent python3 -P profile_port.py --kernels

``--wall`` runs no profiler: for each configuration it times the batched
runs (``WALL_REPS`` calls each, after a warm-up) and ``WALL_SESSIONS``
sessions host to host with ``chip_smoke.run_batched`` and
``chip_smoke.run_session``, on the imported package too, so that parent and
change can be alternated in one call.

``--bits`` finds where the level kernel and its plain version part on the
smoke's cases that are not bit-equal (``chip_smoke.LAST_BIT_CASES``, the
single-centre, block and tile ones): for
each iteration cap the columns and elements of the result rows that differ
bit for bit, and at the first cap where they part (and the cap before it)
the same against the plain version on the card with every sum over the
pixels added exactly (``math.fsum``) and rounded once to float32; and,
at that first cap, against the plain version that runs the iterations
before it as ever and adds only that iteration's sums exactly (both sides
are equal up to there, so the side that rounds as the exact sums do is not
at fault), with the distance between kernel and plain in float32 steps,
and the plain version on the CPU against the plain version on the card.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dense_visual_odometry_torch.models.session import OdometrySession
from dense_visual_odometry_torch.ops.cuda import build


def _load_smoke():
    """The ``chip_smoke.py`` beside this script, on the imported package."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().with_name("chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = module
    spec.loader.exec_module(module)
    return module


cs = _load_smoke()

# Device-side names of the port's kernels (ops/cuda/csrc/).
OWN_KERNELS = ("level_kernel", "fused_kernel", "stack_kernel")


def breakdown(name: str, fn, top: int = 8) -> dict:
    first = fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        second = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernel-level events only: an operator's device time is that of the
    # kernels it launched, which are events of their own.
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    device_ms = float(sum(r[1] for r in rows))
    return {
        "run": name,
        "wall_ms": wall_ms,
        "device_kernel_ms": device_ms,
        "device_kernels": sum(n for _, _, n in rows),
        "device_busy_share": device_ms / wall_ms,
        "repeats": cs.bit_equal(first, second),
        "top": [{"name": k[:90], "ms": ms, "count": n} for k, ms, n in rows[:top]],
        "own_kernels": {
            own: {"ms": sum(ms for k, ms, _ in rows if own in k),
                  "count": sum(n for k, _, n in rows if own in k)}
            for own in OWN_KERNELS
        },
        "counts": {k: n for k, _, n in sorted(rows)},
    }


def fused_timing(prev, curr, gt, cam, dev, illum):
    """-> (the fused kernel of the imported package on the inputs of
    ``chip_smoke.fused_case``, what it takes)."""
    args, kwargs = cs.fused_case(prev, curr, gt, cam, dev, illum)
    return lambda: cs.fused_iter.fused_evaluation(*args, **kwargs), "level inputs"


def kernel_times(frames, poses, cam, dev) -> None:
    """``--kernels``: the level, fused and stack kernels' times, one line each
    (the level kernel also with the depth term and the prior,
    ``chip_smoke.TERM_CASES``)."""
    for batch in cs.KERNEL_BATCHES:
        prev, curr, gt, pairs = cs.kernel_batch(frames, poses, dev, batch)
        anchors = cs.previous_motions(poses, pairs, dev)
        for level in (0, cs.LEVELS - 1):
            cases = [(None, illum, rel) for illum in (None, "bias", "affine")
                     for rel in (0.01, None)]
            for term, illum, rel in cases + list(cs.TERM_CASES):
                args, kwargs = cs.level_case(prev, curr, gt, cam, dev, level, illum, rel,
                                             term=term, anchors=anchors)
                out_k = cs.lm_level(*args, **kwargs)
                ok, errs, differing = cs.level_agrees(out_k, cs.lm_level_plain(*args, **kwargs))
                ms = cs.time_ms(lambda: cs.lm_level(*args, **kwargs), 10, dev)
                print(json.dumps({
                    "kernel": "level_solver", "batch": batch, "level": level,
                    "illumination": illum, "rel": rel, "term": term,
                    "iterations": int(out_k[:, 36].max()), "ms": ms,
                    "agrees_with_plain": ok, "elements_differing": differing,
                    **{f"{k}_max_abs": errs[k]["max_abs"] for k in ("est", "count", "iterations")},
                }), flush=True)
            if level == 0:
                for illum in (None, "bias"):
                    fn, inputs = fused_timing(prev, curr, gt, cam, dev, illum)
                    print(json.dumps({
                        "kernel": "fused_iter", "batch": batch, "level": 0,
                        "illumination": illum, "inputs": inputs,
                        "ms": cs.time_ms(fn, 20, dev),
                    }), flush=True)
            args, _, library = cs.stack_case(prev, curr, gt, cam, dev, level)
            print(json.dumps({
                "kernel": "stackwarp", "batch": batch, "level": level,
                "ms": cs.time_ms(lambda: cs.stack_accumulate(*args), 20, dev),
                "library_ms": cs.time_ms(library, 20, dev),
            }), flush=True)


def exact_total(x: torch.Tensor) -> torch.Tensor:
    """``level_solver.level_sum`` with each element's pixels added exactly
    (``math.fsum``) and rounded once: -> (B,) float32."""
    rows = x.detach().double().cpu().reshape(x.shape[0], -1)
    return torch.tensor([math.fsum(r.tolist()) for r in rows], dtype=torch.float64,
                        device=x.device).float()


@contextlib.contextmanager
def exact_sums():
    """The plain level solver with every sum over the pixels exact."""
    ls = cs.level_solver
    saved = ls._reduce.__defaults__, ls._add_depth.__defaults__
    ls._reduce.__defaults__ = ls._add_depth.__defaults__ = (exact_total,)
    try:
        yield
    finally:
        ls._reduce.__defaults__, ls._add_depth.__defaults__ = saved


@contextlib.contextmanager
def exact_sums_from(evaluation: int):
    """The plain level solver with its sums over the pixels exact from its
    ``evaluation``-th evaluation on (one a loop iteration, counted from 1),
    and in float64 as ever before it."""
    ls = cs.level_solver
    plain_evaluation, calls = ls.level_evaluation, [0]

    def level_evaluation(*args, **kwargs):
        calls[0] += 1
        if calls[0] < evaluation:
            return plain_evaluation(*args, **kwargs)
        with exact_sums():
            return plain_evaluation(*args, **kwargs)

    ls.level_evaluation = level_evaluation
    try:
        yield
    finally:
        ls.level_evaluation = plain_evaluation


def ulps(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Column -> the largest distance between ``a`` and ``b`` in float32
    steps over the elements (same-sign values)."""
    d = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
    return {int(c): int(d[:, c].max()) for c in (d.amax(0) > 0).nonzero()[:, 0].tolist()}


def bit_partings(frames, poses, cam, dev) -> None:
    """``--bits``: one JSON line per case and iteration cap."""

    def parted(a, b):
        neq = a.view(torch.int32) != b.view(torch.int32)
        return {"columns": sorted(set(neq.nonzero()[:, 1].tolist())),
                "elements": sorted(set(neq.nonzero()[:, 0].tolist()))}

    for case in sorted(cs.LAST_BIT_CASES, key=str):
        # tpu_fast's cases are (level, batch, illumination, term); the
        # block and tile cases name their configuration first.
        cfg_name, level, batch, illum, term = case if len(case) == 5 else ("tpu_fast", *case)
        prev, curr, gt, pairs = cs.kernel_batch(frames, poses, dev, batch)
        if cfg_name == "tpu_fast":
            rel = next(r for t, i, r in cs.TERM_CASES if (t, i) == (term, illum))
        else:
            rel = cs.config(cfg_name).relative_tolerance
        args, kwargs = cs.level_case(prev, curr, gt, cam, dev, level, illum, rel, cfg_name,
                                     term=term, anchors=cs.previous_motions(poses, pairs, dev))
        cpu_args = [a.cpu() for a in args]
        cpu_kw = {n: v.cpu() if isinstance(v, torch.Tensor) else v for n, v in kwargs.items()}

        def exact(cap):
            # On the card, where the plain version's per-pixel float32 terms
            # are the kernel's (on the CPU some elements part already).
            with exact_sums():
                return cs.lm_level_plain(*args, **dict(kwargs, max_iterations=cap)).cpu()

        parted_yet, p_before = False, None
        for cap in range(1, kwargs["max_iterations"] + 1):
            capped = dict(kwargs, max_iterations=cap)
            k = cs.lm_level(*args, **capped).cpu()
            p = cs.lm_level_plain(*args, **capped).cpu()
            row = {"config": cfg_name, "level": level, "batch": batch, "illumination": illum,
                   "term": term, "cap": cap, "kernel_vs_plain": parted(k, p)}
            if not parted_yet and row["kernel_vs_plain"]["columns"]:
                parted_yet = True
                e = exact(cap)
                row["kernel_vs_exact"] = parted(k, e)
                row["plain_vs_exact"] = parted(p, e)
                # The same state after cap - 1 iterations (kernel and plain
                # are equal there), then this iteration's sums exact: the
                # side that rounds them as the exact sums do is not at fault.
                with exact_sums_from(cap):
                    e1 = cs.lm_level_plain(*args, **dict(kwargs, max_iterations=cap)).cpu()
                row["plain_cpu_vs_plain"] = parted(
                    cs.lm_level_plain(*cpu_args, **dict(cpu_kw, max_iterations=cap)), p)
                row["kernel_vs_one_step_exact"] = parted(k, e1)
                row["plain_vs_one_step_exact"] = parted(p, e1)
                row["ulps_kernel_vs_plain"] = ulps(k, p)
                if p_before is not None:
                    row["cap_before_plain_vs_exact"] = parted(p_before, exact(cap - 1))
            p_before = p
            print(json.dumps(row), flush=True)


WALL_REPS = 10  # timed calls of each batched run under --wall
WALL_SESSIONS = 3  # sessions of 16 frames under --wall


def wall_times(configs, frames, grays, depths, poses, cam, dev) -> None:
    """``--wall``: unprofiled host-to-host times of the main path's runs,
    with ``chip_smoke``'s own timers, one JSON line each."""
    k_dev = cam.intrinsics.to(dev)
    pairs = [(i, i + 1) for i in range(cs.N_FRAMES - 1)]
    for config in configs:
        cfg = cs.config(config)
        anchored = config in cs.PRIOR_CONFIGS
        runs = [("batched_b64_all_pairs", pairs)]
        if cs.kernel_levels(cfg):
            runs.append(("batched_b64_kernel_path",
                         cs.kernel_path_pairs(frames, poses, k_dev, cfg, pairs, anchored)))
        for name, sel in runs:
            row, _ = cs.run_batched(frames, poses, k_dev, cfg, sel, reps=WALL_REPS,
                                    anchored=anchored)
            print(json.dumps({"config": config, "run": name, "pairs": sel,
                              "frames_per_s": row["frames_per_s"],
                              "batch_ms": row["batch_ms"]}), flush=True)
        if config in cs.SESSIONS:
            rows = [cs.run_session(grays, depths, cam, cfg, poses, dev)
                    for _ in range(WALL_SESSIONS)]
            print(json.dumps({"config": config, "run": "session_b1_16_frames",
                              "median_frame_ms": [r["median_frame_ms"] for r in rows],
                              "frame_ms": [r["frame_ms"] for r in rows]}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    build.build(("level_solver", "fused_iter", "stackwarp"))
    grays, depths, k_np, poses = cs.make_sequence()
    cam = cs.CameraModel.create(k_np, 1.0)
    frames = [
        cs.robust.preprocess_frame(g, d, cam, levels=cs.LEVELS, device=dev)
        for g, d in zip(grays, depths)
    ]
    package = Path(build.__file__).resolve().parents[3]
    print(json.dumps({"card": smi, "torch": torch.__version__, "package": str(package)}),
          flush=True)
    if sys.argv[1:] == ["--kernels"]:
        kernel_times(frames, poses, cam, dev)
        return 0
    if sys.argv[1:] == ["--bits"]:
        bit_partings(frames, poses, cam, dev)
        return 0
    if sys.argv[1:2] == ["--wall"]:
        wall_times(sys.argv[2:] or ["tpu_fast"], frames, grays, depths, poses, cam, dev)
        return 0
    k_dev = cam.intrinsics.to(dev)
    pairs = [(i, i + 1) for i in range(cs.N_FRAMES - 1)]
    for config in sys.argv[1:] or ["tpu_fast"]:
        cfg = cs.config(config)
        anchored = config in cs.PRIOR_CONFIGS
        easy = (cs.kernel_path_pairs(frames, poses, k_dev, cfg, pairs, anchored)
                if cs.kernel_levels(cfg) else [])

        def session():
            s = OdometrySession(cam, cfg, device=dev)
            return torch.stack([s.step(g, d).matrix.cpu() for g, d in zip(grays, depths)])

        def batched(sel):
            rows = (sel * (-(-cs.MAIN_BATCH // len(sel))))[: cs.MAIN_BATCH]
            prev, curr, last = cs.batch_inputs(frames, poses, rows, dev, anchored)
            return lambda: cs.batched_track_pair(prev, curr, k_dev, cfg,
                                                 last_transform=last).transform.cpu()

        runs = [("batched_b64_all_pairs", batched(pairs))]
        if easy:
            runs.append(("batched_b64_kernel_path", batched(easy)))
        if config in cs.SESSIONS:
            runs.insert(0, ("session_b1_16_frames", session))
        for name, fn in runs:
            out = {"config": config, **breakdown(name, fn)}
            out["frames"] = len(grays) if name.startswith("session") else cs.MAIN_BATCH
            if name.endswith("kernel_path"):
                out["pairs"] = easy
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
