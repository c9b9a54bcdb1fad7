"""Whether a KinectFusion cell's timed path mapped and tracked correctly.

In the window, a few runs of consecutive steps drawn from the seed copy the
volume on the device before they run and keep the step's render (level 0,
what the step tracked against).  Once the window has closed and the memory
peak is read, each sampled step is judged against the plain float64
reference (``reference/kinfu.py``, ``reference/dvo.py``), in z-slabs:

- ``fuse_diff_pct``: the reference fuses the step's raw frame into the
  copy taken before the step, at the pose the step returned (nothing where
  the step was refused); the share of the volume's voxels whose tsdf or gray
  then differs from the program's by more than ``TSDF_GAP`` / ``GRAY_GAP``,
  or whose weight differs at all, in %, the largest of the sample.  Not the
  widest gap: float32 and float64 round a few voxels' projections to
  different pixels, whose values then differ by a whole pixel's depth.
- ``render_gap_mm_p50`` / ``_p95``: the reference's march of the copy from
  the step's previous pose against the program's render, on the pixels both
  hit (mm), the largest of the sample; ``render_gray_gap_p50`` / ``_p95``:
  the same for the render's gray (gray levels), which the step tracks
  against as its photometric template; ``render_only_pct``: the share of
  the pixels either hit that only one hit, the largest of the sample.
- ``motion_gap_mm`` / ``_deg`` (widest) and ``_mm_p50`` / ``_deg_p50``
  (median): the step's motion against the reference's optimum of the finest
  level's robust photometric energy with the program's render as the
  template, started from the true motion (accepted steps).
- ``compose_gap_mm`` / ``_deg`` and ``lost_pct``: as ``check.py`` computes
  them, over every step and the window's steps.
- ``drift_mm`` / ``drift_deg``: the widest gap of the window's returned
  poses from the truth, both taken relative to the tracker's first frame.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.harness import check, runner
from portbench.harness.drive import MOTION, POSE, SUCCESS, Frames
from portbench.reference import dvo, kinfu

TSDF_GAP = 1e-4  # truncation units: a float32 update parts from float64 by ~1e-5 at most
GRAY_GAP = 1e-3  # gray levels: float32 luma and averages part from float64 by ~3e-5
SLAB = 16  # voxel planes the reference fuses at once


@dataclass
class Options(runner.Options):
    """What a test may change in a KinectFusion run."""

    resolution: Optional[int] = None  # voxels a side instead of the configuration's
    samples: Optional[int] = None  # sampled steps instead of the traffic's


@dataclass
class Sample:
    """What a sampled step leaves for its judgement."""

    step: int  # index into the outputs
    frame: int  # pool frame the step tracked
    before: Tuple[torch.Tensor, ...]  # (tsdf, weight, gray) before the step
    after: Optional[Tuple[torch.Tensor, ...]] = None  # and after it
    render: Optional[Tuple[torch.Tensor, torch.Tensor]] = None  # (depth, gray) level 0


@dataclass
class Evidence:
    frames: Frames
    tier: check.Tier
    geo: kinfu.Geometry
    step: float  # the march's step, meters
    frame_of: List[int]  # pool frame of every step
    outputs: List[np.ndarray]  # every step's (1, ROW) row
    first: int  # the window's first step
    samples: List[Sample] = field(default_factory=list)


def sample_steps(first: int, expected: int, n: int, run: int, seed: int) -> List[int]:
    """``n`` steps of the window in runs of ``run`` consecutive ones, the
    runs' starts drawn from the seed over the ``expected`` steps."""
    runs = max(1, -(-n // run))
    slots = max(runs, (expected - 1) // run)
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.choice(slots, size=min(runs, slots), replace=False))
    steps = [first + 1 + int(s) * run + j for s in starts for j in range(run)]
    return steps[:n]


def raw_frame(frames: Frames, tier: check.Tier, f: int, rnd=None):
    """The reference's (depth_m, gray) of pool frame ``f``."""
    z = dvo.metres(frames.depth[f], frames.depth_factor, tier.max_distance, rnd)
    return z, dvo.luma(frames.rgb[f], rnd)


def truth(ev: Evidence, step: int) -> np.ndarray:
    """The true pose of a step, relative to the tracker's first frame."""
    p = ev.frames.poses
    return np.linalg.inv(p[ev.frame_of[0]]) @ p[ev.frame_of[step]]


def pose_of(ev: Evidence, step: int) -> np.ndarray:
    return ev.outputs[step][0, POSE].reshape(4, 4).astype(np.float64)


def fuse_diff_pct(ev: Evidence, s: Sample, rnd=None) -> float:
    """Share (%) of voxels where the program's fusion of sample ``s``
    parts from the reference's (``rnd``: the control's against float64)."""
    row = ev.outputs[s.step][0]
    fused = row[SUCCESS] > 0.5
    depth_m, gray = raw_frame(ev.frames, ev.tier, s.frame)
    pose = pose_of(ev, s.step)
    if rnd is not None:
        depth_c, gray_c = raw_frame(ev.frames, ev.tier, s.frame, rnd)
    bad = 0
    d = ev.geo.dims[0]
    for z0 in range(0, d, SLAB):
        z1 = min(d, z0 + SLAB)
        if not fused:
            ref = tuple(f[z0:z1].double() for f in s.before)
        else:
            ref = kinfu.fuse(s.before, depth_m, gray, ev.frames.intrinsics, pose, ev.geo, z0, z1)
        if rnd is None:
            got = tuple(f[z0:z1] for f in s.after)
        else:
            got = kinfu.fuse(s.before, depth_c, gray_c, ev.frames.intrinsics, pose, ev.geo,
                             z0, z1, rnd)
        off = (((got[0].double() - ref[0]).abs() > TSDF_GAP)
               | (got[1].double() != ref[1])
               | ((got[2].double() - ref[2]).abs() > GRAY_GAP))
        bad += int(off.sum())
    return 100.0 * bad / float(np.prod(ev.geo.dims))


def reference_render(ev: Evidence, s: Sample, rnd=None):
    pose = pose_of(ev, s.step - 1)
    shape = tuple(ev.frames.depth.shape[1:3])
    n = kinfu.march_steps(ev.geo, pose, ev.step)
    return kinfu.march(s.before, ev.frames.intrinsics, pose, ev.geo, shape, ev.step, n, rnd)


def render_numbers(render, render_ref) -> Dict[str, float]:
    """The render numbers of one (depth, gray) render against the
    reference's."""
    (depth, gray), (depth_ref, gray_ref) = render, render_ref
    gaps, only = kinfu.render_gaps(depth, depth_ref)
    out = {"render_only_pct": only}
    if gaps is not None:
        both = (depth > 0) & (depth_ref > 0)
        gray_gaps = (gray.double() - gray_ref.double()).abs()[both]
        for name, v in (("render_gap_mm", gaps), ("render_gray_gap", gray_gaps)):
            out[f"{name}_p50"] = float(v.median())
            out[f"{name}_p95"] = float(torch.quantile(v, 0.95))
    return out


def reference_motions(ev: Evidence, samples: Sequence[Sample], renders=None,
                      rnd=None) -> torch.Tensor:
    """The reference's optimum for each accepted sample, from the true
    motion, with the program's render (or ``renders``) as the template."""
    dev = ev.frames.rgb.device
    k = torch.tensor(ev.frames.intrinsics, dtype=torch.float64, device=dev)
    renders = renders or [s.render for s in samples]
    start = np.stack([np.linalg.inv(truth(ev, s.step)) @ pose_of(ev, s.step - 1)
                      for s in samples])
    frames = torch.as_tensor([s.frame for s in samples], device=dev)
    return dvo.refine(torch.stack([g for _, g in renders]).double(),
                      torch.stack([d for d, _ in renders]).double(),
                      dvo.luma(ev.frames.rgb[frames], rnd), k, torch.as_tensor(start, device=dev),
                      ev.tier.strides[0], ev.tier.bias,
                      template_jacobian=ev.tier.template_jacobian, rnd=rnd).double()


def drift(ev: Evidence) -> Dict[str, float]:
    steps = range(ev.first, len(ev.outputs))
    est = torch.as_tensor(np.stack([pose_of(ev, i) for i in steps]))
    true = torch.as_tensor(np.stack([truth(ev, i) for i in steps]))
    tr, rot = dvo.motion_gap(true, est)
    return {"drift_mm": float(tr.max()), "drift_deg": float(rot.max())}


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in rows:
        for name, v in r.items():
            out[name] = max(out.get(name, v), v)
    return out


def judge(ev: Evidence) -> Dict[str, float]:
    """The numbers that ``correct`` compares."""
    samples = [s for s in ev.samples if s.after is not None]
    numbers: Dict[str, float] = {"pairs": float(len(samples))}
    if samples:
        numbers["fuse_diff_pct"] = max(fuse_diff_pct(ev, s) for s in samples)
        numbers.update(worst([render_numbers(s.render, reference_render(ev, s))
                              for s in samples]))
        accepted = [s for s in samples if ev.outputs[s.step][0, SUCCESS] > 0.5]
        if accepted:
            ref = reference_motions(ev, accepted)
            prog = np.stack([ev.outputs[s.step][0, MOTION].reshape(4, 4) for s in accepted])
            numbers.update(check.motion_gaps(prog.astype(np.float64), ref))
    numbers.update(check.compose_gaps(ev.outputs))
    numbers.update(drift(ev))
    window = np.stack([o[:, SUCCESS] for o in ev.outputs[ev.first:]])
    numbers["lost_pct"] = float(100.0 * (window < 0.5).mean())
    return numbers
