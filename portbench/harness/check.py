"""Whether what the timed path produced is correct.

The answers are the poses each step returned.  Once the window has
closed, the program's state freed and the memory peak read, a sample of the
tracked frames drawn from the seed is judged against the plain reference
(``reference/dvo.py``), which works from the raw frames alone:

- ``motion_gap_mm`` / ``motion_gap_deg``: for each sampled frame, the
  motion that the returned poses imply (previous pose to this one, so the
  session's pose composition is judged with it) against the reference's
  optimum of the finest level's robust photometric energy, started from
  the true motion; the widest gap of the sample.
- ``compose_gap_mm`` / ``compose_gap_deg``: for every stream at every
  step, the returned pose against the reference's composition of the
  previous returned pose with the inverse of the motion the step returned
  (the previous pose itself where the step was refused, the identity before
  a stream's first frame); the widest gap.  It follows the program step by
  step from the program's own poses and motions; ``motion_gap_*`` judge
  the motions.
- ``gray_gap`` / ``depth_gap``: the pyramids that the program's
  preprocessing left in its state for a sample of streams (the last frame
  each stream committed) against the reference's, widest gap.
- ``lost_pct``: the share of the window's frames that the tracker did not
  accept (their pose stays put, as the session's contract says).

A frame whose step was not accepted is left out of the motion sample; the
next accepted one is judged against the last committed frame.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench.harness.drive import MOTION, POSE, SUCCESS, Frames, Schedule
from portbench.reference import dvo

BLOCK = 32  # pairs the reference solves at once


@dataclass
class Tier:
    """What the reference needs of the tracker's tier file."""

    levels: int
    strides: Tuple[int, ...]
    max_distance: float
    bias: bool
    template_jacobian: bool

    @classmethod
    def from_json(cls, tier: dict) -> "Tier":
        levels = int(tier.get("levels", 4))
        strides = tuple(tier.get("grid_strides") or [tier.get("finest_stride", 1)] + [1] * (levels - 1))
        return cls(levels=levels, strides=strides,
                   max_distance=float(tier.get("max_distance", 5.0)),
                   bias=tier.get("illumination") == "bias",
                   template_jacobian=bool(tier.get("approximate_image2_gradient", False)))


def committed_before(outputs: Sequence[np.ndarray], schedule: Schedule) -> np.ndarray:
    """(steps, B): the frame each stream had committed before each step
    (-1 before its first); ``outputs[k]`` is step k's."""
    b = outputs[0].shape[0]
    cur = np.full(b, -1)
    out = np.empty((len(outputs), b), np.int64)
    for i, row in enumerate(outputs):
        out[i] = cur
        ok = row[:, SUCCESS] > 0.5
        cur = np.where(ok, schedule.frames(i), cur)
    return out


def sample_pairs(outputs, schedule: Schedule, first: int, n: int,
                 seed: int) -> List[Tuple[int, int]]:
    """(step index into ``outputs``, stream) of up to ``n`` accepted frames
    at or after ``first`` whose stream had committed a frame before."""
    before = committed_before(outputs, schedule)
    ok = np.stack([o[:, SUCCESS] > 0.5 for o in outputs])
    cand = np.argwhere(ok & (before >= 0))
    cand = cand[cand[:, 0] >= max(first, 1)]
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(cand), size=min(n, len(cand)), replace=False)
    return [tuple(int(x) for x in cand[i]) for i in sorted(pick)]


def program_motions(outputs, pairs) -> np.ndarray:
    """The motion (previous camera -> current camera) each pair's poses imply."""
    mats = []
    for i, s in pairs:
        prev = outputs[i - 1][s, POSE].reshape(4, 4).astype(np.float64)
        cur = outputs[i][s, POSE].reshape(4, 4).astype(np.float64)
        mats.append(np.linalg.inv(cur) @ prev)
    return np.stack(mats)


def reference_motions(frames: Frames, tier: Tier, prev_idx, curr_idx,
                      rnd: dvo.Round = None) -> torch.Tensor:
    """The reference's optimum at the finest level, started from the true
    motion, for frame pairs; ``rnd`` rounds each product's inputs (the
    control)."""
    dev = frames.rgb.device
    k = torch.tensor(frames.intrinsics, dtype=torch.float64, device=dev)
    stride = tier.strides[0]
    out = []
    for lo in range(0, len(prev_idx), BLOCK):
        pi = torch.as_tensor(prev_idx[lo:lo + BLOCK], device=dev)
        ci = torch.as_tensor(curr_idx[lo:lo + BLOCK], device=dev)
        truth = torch.as_tensor(np.stack([
            np.linalg.inv(frames.poses[c]) @ frames.poses[p]
            for p, c in zip(prev_idx[lo:lo + BLOCK], curr_idx[lo:lo + BLOCK])]), device=dev)
        g = dvo.luma(frames.rgb[torch.cat([pi, ci])], rnd)
        z = dvo.metres(frames.depth[pi], frames.depth_factor, tier.max_distance, rnd)
        n = len(pi)
        out.append(dvo.refine(g[:n], z, g[n:], k, truth, stride, tier.bias,
                              template_jacobian=tier.template_jacobian, rnd=rnd).double())
    return torch.cat(out)


def motion_gaps(program, reference: torch.Tensor) -> Dict[str, float]:
    """The widest and the median gap of ``program``'s motions (B, 4, 4)
    from ``reference``'s."""
    tr, rot = dvo.motion_gap(reference, torch.as_tensor(program, device=reference.device))
    return {"motion_gap_mm": float(tr.max()), "motion_gap_deg": float(rot.max()),
            "motion_gap_mm_p50": float(tr.median()), "motion_gap_deg_p50": float(rot.median())}


def compose_gaps(outputs) -> Dict[str, float]:
    """Widest gap of every returned pose from the previous returned pose
    composed with the inverse of the step's returned motion (kept where the
    step was refused; the identity before the first step)."""
    rows = torch.as_tensor(np.stack(outputs), dtype=torch.float64)  # (steps, B, ROW)
    n, b = rows.shape[:2]
    pose = rows[..., POSE].reshape(n, b, 4, 4)
    motion = rows[..., MOTION].reshape(n, b, 4, 4)
    ok = rows[..., SUCCESS] > 0.5
    prev = torch.cat([torch.eye(4, dtype=torch.float64).expand(1, b, 4, 4), pose[:-1]])
    want = torch.where(ok[..., None, None], dvo.compose(prev, motion), prev)
    tr, rot = dvo.motion_gap(want.reshape(-1, 4, 4), pose.reshape(-1, 4, 4))
    return {"compose_gap_mm": float(tr.max()), "compose_gap_deg": float(rot.max())}


def pyramid_gaps(frames: Frames, tier: Tier, frame_idx: Sequence[int],
                 gray: Sequence[torch.Tensor], depth: Sequence[torch.Tensor]) -> Tuple[float, float]:
    """Widest gap of the program's (gray, depth) pyramids of ``frame_idx``."""
    idx = torch.as_tensor(list(frame_idx), device=frames.rgb.device)
    g_ref = dvo.pyramid(dvo.luma(frames.rgb[idx]), tier.levels)
    z_ref = dvo.pyramid(dvo.metres(frames.depth[idx], frames.depth_factor, tier.max_distance),
                        tier.levels)
    gg = max(float((a.double() - b).abs().max()) for a, b in zip(gray, g_ref))
    dg = max(float((a.double() - b).abs().max()) for a, b in zip(depth, z_ref))
    return gg, dg


def pair_frames(outputs, schedule: Schedule, pairs) -> Tuple[list, list]:
    """The (previous committed, current) pool frames of each pair."""
    before = committed_before(outputs, schedule)
    return ([int(before[i, s]) for i, s in pairs], [int(schedule.frames(i)[s]) for i, s in pairs])


def judge(frames: Frames, tier: Tier, schedule: Schedule, outputs, first: int, n_pairs: int,
          seed: int, state_streams: Sequence[int], state_gray, state_depth) -> Dict[str, float]:
    """The numbers that ``correct`` compares; ``outputs[k]`` is step k's,
    ``outputs[first:]`` the window's and after."""
    pairs = sample_pairs(outputs, schedule, first, n_pairs, seed)
    prev_idx, curr_idx = pair_frames(outputs, schedule, pairs)
    numbers = {"pairs": float(len(pairs))}
    if pairs:
        ref = reference_motions(frames, tier, prev_idx, curr_idx)
        numbers.update(motion_gaps(program_motions(outputs, pairs), ref))
    numbers.update(compose_gaps(outputs))
    # A stream that never committed a frame holds no pyramid to judge.
    last = committed_before(outputs + [outputs[-1]], schedule)[-1]
    held = [(j, int(last[s])) for j, s in enumerate(state_streams) if last[s] >= 0]
    if held:
        rows = torch.as_tensor([j for j, _ in held])
        numbers["gray_gap"], numbers["depth_gap"] = pyramid_gaps(
            frames, tier, [f for _, f in held], [g[rows.to(g.device)] for g in state_gray],
            [d[rows.to(d.device)] for d in state_depth])
    window = np.stack([o[:, SUCCESS] for o in outputs[first:]])
    numbers["lost_pct"] = float(100.0 * (window < 0.5).mean())
    return numbers


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """Each number against its limit; a missing number fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        passed = value is not None and np.isfinite(value) and value <= limit
        ok = ok and passed
        checks[name] = {"value": value, "limit": limit}
    if numbers.get("pairs", 0) < 1:
        ok = False
    return ok, checks
