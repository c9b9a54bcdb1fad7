"""The yardstick of the kernels' roofline shares.

A frozen copy of ``chip_smoke.py``'s work arithmetic: the published peaks
of one H100 SXM (NVIDIA's data sheet, dense, at the full 700 W), the FP32
operations a pixel costs in the level kernel (``OPS_WARP``, ``OPS_VALID``;
the depth term's ``OPS_DEPTH``, the stack kernel's ``OPS_STACK``), and
``bound``.  ``level_solve_work`` counts one level-kernel solve's work from
its shapes, its iterations and each element's valid pixels, whatever
implements it: each input read once, each output written once;
``level_step_bound_ms`` does so for a tracking step's levels from the
cell's shapes and the step's ``TrackResult.diagnostics``.
"""

from __future__ import annotations

import subprocess
from typing import Sequence, Tuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

# FP32 operations per pixel per evaluation: the warp of a template point on
# every pixel; the taps, residual, t-scale fixed point and weighted normal
# equations on a valid pixel.  The depth term adds OPS_DEPTH a valid pixel;
# the stack kernel costs OPS_STACK an output pixel.
OPS_WARP = 40
OPS_VALID = 120
OPS_DEPTH = 136
OPS_STACK = 56

# The level kernel's inputs per grid point: the template's points (3
# planes), its intensities (1) and its Jacobian (6); its scalar row (40
# floats) and result row (48 floats) per element.
PLANES = 10
IN_COLS = 40
OUT_COLS = 48


def bound(nbytes: float, ops: float) -> dict:
    """The least time the chip could take: bytes over the memory's peak or
    operations over the FP32 peak, whichever is longer."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def level_solve_work(grid: Tuple[int, int, int], stride: int, counts: Sequence[float],
                     iterations: Sequence[float]) -> Tuple[float, float]:
    """(bytes, operations) of one level solved for a batch: ``grid`` (B,
    H', W') the template's strided grid; ``counts`` and ``iterations`` per
    element.  The current image is read once where a valid point reaches
    it: ``stride``^2 pixels a valid point."""
    b, hp, wp = grid
    npx = hp * wp
    nbytes = b * 4 * (PLANES * npx + IN_COLS + OUT_COLS) + 4 * stride * stride * sum(counts)
    ops = sum(it * (npx * OPS_WARP + c * OPS_VALID) for c, it in zip(counts, iterations))
    return float(nbytes), float(ops)


def level_step_bound_ms(size: Tuple[int, int], strides: Sequence[int], levels: Sequence[int],
                        counts: Sequence[Sequence[float]], iterations: Sequence[float]) -> float:
    """The bound, in ms, of one tracking step's level-kernel solves.

    ``size`` (H, W) of the finest level, halved (rounding up) a level;
    ``strides`` the tier's grid stride of each level; ``levels`` those that
    the tier gives the level kernel; ``counts[l]`` each element's valid
    pixels and ``iterations[l]`` the level's iterations, the batch's most,
    counted for every element (an element that stopped early is counted
    to the end: the bound reads long, never short, of the work)."""
    total = 0.0
    h, w = size
    for lv in range(max(levels) + 1):
        if lv in levels:
            s = strides[lv]
            grid = (len(counts[lv]), -(-h // s), -(-w // s))
            its = [float(iterations[lv])] * len(counts[lv])
            total += bound(*level_solve_work(grid, s, counts[lv], its))["bound_ms"]
        h, w = -(-h // 2), -(-w // 2)
    return total


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"
    return out or "nvidia-smi printed nothing"
