"""Robust dense visual odometry: coarse-to-fine photometric LM / Gauss-Newton.

Counterpart of ``dense_visual_odometry_tpu/models/robust.py``: every
evaluation mode, both loops, the hard-motion fallback, the retrack and the
init selection with its scale ladder.  Per level (:func:`level_plan` fixes
the branches from the configuration and the level, :func:`kernel_settings`
the kernels' arguments), the solver:

- builds the level's estimate-independent inputs once, as one value
  (:func:`prepare_level`, a :class:`PreparedLevel`): at a frozen-window level
  (``freeze_shift_window`` on the fused path) the window of the current
  image, extracted once around an integer centre per element (or, on a
  level-kernel level without ESM, one per row block or 2-D tile,
  ``recenter_blocks`` / ``recenter_col_blocks``, with the vertical radius
  ``shift_stack_radius_y``: ``ops/blockwarp.py``), and the
  Jacobian planes, ESM-averaged through one pass of the stack kernel
  (``ops/cuda/stackwarp.py``); elsewhere the template's Jacobian (ESM
  averaged with the current image's gradients sampled nearest at the
  level-start warp) or, with exact gradients, the current image's Sobel
  gradients;
- evaluates the hard-motion trigger at the level's starting estimate
  (shift-ball coverage of the centres the level will use, one, per block
  or per tile; with the template's Jacobian also the rotation
  angle and, at the coarsest level, the RMS displacement).  The predicate
  is batch-global and fixed for the level: if any element is hard, the
  whole batch evaluates on the packed gather path ("packed_exact" with the
  current image's exact gradients, or "packed");
- else evaluates in the level's mode, a function of that value and
  (estimate, anchor, lambda) (:data:`EVALUATIONS`): "fused" (one launch of
  the fused kernel, ``ops/cuda/fused_iter.py``, on the frozen window or on
  one recentred at the evaluated estimate, as at a level of blocks or
  tiles, whose frozen windows only the level kernel reads), "shift" (the
  stack kernel), "packed" (the f16-packed gather) or "plain" (bilinear
  sampling, exact or precomputed Jacobian);
- adds to every evaluation the depth term (``use_depth_residuals``: the
  current depth sampled bilinearly at the warp against the warped point's
  depth, Huber-weighted, ``depth_residuals``) and then the motion prior
  (``sigma``: H += I/sigma, b += log(anchor)/sigma and its energy,
  :func:`_prior_energy`), in the JAX package's order;
- solves the level: in one launch of the level kernel
  (``ops/cuda/level_solver.py``, which adds both terms itself, its depth
  sampled through a frozen window over the current depth) on a
  frozen-window LM level off the fallback, else in the LM loop
  (:func:`_lm_loop`) or, with ``lm_lambda0`` unset, the Gauss-Newton loop
  with the reference's stopping semantics (:func:`_gn_loop`, which moves
  the prior's anchor with each accepted step);
- at level 0 re-evaluates the Hessian at the solution: photometric, with
  the depth term, without the prior.

After the cascade, elements whose finest-level IRLS scale exceeds
``retrack_max_scale`` are solved again with the hard-motion path forced at
every level.  Data-dependent control flow (the trigger, loop exits, the
retrack) reads device values on the host, as ``lax.cond`` /
``lax.while_loop`` did inside the JAX program.

A batch sharded over ranks (``track_pair(..., group=...)``, one process per
device, ``parallel/batched.py``) tracks each rank's slice, but the JAX
sharded tracker is one global program, so every batch-global decision spans
all ranks.  These are the collectives, each an ``all_reduce`` with ``MAX``
over the group, run by every rank the same number of times in the same
order:

1. the hard-motion trigger of each level that has the fallback
   (:func:`_solve_level`): any hard element on any rank sends every rank's
   batch to the gather path;
2. the retrack's predicate (:func:`track_pair`): if any rank has a "bad"
   element, every rank runs the second cascade (whose triggers are
   collectives too), and picks only its own bad elements;
3. ``LevelDiagnostics.iterations``, the batch maximum, at the end.

The per-level loops need none: each element freezes once done, and a
loop's trip count is reported only through 3.  Without a group nothing
changes: no collective and no extra host read.

With the tracer on (``utils/profiling.py``) the tracker records spans at
its boundaries (``frame.upload``, ``frame.pyramid``, ``track.pair``,
``track.init``, ``track.cascade``, one ``track.level`` a level with its
``path``, ``level.inputs``, ``level.solve``, ``level.hessian``) and around
each host read (``sync.loop``, ``sync.solve``, ``sync.trigger``,
``sync.retrack``), and counts levels by path, the trigger's terms, the
gather path's stream-levels, the retracks and the loops' iterations.  The
per-stream counts come back in the read that the trigger or the retrack
makes anyway (a small integer tensor in place of the flag), so tracing adds
no host read and no collective, and every decision is the same.

Every grid stride runs, at every level: the kernels have a variant for
strides 1 and 2 each and one for every stride >= 3.  ESM gradients on the
fused path without
``freeze_shift_window`` never get here: the configuration refuses them, as
the JAX package's does.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dense_visual_odometry_torch.camera import CameraModel
from dense_visual_odometry_torch.config import RobustDVOConfig
from dense_visual_odometry_torch.models.weighting import (
    huber_weights,
    t_distribution_weights_with_scale,
)
from dense_visual_odometry_torch.ops import gradients as grad_ops
from dense_visual_odometry_torch.ops import interp as interp_ops
from dense_visual_odometry_torch.ops import pyramid as pyr_ops
from dense_visual_odometry_torch.ops.blockwarp import (
    ONE_CENTRE,
    Blocks,
    window_centres,
    window_coverage,
    window_planes,
)
from dense_visual_odometry_torch.ops.cuda import stackwarp
from dense_visual_odometry_torch.ops.cuda.fused_iter import fused_settings, fused_shift_iteration
from dense_visual_odometry_torch.ops.cuda.level_solver import (
    LevelInputs,
    level_inputs,
    solve_level_fused,
    with_window,
)
from dense_visual_odometry_torch.ops.residuals import (
    approximate_jacobian,
    approximate_jacobian_planes,
    depth_residuals,
    normal_equations,
    warp_geometry,
    warp_residuals,
    warp_residuals_packed,
    warp_residuals_shift,
)
from dense_visual_odometry_torch.ops.shiftwarp import (
    _grid_displacements,
    compute_recenter,
    extract_parity_planes,
    residual_displacements,
)
from dense_visual_odometry_torch.utils.lie import se3
from dense_visual_odometry_torch.utils.profiling import count as trace_count
from dense_visual_odometry_torch.utils.profiling import trace_span, tracing

# Raw ksize-3 Sobel has gain 8 per unit pixel step.
_SOBEL_GAIN = 8.0
_FMAX = float(torch.finfo(torch.float32).max)


def _flag_over_ranks(mask: torch.Tensor, group) -> torch.Tensor:
    """``any(mask)`` on the device, over every rank of ``group`` if one is
    given (one ``all_reduce`` with ``MAX``)."""
    flag = torch.any(mask)
    if group is not None:
        flag = flag.to(torch.int32).reshape(1)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return flag


def _any_over_ranks(mask: torch.Tensor, group) -> bool:
    """``any(mask)`` on the host, over every rank of ``group`` if one is
    given."""
    return bool(_flag_over_ranks(mask, group))


def _any_over_ranks_counted(mask: torch.Tensor, group, counts) -> Tuple[bool, list]:
    """:func:`_any_over_ranks`, and the values of ``counts`` (integer
    scalars: the tracer's, this rank's own) read back in the same host
    read."""
    flag = _flag_over_ranks(mask, group).reshape(()).to(torch.int64)
    values = torch.stack([flag] + [c.to(torch.int64) for c in counts]).tolist()
    return bool(values[0]), values[1:]


def _count_trigger(need_fb: bool, b: int, counts: list, first: bool) -> None:
    """The tracer's counters of one level's trigger, from ``counts`` as
    read: the streams whose own result needs the gather path, then those
    each term flagged (coverage, rotation, displacement).  ``first``: the
    level is in the first cascade, not the retrack's (whose every level
    takes the gather path by force)."""
    kept, coverage, rotation, displacement = counts
    if first:
        trace_count("stream_levels.hard.coverage", coverage)
        trace_count("stream_levels.hard.rotation", rotation)
        trace_count("stream_levels.hard.displacement", displacement)
        if need_fb:
            trace_count("levels.gather")
    if need_fb:
        trace_count("stream_levels.gather", b)
        trace_count("stream_levels.gather_kept", kept)


def _prior_energy(cfg: RobustDVOConfig, log_old: torch.Tensor) -> torch.Tensor:
    """The motion prior's share of the error (B,), from log(anchor) (B, 6):
    ``0.5 * |log|^2 / sigma``, or with ``reference_prior_energy`` the
    reference's ``0.5 * sigma * |log|`` (JAX ``robust.py:69``)."""
    sq = torch.sum(log_old * log_old, dim=-1)
    if cfg.reference_prior_energy:
        return 0.5 * cfg.sigma * torch.sqrt(sq)
    return 0.5 * (1.0 / cfg.sigma) * sq


class FrameData(NamedTuple):
    """Per-frame gray and metric-depth pyramids; ``gray[l]`` is level l."""

    gray: Tuple[torch.Tensor, ...]
    depth_m: Tuple[torch.Tensor, ...]


class LevelDiagnostics(NamedTuple):
    iterations: torch.Tensor  # int32 iterations run (batch maximum)
    error: torch.Tensor  # (B,) final mean weighted squared residual
    count: torch.Tensor  # (B,) valid pixels of the accepted evaluation
    scale: torch.Tensor  # (B,) IRLS residual scale sigma


class TrackResult(NamedTuple):
    """``transform`` maps camera_{t-1} points into camera_t."""

    transform: torch.Tensor  # (B, 4, 4)
    success: torch.Tensor  # (B,) bool
    diagnostics: LevelDiagnostics  # stacked coarse-to-fine, length = levels
    hessian: torch.Tensor  # (B, 6, 6) finest-level photometric J^T W J


def resolve_device(device) -> torch.device:
    """``None`` means the GPU; asking for CUDA without one raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested (the default) but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions on the CPU"
        )
    return device


def as_device_tensor(x, device) -> torch.Tensor:
    """A numpy array or tensor on ``device`` (unsigned 16/32-bit depth is
    widened to int64 first, which every torch build handles)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.asarray(x)
    if x.dtype in (np.uint16, np.uint32):
        x = x.astype(np.int64)
    return torch.tensor(x, device=device)


def preprocess_frame(
    color_or_gray,
    depth_raw,
    camera: CameraModel,
    *,
    levels: int,
    max_distance: float = 5.0,
    quantize: bool = False,
    device=None,
) -> FrameData:
    """Color (..., H, W, 3) or gray (..., H, W) + raw depth DN -> pyramids
    on ``device`` (None = the GPU)."""
    device = resolve_device(device)
    with trace_span("frame.upload"):
        color_or_gray = as_device_tensor(color_or_gray, device)
        depth_raw = as_device_tensor(depth_raw, device)
    with trace_span("frame.pyramid"):
        is_rgb = (
            color_or_gray.ndim == depth_raw.ndim + 1 and color_or_gray.shape[-1] == 3
        )
        if is_rgb:
            gray = pyr_ops.rgb_to_gray(color_or_gray, quantize=quantize)
        else:
            gray = color_or_gray.to(torch.float32)
        depth_m = pyr_ops.preprocess_depth(depth_raw, camera.depth_scale, max_distance)
        return FrameData(
            gray=pyr_ops.build_pyramid(gray, levels),
            depth_m=pyr_ops.build_pyramid(depth_m, levels),
        )


def frame_data_from_numpy(frame, device) -> FrameData:
    """A ``FrameData`` of arrays (e.g. the JAX package's, as numpy) ->
    this package's tensors on ``device``."""
    def conv(x):
        return torch.tensor(np.asarray(x, dtype=np.float32), device=device)

    return FrameData(
        gray=tuple(conv(g) for g in frame.gray),
        depth_m=tuple(conv(d) for d in frame.depth_m),
    )


def _bias_schur(sys, residuals, jacobian, weights):
    """Eliminate a global intensity bias from the system (rank-1 Schur)."""
    b = jacobian.shape[0]
    jac = jacobian.reshape(b, -1, 6)
    res = residuals.reshape(b, -1)
    wts = weights.reshape(b, -1)
    g = torch.einsum("bni,bn->bi", jac, wts)
    s = torch.sum(wts, dim=-1)
    rho = torch.sum(wts * res, dim=-1)
    s_safe = torch.clamp(s, min=1e-6)
    hess = sys.hessian - g[:, :, None] * g[:, None, :] / s_safe[:, None, None]
    rhs = sys.rhs + g * (rho / s_safe)[:, None]
    mu = rho / s_safe
    error = sys.error - s * mu * mu / torch.clamp(sys.count, min=1.0)
    return sys._replace(hessian=hess, rhs=rhs, error=error)


def _affine_schur(sys, residuals, jacobian, weights, template_c):
    """Eliminate a gain + bias pair (rank-2 Schur): the model
    ``r ~ J delta + a * I + c`` with ``I`` the valid-mean-centred template
    ``template_c``.  With ``N = [I, 1]``, ``S = N^T W N``, ``G = J^T W N``
    and ``t = N^T W r``: H' = H - G S^-1 G^T, b' = b + G S^-1 t, and the
    error drops by t^T S^-1 t / count."""
    b = jacobian.shape[0]
    jac = jacobian.reshape(b, -1, 6)
    res = residuals.reshape(b, -1)
    wts = weights.reshape(b, -1)
    tpl = template_c.reshape(b, -1)
    s_ii = torch.sum(wts * tpl * tpl, dim=-1)
    s_i1 = torch.sum(wts * tpl, dim=-1)
    s_11 = torch.sum(wts, dim=-1)
    t_i = torch.sum(wts * tpl * res, dim=-1)
    t_1 = torch.sum(wts * res, dim=-1)
    det = torch.clamp(s_ii * s_11 - s_i1 * s_i1, min=1e-6)
    g_i = torch.einsum("bni,bn->bi", jac, wts * tpl)
    g_1 = torch.einsum("bni,bn->bi", jac, wts)
    beta_i = (s_11 * t_i - s_i1 * t_1) / det
    beta_1 = (s_ii * t_1 - s_i1 * t_i) / det
    m_i = (s_11[:, None] * g_i - s_i1[:, None] * g_1) / det[:, None]
    m_1 = (s_ii[:, None] * g_1 - s_i1[:, None] * g_i) / det[:, None]
    hess = sys.hessian - (
        g_i[:, :, None] * m_i[:, None, :] + g_1[:, :, None] * m_1[:, None, :]
    )
    rhs = sys.rhs + g_i * beta_i[:, None] + g_1 * beta_1[:, None]
    error = sys.error - (t_i * beta_i + t_1 * beta_1) / torch.clamp(sys.count, min=1.0)
    return sys._replace(hessian=hess, rhs=rhs, error=error)


def _erode3(mask: torch.Tensor) -> torch.Tensor:
    """3x3 binary erosion over the last two axes (borders erode away)."""
    h, w = mask.shape[-2], mask.shape[-1]
    padded = mask.new_zeros(mask.shape[:-2] + (h + 2, w + 2))
    padded[..., 1 : h + 1, 1 : w + 1] = mask
    out = mask
    for dy in range(3):
        for dx in range(3):
            out = out & padded[..., dy : dy + h, dx : dx + w]
    return out


def _lm_loop(evaluate, estimate0, anchor0, cfg, rel_eff, max_iterations):
    """Levenberg-Marquardt over a batch with per-element stopping.

    One evaluation per iteration at the trial point; a rejected trial rolls
    back and re-solves the carried system with more damping.  The loop runs
    while any element is active; the iteration count is shared.
    """
    b = estimate0.shape[0]
    dev = estimate0.device
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    est_acc, anchor_acc = estimate0, anchor0
    est_try, anchor_try = estimate0, anchor0
    hess_acc = torch.zeros((b, 6, 6), dtype=torch.float32, device=dev)
    rhs_acc = torch.zeros((b, 6), dtype=torch.float32, device=dev)
    err_acc = torch.full((b,), _FMAX, dtype=torch.float32, device=dev)
    count_acc = torch.zeros((b,), dtype=torch.float32, device=dev)
    lm_lambda = torch.full((b,), cfg.lm_lambda0, dtype=torch.float32, device=dev)
    wlam = torch.full(
        (b,), 1.0 / (cfg.weighter.initial_sigma**2), dtype=torch.float32, device=dev
    )
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    it = 0
    while it < max_iterations:
        with trace_span("sync.loop"):
            running = bool(torch.any(~done))
        if not running:
            break
        hess, rhs, err, count, _photo, wlam = evaluate(est_try, anchor_try, wlam)
        ok_eval = torch.isfinite(err) & (count >= 6.0)
        active = ~done
        take = (err < err_acc) & ok_eval & active
        sel2 = take[:, None, None]
        est_acc = torch.where(sel2, est_try, est_acc)
        anchor_acc = torch.where(sel2, anchor_try, anchor_acc)
        hess_acc = torch.where(sel2, hess, hess_acc)
        rhs_acc = torch.where(take[:, None], rhs, rhs_acc)
        err_acc = torch.where(take, err, err_acc)
        count_acc = torch.where(take, count, count_acc)
        lam = torch.where(
            active,
            torch.where(take, lm_lambda * cfg.lm_down, lm_lambda * cfg.lm_up),
            lm_lambda,
        )
        lm_lambda = torch.clamp(lam, 1e-10, cfg.lm_lambda_max)

        floor = 1e-8 * (1.0 + torch.diagonal(hess_acc, dim1=-2, dim2=-1).sum(-1))
        damped = (
            hess_acc
            + lm_lambda[:, None, None] * (hess_acc * eye6)
            + floor[:, None, None] * eye6
        )
        with trace_span("sync.solve"):
            delta = torch.linalg.solve(damped, rhs_acc[..., None])[..., 0]
        ok = torch.all(torch.isfinite(delta), dim=-1) & (count_acc >= 6.0)
        delta = torch.where(ok[:, None], delta, torch.zeros_like(delta))

        pred = torch.sum(delta * rhs_acc, dim=-1) / torch.clamp(count_acc, min=1.0)
        converged = pred < cfg.tolerance
        if rel_eff is not None:
            converged = converged | (pred < rel_eff * torch.abs(err_acc))
        done = (
            done | (converged & ok_eval) | ~ok | (lm_lambda >= cfg.lm_lambda_max)
        )
        inc = se3.exp(delta)
        inc_inv = se3.inverse(inc)
        apply_final = (converged & ok_eval & ok & active)[:, None, None]
        est_acc = torch.where(apply_final, inc @ est_acc, est_acc)
        anchor_acc = torch.where(apply_final, inc_inv @ anchor_acc, anchor_acc)
        move = (~done & active)[:, None, None]
        est_try = torch.where(move, inc @ est_acc, est_acc)
        anchor_try = torch.where(move, inc_inv @ anchor_acc, anchor_acc)
        it += 1
    trace_count("loop.iterations", it)
    diag = LevelDiagnostics(
        iterations=torch.tensor(it, dtype=torch.int32, device=dev),
        error=err_acc,
        count=count_acc,
        scale=torch.rsqrt(torch.clamp(wlam, min=1e-20)),
    )
    return est_acc, anchor_acc, wlam, diag


def _gn_loop(evaluate, estimate0, anchor0, cfg, rel_eff, max_iterations):
    """Gauss-Newton over a batch with per-element stopping (``lm_lambda0``
    unset), the reference's semantics: the tolerance test comes before the
    increment is applied, an increment is applied only where the error
    decreased (so the estimate is the best one seen), an error increase
    bumps a counter that ends the element past
    ``max_increased_steps_allowed``, and ``err_prev`` moves only on
    acceptance.  With a motion prior, an accepted increment moves its anchor
    too (``inc^-1 @ anchor``).  One evaluation per iteration; the iteration
    count is shared.  -> (estimate, anchor, lambda, diagnostics).
    """
    b = estimate0.shape[0]
    dev = estimate0.device
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    estimate, anchor = estimate0, anchor0
    err_prev = torch.full((b,), _FMAX, dtype=torch.float32, device=dev)
    err_last = torch.full((b,), _FMAX, dtype=torch.float32, device=dev)
    count_last = torch.zeros((b,), dtype=torch.float32, device=dev)
    wlam = torch.full(
        (b,), 1.0 / (cfg.weighter.initial_sigma**2), dtype=torch.float32, device=dev
    )
    inc_count = torch.zeros((b,), dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    it = 0
    while it < max_iterations:
        with trace_span("sync.loop"):
            running = bool(torch.any(~done))
        if not running:
            break
        hess, rhs, err, count, _photo, wlam = evaluate(estimate, anchor, wlam)
        # 6x6 solve with a tiny Tikhonov floor for a rank-deficient H.
        damp = 1e-8 * (1.0 + torch.diagonal(hess, dim1=-2, dim2=-1).sum(-1))
        with trace_span("sync.solve"):
            delta = torch.linalg.solve(hess + damp[:, None, None] * eye6, rhs[..., None])[..., 0]
        ok = torch.all(torch.isfinite(delta), dim=-1) & (count >= 6.0)
        delta = torch.where(ok[:, None], delta, torch.zeros_like(delta))
        inc = se3.exp(delta)
        err_diff = err - err_prev
        converged = torch.abs(err_diff) < cfg.tolerance
        if cfg.relative_tolerance is not None:
            converged = converged | (torch.abs(err_diff) < rel_eff * torch.abs(err))
        decreased = err_diff < 0.0
        active = ~done
        accept = decreased & ~converged & ok & active
        estimate = torch.where(accept[:, None, None], inc @ estimate, estimate)
        if cfg.sigma is not None:
            anchor = torch.where(accept[:, None, None], se3.inverse(inc) @ anchor, anchor)
        err_prev = torch.where(accept, err, err_prev)
        inc_count = torch.where(
            converged | ~active, inc_count,
            torch.where(decreased, torch.zeros_like(inc_count), inc_count + 1),
        )
        done = done | converged | (inc_count > cfg.max_increased_steps_allowed) | ~ok
        err_last = torch.where(active, err, err_last)
        count_last = torch.where(active, count, count_last)
        it += 1
    trace_count("loop.iterations", it)
    diag = LevelDiagnostics(
        iterations=torch.tensor(it, dtype=torch.int32, device=dev),
        error=err_last,
        count=count_last,
        scale=torch.rsqrt(torch.clamp(wlam, min=1e-20)),
    )
    return estimate, anchor, wlam, diag


def _use_esm(cfg: RobustDVOConfig, level: int) -> bool:
    """Whether ``level`` takes ESM gradients."""
    return (
        cfg.use_esm_gradients
        and cfg.approximate_image2_gradient
        and (cfg.esm_levels is None or level in cfg.esm_levels)
    )


class LevelPlan(NamedTuple):
    """The branches one level takes (the JAX package's ``_solve_level``
    predicates), fixed by the configuration and the level alone."""

    stride: int
    shift_stack: bool  # the current image is sampled through a shift window
    fused: bool  # the fused kernels evaluate the level
    frozen: bool  # the window is extracted once, at the level's start
    esm: bool
    level_kernel: bool  # the LM loop runs in the level kernel
    fallback: bool  # the hard-motion trigger may send the level to the gather path
    default_mode: str  # "fused", "shift", "packed" or "plain"
    windows: Blocks  # the window centres: one, or (level kernel) per row block or tile

    @property
    def one_window(self) -> bool:
        """A frozen window around one centre, which the fused kernel reads
        too.  Elsewhere it reads a window recentred at each evaluated
        estimate, as the JAX package does at a level of blocks or tiles
        (whose frozen windows only the level kernel reads; JAX
        robust.py:811-812, :578)."""
        return self.frozen and not (self.windows.tiles or self.windows.rows)


def level_plan(cfg: RobustDVOConfig, level: int) -> LevelPlan:
    shift_stack = cfg.shift_stack_radius is not None and level in cfg.shift_stack_levels
    fused = (
        shift_stack
        and cfg.use_fused_iteration
        and cfg.approximate_image2_gradient
        # Affine rides the level kernel only; its other evaluations are "shift".
        and (
            cfg.illumination in (None, "bias")
            or (cfg.illumination == "affine" and cfg.use_level_kernel)
        )
    )
    frozen = fused and cfg.freeze_shift_window
    if shift_stack:
        mode = "fused" if fused and cfg.illumination != "affine" else "shift"
    else:
        mode = "packed" if cfg.packed_sampling else "plain"
    esm = _use_esm(cfg, level)
    level_kernel = cfg.use_level_kernel and frozen and cfg.lm_lambda0 is not None
    # Per-block and per-tile centres ride the level kernel alone, off ESM
    # (JAX robust.py:822-841); tiles take precedence over row blocks.
    blocked = level_kernel and not esm
    tiles = blocked and (cfg.recenter_col_blocks or 1) > 1 and cfg.recenter_blocks is not None
    windows = ONE_CENTRE
    if tiles or (blocked and (cfg.recenter_blocks or 1) > 1):
        windows = Blocks(
            n_blocks=cfg.recenter_blocks,
            n_blocks_x=cfg.recenter_col_blocks if tiles else 1,
            radius_y=(cfg.shift_stack_radius if cfg.shift_stack_radius_y is None
                      else cfg.shift_stack_radius_y),
            center_bound=cfg.recenter_center_bound if tiles else None,
        )
    return LevelPlan(
        stride=cfg.stride_for_level(level),
        shift_stack=shift_stack,
        fused=fused,
        frozen=frozen,
        esm=esm,
        level_kernel=level_kernel,
        fallback=cfg.shift_stack_fallback
        and (shift_stack or cfg.approximate_image2_gradient),
        default_mode=mode,
        windows=windows,
    )


def kernel_settings(cfg: RobustDVOConfig, level: int) -> dict:
    """The level kernel's keyword arguments at ``level`` under ``cfg``, by
    ``level_solver.lm_level``'s names (the Pallas kernel's): window radius
    and grid stride, t-weights, stopping rule and LM damping, illumination,
    motion prior, the depth term's weight and threshold, and the level's row
    blocks or tiles.  The image size and the inputs are the caller's;
    ``fused_iter.fused_settings`` projects out the fused kernel's."""
    plan = level_plan(cfg, level)
    return dict(
        radius=cfg.shift_stack_radius, grid_stride=plan.stride,
        dof=cfg.weighter.dof, unroll=cfg.weighter.unroll_iterations or 3,
        use_tweights=cfg.use_weighter, normalize_scale=cfg.weighter.normalize_scale,
        tolerance=cfg.tolerance, lm_lambda0=cfg.lm_lambda0, lm_up=cfg.lm_up,
        lm_down=cfg.lm_down, lm_lambda_max=cfg.lm_lambda_max,
        max_iterations=cfg.max_iterations_for_level(level),
        illum_bias=cfg.illumination == "bias", illum_affine=cfg.illumination == "affine",
        sigma=cfg.sigma, reference_prior_energy=cfg.reference_prior_energy,
        depth_weight=cfg.depth_weight, depth_huber_delta=cfg.depth_huber_delta,
        n_blocks=plan.windows.n_blocks, n_blocks_x=plan.windows.n_blocks_x,
        radius_y=plan.windows.radius_y,
    )


class PreparedLevel(NamedTuple):
    """What a level's evaluations read that does not depend on the
    evaluated estimate, built once (:func:`prepare_level`).  A field the
    level's plan does not use is None."""

    cfg: RobustDVOConfig
    level: int
    plan: LevelPlan
    settings: dict  # the kernels' keyword arguments (kernel_settings)
    intrinsics: torch.Tensor  # the level's, (3, 3) or (B, 3, 3)
    gray_prev: torch.Tensor  # (B, H', W') template on the strided grid
    depth_prev_m: torch.Tensor  # (B, H', W')
    gray_curr: torch.Tensor  # (B, H, W) current image
    depth_curr_m: Optional[torch.Tensor]  # (B, H, W) current depth, for the depth term
    u0: Optional[torch.Tensor]  # (B, H', W') warp at the level's starting estimate
    v0: Optional[torch.Tensor]
    valid_geom0: Optional[torch.Tensor]  # (B, H', W') depth-valid and in front
    planes: Optional[torch.Tensor]  # frozen window (B, s^2, ph, pw); (B, blocks, s^2, ph, pw)
    cu: Optional[torch.Tensor]  # (B,) int32 window centre; (B, blocks) or tiles (B, nby, nbx)
    cv: Optional[torch.Tensor]
    depth_planes: Optional[torch.Tensor]  # the current depth's window(s), as planes
    jac_planes: Optional[torch.Tensor]  # (B, 6, H', W') fused kernels' Jacobian (ESM-averaged)
    pre_jac: Optional[torch.Tensor]  # (B, H', W', 6) the template's, for the other evaluations
    grads: Optional[Tuple[torch.Tensor, torch.Tensor]]  # the current image's exact gradients
    grads_packed: Optional[torch.Tensor]  # the same, packed as an f16 pair
    gray_curr_packed: Optional[torch.Tensor]  # the current image packed (pack_neighbors)
    grads_z: Optional[Tuple[torch.Tensor, torch.Tensor]]  # the previous depth's, strided
    eye6: torch.Tensor  # (6, 6) identity: the motion prior's Hessian
    fused_in: Optional[LevelInputs] = None  # the fused kernel's inputs, set before its use


def _image_gradients(image: torch.Tensor, cfg: RobustDVOConfig):
    """Sobel gradients of ``image`` per full-resolution pixel (raw with
    ``raw_sobel_gain``)."""
    sgain = 1.0 if cfg.raw_sobel_gain else _SOBEL_GAIN
    gx, gy = grad_ops.sobel(image)
    return gx / sgain, gy / sgain


def _template_gradients(
    gray_prev, depth_prev_m, gray_curr, intrinsics, estimate0, cfg, level, esm=False,
):
    """The template's Sobel gradients (``gray_prev`` and ``depth_prev_m`` at
    full resolution) on the level's strided grid, from which the
    precomputed Jacobian is built.

    With ``esm`` (the ESM branch off the fused kernels), the current
    image's gradients, sampled nearest once at the level-start warp of the
    full-resolution grid, are averaged in wherever that sample is valid.
    The JAX package builds the Jacobian at full resolution and strides it;
    built on the strided grid from these its values are the same.
    """
    stride = cfg.stride_for_level(level)
    g1x, g1y = _image_gradients(gray_prev, cfg)
    if esm:
        packed_g2 = interp_ops.pack_pair_f16(*_image_gradients(gray_curr, cfg))
        _, u0f, v0f, vg0f = warp_geometry(depth_prev_m, intrinsics, estimate0, 1)
        g2x, g2y, ok2 = interp_ops.nearest_sample_packed(packed_g2, u0f, v0f)
        okm = vg0f & ok2
        g1x = torch.where(okm, 0.5 * (g1x + g2x), g1x)
        g1y = torch.where(okm, 0.5 * (g1y + g2y), g1y)
    return g1x[..., ::stride, ::stride], g1y[..., ::stride, ::stride]


def _esm_window_gradients(cfg, plan, g1, planes, u0, v0, vg0, cu, cv, image_hw):
    """ESM's average at a frozen level: the window sampled once at the
    level-start warp (the stack kernel), its Sobel gradient averaged with
    the template's ``g1`` wherever its whole 3x3 support is valid."""
    s, radius = plan.stride, cfg.shift_stack_radius
    sgain = 1.0 if cfg.raw_sobel_gain else _SOBEL_GAIN
    du0, dv0, in_ball0 = residual_displacements(u0, v0, cu, cv, radius, s, *image_hw)
    val0 = in_ball0 & vg0
    acc0 = stackwarp.stack_accumulate(planes, du0.contiguous(), dv0.contiguous(), radius, s)
    gwx, gwy = grad_ops.sobel(torch.where(val0, acc0, torch.zeros_like(acc0)))
    # Sobel on the strided grid measures d/d(grid step): divide by the
    # stride for d/d(full-resolution pixel), as the template's.
    gwx = gwx / (sgain * s)
    gwy = gwy / (sgain * s)
    okw = _erode3(val0)
    g1x, g1y = g1
    return torch.where(okw, 0.5 * (g1x + gwx), g1x), torch.where(okw, 0.5 * (g1y + gwy), g1y)


def prepare_level(
    gray_prev: torch.Tensor,
    depth_prev_m: torch.Tensor,
    gray_curr: torch.Tensor,
    intrinsics: torch.Tensor,
    estimate0: torch.Tensor,
    cfg: RobustDVOConfig,
    level: int,
    depth_curr: Optional[torch.Tensor] = None,
) -> PreparedLevel:
    """A level's estimate-independent inputs, from the template, its depth
    and the current image at full resolution (B, H, W), the level's
    intrinsics and its starting estimate (B, 4, 4): the template on the
    strided grid and its Sobel gradients, each once; the warp at
    ``estimate0`` where the frozen window or the hard-motion trigger reads
    it; at a frozen-window level the current image's window(s) around the
    warp's centres (one, per row block or per tile: :func:`level_plan`) and
    the fused kernels' Jacobian planes; the template's precomputed Jacobian
    or the current image's exact gradients, and the packed images, as the
    level's evaluations take them.  With ``depth_curr`` (the depth term)
    the previous depth's gradients and the current depth's windows, at the
    same centres.

    At an ESM level the Jacobian planes hold ESM's average
    (:func:`_esm_window_gradients`); affine's "shift" evaluations take the
    template's own Jacobian, without the average, beside the level kernel's
    planes.
    """
    plan = level_plan(cfg, level)
    s = plan.stride
    radius = cfg.shift_stack_radius
    approx = cfg.approximate_image2_gradient
    gp = gray_prev[..., ::s, ::s].contiguous()
    dp = depth_prev_m[..., ::s, ::s].contiguous()
    hp, wp = gp.shape[-2], gp.shape[-1]
    # The template's gradients, with ESM's average off the fused kernels
    # (theirs is the frozen window's, below).
    g1 = (
        _template_gradients(gray_prev, depth_prev_m, gray_curr, intrinsics, estimate0, cfg,
                            level, esm=plan.esm and not plan.fused)
        if approx else None
    )
    u0 = v0 = vg0 = None
    if plan.frozen or plan.fallback:
        _, u0, v0, vg0 = warp_geometry(dp, intrinsics, estimate0, s)
    planes = cu = cv = depth_planes = jac_planes = None
    g_planes = g1
    if plan.frozen:
        cu, cv = window_centres(u0, v0, radius, s, vg0, plan.windows)
        planes = window_planes(gray_curr, cu, cv, hp, wp, radius, s, plan.windows)
        if depth_curr is not None:
            depth_planes = window_planes(depth_curr, cu, cv, hp, wp, radius, s, plan.windows)
        if plan.esm:
            g_planes = _esm_window_gradients(cfg, plan, g1, planes, u0, v0, vg0, cu, cv,
                                             gray_curr.shape[-2:])
    if plan.frozen or plan.default_mode == "fused":
        jac_planes = approximate_jacobian_planes(dp, intrinsics, *g_planes, grid_stride=s)
    pre_jac = None
    if approx and (not plan.fused or cfg.illumination == "affine"):
        pre_jac = approximate_jacobian(dp, intrinsics, *g1, grid_stride=s)
    grads = None if approx else _image_gradients(gray_curr, cfg)
    grads_packed = None
    if grads is not None and (cfg.packed_sampling or plan.shift_stack):
        grads_packed = interp_ops.pack_pair_f16(*grads)
    gray_curr_packed = (
        interp_ops.pack_neighbors(gray_curr) if plan.default_mode == "packed" else None
    )
    grads_z = None
    if depth_curr is not None:
        # Always divided by the Sobel gain, raw_sobel_gain or not, as in the
        # JAX package: d(depth)/d(full-resolution pixel) at the grid points.
        gzx, gzy = grad_ops.sobel(depth_prev_m)
        grads_z = ((gzx / _SOBEL_GAIN)[..., ::s, ::s], (gzy / _SOBEL_GAIN)[..., ::s, ::s])
    eye6 = torch.eye(6, dtype=torch.float32, device=estimate0.device)
    return PreparedLevel(
        cfg=cfg, level=level, plan=plan, settings=kernel_settings(cfg, level),
        intrinsics=intrinsics, gray_prev=gp, depth_prev_m=dp, gray_curr=gray_curr,
        depth_curr_m=depth_curr, u0=u0, v0=v0, valid_geom0=vg0, planes=planes, cu=cu, cv=cv,
        depth_planes=depth_planes, jac_planes=jac_planes, pre_jac=pre_jac, grads=grads,
        grads_packed=grads_packed, gray_curr_packed=gray_curr_packed, grads_z=grads_z,
        eye6=eye6,
    )


def kernel_inputs(lv: PreparedLevel, estimate0, anchor0, wlam0, rel=None) -> LevelInputs:
    """The level kernel's inputs at a frozen level: its window(s), the
    template points and the scalar row (``level_solver.level_inputs``: the
    level's start, the window centres, the relative tolerance ``rel`` (B,)
    or None) and, with the depth term, the current depth's windows and the
    previous depth's gradients."""
    points, scal = level_inputs(lv.cu, lv.cv, lv.depth_prev_m, lv.intrinsics, estimate0,
                                anchor0, wlam0, rel, lv.plan.stride)
    zgrad = None if lv.grads_z is None else torch.stack(lv.grads_z, dim=1)
    return LevelInputs(lv.planes, points, lv.gray_prev, lv.jac_planes, scal, lv.depth_planes,
                       zgrad)


def fused_inputs(lv: PreparedLevel, estimate0, anchor0, wlam0) -> LevelInputs:
    """The fused kernel's inputs: the frozen window and its centre at a
    one-window level; elsewhere none, the centres zero (each evaluation
    recentres one at its estimate, :func:`_eval_fused`)."""
    if lv.plan.one_window:
        planes, cu, cv = lv.planes, lv.cu, lv.cv
    else:
        planes = None
        cu = cv = torch.zeros((estimate0.shape[0],), dtype=torch.int32, device=estimate0.device)
    points, scal = level_inputs(cu, cv, lv.depth_prev_m, lv.intrinsics, estimate0, anchor0,
                                wlam0, None, lv.plan.stride)
    return LevelInputs(planes, points, lv.gray_prev, lv.jac_planes, scal)


def _with_fused_inputs(lv: PreparedLevel, mode: str, estimate0, anchor0, wlam0) -> PreparedLevel:
    """``lv`` with the fused kernel's inputs where ``mode`` reads them and
    it has none yet (the level kernel's path hands its own over)."""
    if mode != "fused" or lv.fused_in is not None:
        return lv
    return lv._replace(fused_in=fused_inputs(lv, estimate0, anchor0, wlam0))


def _with_gather(lv: PreparedLevel) -> PreparedLevel:
    """``lv`` with what the hard-motion path samples, each built here unless
    the level has it: the current image packed, and its exact gradients
    packed (where the level's Jacobian is the template's)."""
    packed, grads_packed = lv.gray_curr_packed, lv.grads_packed
    if grads_packed is None:
        grads_packed = interp_ops.pack_pair_f16(*_image_gradients(lv.gray_curr, lv.cfg))
    if packed is None:
        packed = interp_ops.pack_neighbors(lv.gray_curr)
    return lv._replace(gray_curr_packed=packed, grads_packed=grads_packed)


def _reduce_system(cfg, gray_prev, res, jac, valid, weight_lambda):
    """Illumination pre-fit, IRLS weights, normal equations and the
    illumination Schur of one evaluation at the strided grid.  -> (H, b,
    err, count, lambda)."""
    tpl_c = None
    illum_affine = cfg.illumination == "affine"
    if cfg.illumination is not None:
        # Remove the best unweighted illumination fit before the robust
        # weights; the Schur step then eliminates the weighted rest.
        nv = torch.clamp(valid.sum(dim=(-2, -1)).to(torch.float32), min=1.0)
        zero = torch.zeros_like(res)
        mu_r = torch.where(valid, res, zero).sum(dim=(-2, -1)) / nv
        res = torch.where(valid, res - mu_r[:, None, None], zero)
        if illum_affine:
            tpl_mu = torch.where(valid, gray_prev, zero).sum(dim=(-2, -1)) / nv
            tpl_c = torch.where(valid, gray_prev - tpl_mu[:, None, None], zero)
            alpha = (tpl_c * res).sum(dim=(-2, -1)) / torch.clamp(
                (tpl_c * tpl_c).sum(dim=(-2, -1)), min=1e-6
            )
            res = res - alpha[:, None, None] * tpl_c
    if cfg.use_weighter:
        weights, weight_lambda = t_distribution_weights_with_scale(
            res * res, valid, cfg.weighter, event_ndim=2,
            init_lambda=weight_lambda if cfg.weighter.warm_start else None,
        )
    else:
        weights = valid.to(torch.float32)
    sys = normal_equations(res, jac, weights, valid)
    if cfg.illumination == "bias":
        sys = _bias_schur(sys, res, jac, weights)
    elif illum_affine:
        sys = _affine_schur(sys, res, jac, weights, tpl_c)
    return sys.hessian, sys.rhs, sys.error, sys.count, weight_lambda


def _with_terms(lv: PreparedLevel, system, estimate, anchor):
    """The depth term, then the motion prior, added to a reduced
    photometric ``system`` (H, b, err, count, lambda), as the JAX package's
    evaluations add them.  -> (H, b, err, count, H without the prior,
    lambda)."""
    hess, rhs, err, count, lam = system
    cfg = lv.cfg
    if cfg.use_depth_residuals:
        res_z, jac_z, valid_z = depth_residuals(
            lv.depth_prev_m, lv.depth_curr_m, lv.intrinsics, estimate, *lv.grads_z,
            grid_stride=lv.plan.stride,
        )
        w_z = huber_weights(res_z * res_z, valid_z, delta=cfg.depth_huber_delta)
        sys_z = normal_equations(res_z, jac_z, w_z, valid_z)
        hess = hess + cfg.depth_weight * sys_z.hessian
        rhs = rhs + cfg.depth_weight * sys_z.rhs
        err = err + cfg.depth_weight * sys_z.error
    measured = hess
    if cfg.sigma is not None:
        log_old = se3.log(anchor)
        inv_cov = 1.0 / cfg.sigma
        hess = hess + inv_cov * lv.eye6
        rhs = rhs + inv_cov * log_old
        err = err + _prior_energy(cfg, log_old)
    return hess, rhs, err, count, measured, lam


def _sampled(lv: PreparedLevel, sample, estimate, anchor, wlam):
    """An evaluation from its sampled (residuals, Jacobian, validity)."""
    system = _reduce_system(lv.cfg, lv.gray_prev, *sample, wlam)
    return _with_terms(lv, system, estimate, anchor)


# The evaluation modes: each (level, estimate, anchor, lambda) -> (H, b,
# err, count, H without the prior, lambda).

def _eval_fused(lv: PreparedLevel, estimate, anchor, wlam):
    """One launch of the fused kernel on ``lv.fused_in``: the frozen window,
    or (``freeze_shift_window`` off, or blocks or tiles) the window
    recentred at ``estimate``.  The kernel reduces the photometric term."""
    inputs = lv.fused_in
    s, radius = lv.plan.stride, lv.cfg.shift_stack_radius
    if not lv.plan.one_window:
        hp, wp = lv.gray_prev.shape[-2], lv.gray_prev.shape[-1]
        _, u, v, vg = warp_geometry(lv.depth_prev_m, lv.intrinsics, estimate, s)
        cu, cv = compute_recenter(u, v, radius, s, vg)
        planes = extract_parity_planes(lv.gray_curr, cu, cv, hp, wp, radius, s)
        inputs = with_window(inputs, planes, cu, cv)
    system = fused_shift_iteration(
        inputs, estimate, wlam, image_h=lv.gray_curr.shape[-2], image_w=lv.gray_curr.shape[-1],
        **fused_settings(lv.settings),
    )
    return _with_terms(lv, system, estimate, anchor)


def _eval_shift(lv: PreparedLevel, estimate, anchor, wlam):
    """The current image sampled through the window recentred at
    ``estimate`` (the stack kernel)."""
    return _sampled(lv, warp_residuals_shift(
        lv.gray_prev, lv.depth_prev_m, lv.gray_curr, lv.intrinsics, estimate,
        grads_packed=lv.grads_packed, precomputed_jacobian=lv.pre_jac,
        grid_stride=lv.plan.stride, radius=lv.cfg.shift_stack_radius,
    ), estimate, anchor, wlam)


def _eval_packed(lv: PreparedLevel, estimate, anchor, wlam):
    """The f16-packed gather with the level's Jacobian: the template's, or
    the current image's exact gradients."""
    return _sampled(lv, warp_residuals_packed(
        lv.gray_prev, lv.depth_prev_m, lv.gray_curr_packed, lv.intrinsics, estimate,
        grads_packed=lv.grads_packed, precomputed_jacobian=lv.pre_jac,
        grid_stride=lv.plan.stride,
    ), estimate, anchor, wlam)


def _eval_packed_exact(lv: PreparedLevel, estimate, anchor, wlam):
    """The f16-packed gather with the current image's exact gradients: the
    hard-motion path of a level whose Jacobian is the template's."""
    return _sampled(lv, warp_residuals_packed(
        lv.gray_prev, lv.depth_prev_m, lv.gray_curr_packed, lv.intrinsics, estimate,
        grads_packed=lv.grads_packed, grid_stride=lv.plan.stride,
    ), estimate, anchor, wlam)


def _eval_plain(lv: PreparedLevel, estimate, anchor, wlam):
    """Bilinear sampling, with the template's Jacobian or the current
    image's exact gradients."""
    gx, gy = lv.grads if lv.grads is not None else (None, None)
    return _sampled(lv, warp_residuals(
        lv.gray_prev, lv.depth_prev_m, lv.gray_curr, lv.intrinsics, estimate, gx, gy,
        precomputed_jacobian=lv.pre_jac, grid_stride=lv.plan.stride,
    ), estimate, anchor, wlam)


EVALUATIONS = {"fused": _eval_fused, "shift": _eval_shift, "packed": _eval_packed,
               "packed_exact": _eval_packed_exact, "plain": _eval_plain}


def _hard_motion(lv: PreparedLevel, estimate0, force_hard):
    """The hard-motion trigger's per-element flags at the level's start ->
    (hard (B,), the tracer's counts or None).  Its terms: shift-ball
    coverage of the centres the level will use (one, per block or per
    tile), and with the template's Jacobian the rotation angle and, at the
    coarsest level, the RMS displacement.  ``force_hard``: the retrack's
    streams, hard whatever the terms say."""
    cfg, plan = lv.cfg, lv.plan
    s = plan.stride
    u0, v0, vg0 = lv.u0, lv.v0, lv.valid_geom0
    r = cfg.shift_stack_radius if cfg.shift_stack_radius is not None else 4
    cov = window_coverage(u0, v0, r, s, vg0, plan.windows)
    terms = [cov < cfg.shift_fallback_min_coverage, None, None]
    if cfg.approximate_image2_gradient:
        rot = estimate0[:, :3, :3]
        cos_t = 0.5 * (torch.diagonal(rot, dim1=-2, dim2=-1).sum(-1) - 1.0)
        theta = torch.arccos(torch.clamp(cos_t, -1.0, 1.0))
        # ESM's Jacobian is half evaluated at the level-start warp, so a
        # relaxed rotation threshold may apply there.
        max_rot = (
            cfg.esm_fallback_max_rotation
            if plan.esm and cfg.esm_fallback_max_rotation is not None
            else cfg.fallback_max_rotation
        )
        terms[1] = theta > max_rot
        if lv.level == cfg.levels - 1:
            du, dv = _grid_displacements(u0, v0, s)
            mf = vg0.to(torch.float32)
            denom = torch.clamp(torch.sum(mf, dim=(-2, -1)), min=1.0)
            rms = torch.sqrt(torch.sum((du * du + dv * dv) * mf, dim=(-2, -1)) / denom)
            terms[2] = rms > cfg.fallback_max_displacement
    hard = terms[0]
    for term in terms[1:]:
        if term is not None:
            hard = hard | term
    counts = None
    if tracing():
        # Read back with the predicate: the streams each term flags, and
        # the streams whose result needs the gather path (a retrack
        # cascade's: the retracked ones).
        kept = hard if force_hard is None else force_hard
        counts = [kept.sum()] + [
            hard.new_zeros((), dtype=torch.int64) if t is None else t.sum() for t in terms
        ]
    if force_hard is not None:
        hard = hard | force_hard
    return hard, counts


def _solve_level(
    gray_prev: torch.Tensor,
    depth_prev_m: torch.Tensor,
    gray_curr: torch.Tensor,
    intrinsics: torch.Tensor,
    estimate0: torch.Tensor,
    prior_anchor0: torch.Tensor,
    cfg: RobustDVOConfig,
    level: int = 0,
    want_hessian: bool = False,
    force_hard: Optional[torch.Tensor] = None,
    depth_curr_m: Optional[torch.Tensor] = None,
    group=None,
):
    """One pyramid level for a batch: images (B, H, W), transforms
    (B, 4, 4); ``depth_curr_m`` (B, H, W) the current frame's depth, which
    the depth term needs; ``group`` the process group of a batch sharded
    over ranks (the trigger is then decided over all of them).  ->
    (estimate, diagnostics, Hessian or zeros: photometric plus the depth
    term, without the prior)."""
    with trace_span("track.level", level=level) as level_span:
        if cfg.use_depth_residuals and depth_curr_m is None:
            raise ValueError("use_depth_residuals needs depth_curr_m")
        b = estimate0.shape[0]
        dev = estimate0.device
        with trace_span("level.inputs"):
            lv = prepare_level(
                gray_prev, depth_prev_m, gray_curr, intrinsics, estimate0, cfg, level,
                depth_curr=depth_curr_m if cfg.use_depth_residuals else None,
            )
            plan = lv.plan
            if plan.fallback:
                hard0, counts = _hard_motion(lv, estimate0, force_hard)

        rel_eff = cfg.relative_tolerance
        need_fb = False
        if plan.fallback:
            # One predicate for the whole batch (over every rank), fixed for
            # the level: a mixed batch takes the always-correct gather path.
            with trace_span("sync.trigger"):
                if counts is None:
                    need_fb = _any_over_ranks(hard0, group)
                else:
                    need_fb, counts = _any_over_ranks_counted(hard0, group, counts)
            if counts is not None:
                _count_trigger(need_fb, b, counts, force_hard is None)
            if rel_eff is not None:
                rel_eff = rel_eff * torch.where(
                    hard0,
                    torch.tensor(cfg.fallback_tolerance_scale, device=dev),
                    torch.tensor(1.0, device=dev),
                )

        wlam_init = torch.full(
            (b,), 1.0 / (cfg.weighter.initial_sigma**2), dtype=torch.float32, device=dev
        )
        # The mode is fixed for the level: the hard-motion path samples through
        # the packed gather (with exact gradients where the level's Jacobian is
        # the template's).
        mode = plan.default_mode
        if need_fb:
            mode = "packed_exact" if cfg.approximate_image2_gradient else "packed"
        on_kernel = plan.level_kernel and not need_fb
        if tracing():
            path = ("kernel" if on_kernel
                    else f"{'lm' if cfg.lm_lambda0 is not None else 'gn'}.{mode}")
            level_span.set(path=path)
            trace_count(f"levels.{path}")

        with trace_span("level.solve"):
            if need_fb:
                lv = _with_gather(lv)
            if on_kernel:
                rel = (
                    None if rel_eff is None
                    else torch.broadcast_to(
                        torch.as_tensor(rel_eff, dtype=torch.float32, device=dev), (b,)
                    )
                )
                inputs = kernel_inputs(lv, estimate0, prior_anchor0, wlam_init, rel)
                est, anchor, wlam, err, count, its = solve_level_fused(
                    inputs, gray_curr.shape[-2], gray_curr.shape[-1], **lv.settings
                )
                diag = LevelDiagnostics(
                    iterations=its, error=err, count=count,
                    scale=torch.rsqrt(torch.clamp(wlam, min=1e-20)),
                )
                if plan.one_window:
                    lv = lv._replace(fused_in=inputs)
            else:
                lv = _with_fused_inputs(lv, mode, estimate0, prior_anchor0, wlam_init)
                loop = _lm_loop if cfg.lm_lambda0 is not None else _gn_loop
                est, anchor, wlam, diag = loop(
                    partial(EVALUATIONS[mode], lv), estimate0, prior_anchor0, cfg, rel_eff,
                    cfg.max_iterations_for_level(level),
                )
        if not want_hessian:
            return est, diag, torch.zeros((b, 6, 6), dtype=torch.float32, device=dev)
        # The photometric Hessian at the returned estimate, re-evaluated once.
        with trace_span("level.hessian"):
            lv = _with_fused_inputs(lv, mode, estimate0, prior_anchor0, wlam_init)
            return est, diag, EVALUATIONS[mode](lv, est, anchor, wlam)[4]


def _box2(x: torch.Tensor) -> torch.Tensor:
    """2x2 box downsample (odd trailing row/column dropped)."""
    h2, w2 = x.shape[-2] // 2, x.shape[-1] // 2
    a = x[..., 0 : 2 * h2 : 2, 0 : 2 * w2 : 2]
    b = x[..., 0 : 2 * h2 : 2, 1 : 2 * w2 : 2]
    c = x[..., 1 : 2 * h2 : 2, 0 : 2 * w2 : 2]
    d = x[..., 1 : 2 * h2 : 2, 1 : 2 * w2 : 2]
    return 0.25 * (a + b + c + d)


def _initial_photometric_error(
    gray_prev, depth_prev_m, gray_curr_packed, intrinsics, transform, grid_stride=1
):
    """Masked mean squared photometric error of a candidate transform;
    +inf-like (float32 max) when fewer than a quarter of the pixels stay."""
    _, u, v, valid_geom = warp_geometry(depth_prev_m, intrinsics, transform, grid_stride)
    val, ok = interp_ops.bilinear_sample_packed(gray_curr_packed, u, v)
    valid = valid_geom & ok
    res = torch.where(valid, val - gray_prev, torch.zeros_like(val))
    count = valid.to(torch.float32).sum(dim=(-2, -1))
    total = valid_geom.to(torch.float32).sum(dim=(-2, -1))
    err = (res * res).sum(dim=(-2, -1)) / torch.clamp(count, min=1.0)
    enough = count >= torch.clamp(0.25 * total, min=6.0)
    return torch.where(enough, err, torch.full_like(err, _FMAX))


def track_pair(
    prev: FrameData,
    curr: FrameData,
    camera: CameraModel,
    cfg: RobustDVOConfig,
    init_guess: Optional[torch.Tensor] = None,
    last_transform: Optional[torch.Tensor] = None,
    group=None,
) -> TrackResult:
    """Align each ``curr`` against its ``prev``: pyramids (B, H, W) per
    level on one device; init_guess / last_transform (4, 4) or (B, 4, 4).
    Runs on the device of the pyramids.

    ``group``: the process group over which a batch is sharded, this rank
    holding its slice.  The batch-global decisions and the iteration counts
    are then taken over every rank (the module docstring lists the
    collectives), so each element tracks as in the whole batch on one
    device; every rank of the group must call this together."""
    with trace_span("track.pair"):
        dev = prev.gray[0].device
        b = prev.gray[0].shape[0]
        eye = torch.eye(4, dtype=torch.float32, device=dev).expand(b, 4, 4)

        def batch4(x):
            return torch.broadcast_to(
                torch.as_tensor(x, dtype=torch.float32, device=dev), (b, 4, 4)
            )

        estimate = eye if init_guess is None else batch4(init_guess)
        anchor = eye if last_transform is None else batch4(last_transform)

        def k_at(level):
            return camera.at(level).to(dev)

        if cfg.robust_init_selection and init_guess is not None:
            with trace_span("track.init"):
                # Score candidates at half the coarsest level's resolution through
                # 2x2 box-filtered intensities.
                lvl = cfg.levels - 1
                gp_sel = _box2(prev.gray[lvl])
                hs, ws = gp_sel.shape[-2], gp_sel.shape[-1]
                dp_sel = prev.depth_m[lvl][..., ::2, ::2][..., :hs, :ws]
                packed_sel = interp_ops.pack_neighbors(_box2(curr.gray[lvl]))
                half = torch.tensor(
                    [[0.5, 0.0, -0.25], [0.0, 0.5, -0.25], [0.0, 0.0, 1.0]],
                    dtype=torch.float32, device=dev,
                )
                k_sel = half @ k_at(lvl)

                def score(candidate):
                    return _initial_photometric_error(
                        gp_sel, dp_sel, packed_sel, k_sel, candidate
                    )

                if cfg.init_scale_ladder is not None:
                    # Candidates exp(a * log(guess)) along the constant-velocity
                    # screw; a=0 is the identity, a=1 the guess verbatim (the f32
                    # log/exp round trip is ill-conditioned near theta=pi).  The
                    # first minimum wins: scales ascend, so ties go to the smaller
                    # motion.
                    scales = sorted(set((0.0, 1.0) + tuple(cfg.init_scale_ladder)))
                    xi = se3.log(estimate)
                    cands = torch.stack([
                        estimate if a == 1.0
                        else se3.exp(torch.tensor(a, dtype=torch.float32, device=dev) * xi)
                        for a in scales
                    ])
                    errs = torch.stack([score(c) for c in cands])
                    best = torch.argmin(errs, dim=0)
                    estimate = cands[best, torch.arange(b, device=dev)]
                else:
                    # Score {guess, identity}; ties keep the guess.
                    err_guess, err_eye = score(estimate), score(eye)
                    estimate = torch.where((err_eye < err_guess)[:, None, None], eye, estimate)

        est_init = estimate

        def run_cascade(force_hard):
            est = est_init
            diags = []
            hessian = None
            with trace_span("track.cascade", retrack=int(force_hard is not None)):
                for level in range(cfg.levels - 1, -1, -1):
                    est, diag, hessian = _solve_level(
                        prev.gray[level], prev.depth_m[level], curr.gray[level],
                        k_at(level), est, anchor, cfg, level=level,
                        want_hessian=(level == 0), force_hard=force_hard,
                        depth_curr_m=curr.depth_m[level], group=group,
                    )
                    diags.append(diag)
            stacked = LevelDiagnostics(
                iterations=torch.stack([d.iterations for d in diags]),
                error=torch.stack([d.error for d in diags]),
                count=torch.stack([d.count for d in diags]),
                scale=torch.stack([d.scale for d in diags]),
            )
            return est, stacked, hessian

        estimate, stacked, hessian = run_cascade(None)

        if (
            cfg.retrack_max_scale is not None
            and cfg.use_weighter
            and cfg.shift_stack_fallback
        ):
            # Scale-gated retrack from the initial estimate with the hard-motion
            # path forced at every level; results are picked per element.
            bad = stacked.scale[-1] > cfg.retrack_max_scale
            with trace_span("sync.retrack"):
                if tracing():
                    retrack, (retracked,) = _any_over_ranks_counted(bad, group, [bad.sum()])
                    trace_count("retracks", int(retrack))
                    trace_count("streams.retracked", retracked)
                else:
                    retrack = _any_over_ranks(bad, group)
            if retrack:
                est2, st2, hess2 = run_cascade(bad)
                pick = bad[:, None, None]
                estimate = torch.where(pick, est2, estimate)
                hessian = torch.where(pick, hess2, hessian)
                stacked = LevelDiagnostics(
                    iterations=torch.maximum(stacked.iterations, st2.iterations),
                    error=torch.where(bad[None], st2.error, stacked.error),
                    count=torch.where(bad[None], st2.count, stacked.count),
                    scale=torch.where(bad[None], st2.scale, stacked.scale),
                )
        if group is not None:
            iterations = stacked.iterations.clone()
            dist.all_reduce(iterations, op=dist.ReduceOp.MAX, group=group)
            stacked = stacked._replace(iterations=iterations)
        success = (
            torch.all(torch.isfinite(estimate).reshape(b, -1), dim=-1)
            & torch.isfinite(stacked.error[-1])
            & (stacked.count[-1] >= 6.0)
        )
        return TrackResult(
            transform=estimate, success=success, diagnostics=stacked, hessian=hessian
        )


def step_pose(pose: torch.Tensor, result: TrackResult) -> torch.Tensor:
    """``pose_t = pose_{t-1} @ transform^-1`` on success, unchanged otherwise."""
    new_pose = pose @ se3.inverse(result.transform)
    return torch.where(result.success[..., None, None], new_pose, pose)


def make_tracker(cfg: RobustDVOConfig, device=None):
    """-> ``run(prev, curr, intrinsics, init_guess=None,
    last_transform=None)``: :func:`track_pair` under ``cfg`` on ``device``
    (None = the GPU; asking for it without one raises here).  Pyramids and
    intrinsics are moved there; an unset guess or anchor is the identity,
    as the JAX package's tracker passes it (so the init selection runs)."""
    device = resolve_device(device)

    def run(prev, curr, intrinsics, init_guess=None, last_transform=None):
        def on_device(frame):
            return FrameData(tuple(x.to(device) for x in frame.gray),
                             tuple(x.to(device) for x in frame.depth_m))

        eye = torch.eye(4, dtype=torch.float32, device=device)
        camera = CameraModel(
            intrinsics=torch.as_tensor(intrinsics, dtype=torch.float32).to(device),
            depth_scale=1.0,
        )
        return track_pair(
            on_device(prev), on_device(curr), camera, cfg,
            init_guess=eye if init_guess is None else init_guess,
            last_transform=eye if last_transform is None else last_transform,
        )

    return run
