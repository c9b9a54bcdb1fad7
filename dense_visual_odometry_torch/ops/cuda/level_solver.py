"""Level solver: a whole pyramid level's LM solve in one kernel launch.

Counterpart of ``dense_visual_odometry_tpu/ops/pallas/level_solver.py``
(``_level_kernel`` :268, ``lm_level_pallas`` :794, ``solve_level_fused``
:928): one frozen-window centre per element, or one per row block or 2-D
tile with an anisotropic ball (``shiftwarp.WindowLayout``; the Pallas
kernel's slab and tile mosaics, :332-421).  :func:`lm_level` takes the
Pallas call's argument layout, with one window per block: on CUDA tensors
it launches ``csrc/level_solver.cu`` (each batch element runs the whole LM
loop on a cluster of CTAs, each CTA on a band of template rows;
:func:`level_geometry` sizes it); on CPU tensors it runs
:func:`lm_level_plain`, the same function in plain PyTorch.  Any other
device raises.

Per element the loop evaluates the trial pose (:func:`level_evaluation`,
which the fused kernel's plain version shares: warp of NaN-poisoned
template points, ball / in-bounds / in-front masks, tent taps of the frozen
window (each pixel's block's window, around its centre), optional
illumination pre-fit (bias: valid-mean centring; affine: also the
unweighted gain against the centred template), t-scale fixed point,
weighted normal equations with the rank-1 bias or rank-2 gain+bias Schur;
optionally the depth term, on a second frozen window over the current
depth at the same taps, with Huber weights), adds the motion prior toward
the trial anchor where ``sigma`` is set (:func:`_add_prior`, through
:func:`se3_log_rows`), then takes ``_lm_loop``'s step:
accept/reject, damping up/down and clip, damped 6x6 Cholesky solve, the
predictive and relative stopping rules, ``exp`` update of the estimate and
inverse update of the anchor.  Elements exit independently; the reported
iteration count is the batch maximum.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from dense_visual_odometry_torch.models.weighting import huber_weights
from dense_visual_odometry_torch.ops.cuda import build
from dense_visual_odometry_torch.ops.residuals import inverse_intrinsics
from dense_visual_odometry_torch.ops.shiftwarp import (
    WindowLayout,
    block_index,
    tent_sample,
    window_layout,
)

IN_COLS = 40  # scalar-row columns with one window centre
OUT_COLS = 48
FMAX = float(torch.finfo(torch.float32).max)
_SMALL_ANGLE_SQ = 1e-4
_DIAG = (0, 6, 11, 15, 18, 20)  # diagonal of the packed upper triangle
_PAIRS = [(i, j) for i in range(6) for j in range(i, 6)]
_UPPER = {p: k for k, p in enumerate(_PAIRS)}
# se3_log_rows' series of D = (1 - A/(2B))/theta^2: 1/12 + t/720 + t^2 31/60480.
_D0, _D1, _D2 = 1.0 / 12.0, 1.0 / 720.0, 31.0 / 60480.0

# Launch geometry (csrc/level_solver.cu).
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16 is Hopper's largest (non-portable) cluster
THREADS = 512                     # dvo::kThreads, threads of one CTA
SHARED_LIMIT = 232_448            # shared bytes one block may use on sm_90
STATIC_SHARED_BYTES = 8_192       # kStaticSharedBytes, the kernel's static part
RESIDENT_PLANES = 11              # residual, points 3, template, Jacobian 6
ILLUM_NONE, ILLUM_BIAS, ILLUM_AFFINE = 0, 1, 2


# ---------------------------------------------------------------------------
# Scalar algebra on per-element columns (tuples of (B,) tensors), in the
# Pallas kernel's operation order.
# ---------------------------------------------------------------------------


def _where(cond, new, old):
    return tuple(torch.where(cond, n, o) for n, o in zip(new, old))


def se3_exp_rows(d):
    """se3 exp of 6 columns (upsilon, phi) -> 12 columns (R | t) row-major."""
    ux, uy, uz, wx, wy, wz = d
    th_sq = wx * wx + wy * wy + wz * wz
    small = th_sq < _SMALL_ANGLE_SQ
    one = torch.ones_like(th_sq)
    th_safe = torch.sqrt(torch.where(small, one, th_sq))
    sin_t = torch.sin(th_safe)
    cos_t = torch.cos(th_safe)
    a = torch.where(
        small, 1.0 - th_sq / 6.0 + th_sq * th_sq / 120.0, sin_t / th_safe
    )
    b = torch.where(
        small,
        0.5 - th_sq / 24.0 + th_sq * th_sq / 720.0,
        (1.0 - cos_t) / torch.where(small, one, th_sq),
    )
    c = torch.where(
        small,
        1.0 / 6.0 - th_sq / 120.0 + th_sq * th_sq / 5040.0,
        (th_safe - sin_t) / torch.where(small, one, th_sq * th_safe),
    )
    kxx, kyy, kzz = -(wy * wy + wz * wz), -(wx * wx + wz * wz), -(wx * wx + wy * wy)
    kxy, kxz, kyz = wx * wy, wx * wz, wy * wz
    r00, r11, r22 = 1.0 + b * kxx, 1.0 + b * kyy, 1.0 + b * kzz
    r01, r10 = -a * wz + b * kxy, a * wz + b * kxy
    r02, r20 = a * wy + b * kxz, -a * wy + b * kxz
    r12, r21 = -a * wx + b * kyz, a * wx + b * kyz
    v00, v11, v22 = 1.0 + c * kxx, 1.0 + c * kyy, 1.0 + c * kzz
    v01, v10 = -b * wz + c * kxy, b * wz + c * kxy
    v02, v20 = b * wy + c * kxz, -b * wy + c * kxz
    v12, v21 = -b * wx + c * kyz, b * wx + c * kyz
    tx = v00 * ux + v01 * uy + v02 * uz
    ty = v10 * ux + v11 * uy + v12 * uz
    tz = v20 * ux + v21 * uy + v22 * uz
    return (r00, r01, r02, tx, r10, r11, r12, ty, r20, r21, r22, tz)


def se3_log_rows(m):
    """se3 log of 12 columns (R | t) -> 6 columns (upsilon, phi).

    The plain twin of the kernel's ``se3_log`` (``csrc/level_solver.cu``)
    and of the Pallas kernel's ``_se3_log_scalars``: theta from the
    trace-pivot quaternion, then V^-1 t with ``se3``'s series threshold.
    theta/2 is ``atan2(|v|, w)``, as ``utils/lie/so3.log`` takes it, where
    the Pallas kernel inverts sin by Newton steps (``atan2`` does not lower
    there); for the frame-to-frame anchors the prior reads (theta < 2.4
    rad) the two agree to float32 rounding.  Divisions by a constant are
    written as products with its float32 reciprocal on both sides, so the
    kernel repeats this bit for bit.
    """
    r00, r01, r02, tx, r10, r11, r12, ty, r20, r21, r22, tz = m
    tr = r00 + r11 + r22
    w = 0.5 * torch.sqrt(torch.clamp(1.0 + tr, min=1e-12))
    inv4w = 1.0 / (4.0 * w)
    vx = (r21 - r12) * inv4w
    vy = (r02 - r20) * inv4w
    vz = (r10 - r01) * inv4w
    vn = torch.sqrt(vx * vx + vy * vy + vz * vz)
    theta = 2.0 * torch.atan2(vn, w)
    small = vn < 1e-7
    one = torch.ones_like(vn)
    scale = torch.where(
        small, 2.0 / torch.clamp(w, min=0.5), theta / torch.where(small, one, vn)
    )
    px, py, pz = vx * scale, vy * scale, vz * scale
    t_sq = px * px + py * py + pz * pz
    small_d = t_sq < 1e-2
    t_sq_safe = torch.where(small_d, one, t_sq)
    t_safe = torch.sqrt(t_sq_safe)
    a = torch.sin(t_safe) / t_safe
    b2 = (1.0 - torch.cos(t_safe)) / t_sq_safe
    d = torch.where(
        small_d,
        _D0 + t_sq * _D1 + t_sq * t_sq * _D2,
        (1.0 - a / (2.0 * b2)) / t_sq_safe,
    )
    k1x = py * tz - pz * ty
    k1y = pz * tx - px * tz
    k1z = px * ty - py * tx
    k2x = py * k1z - pz * k1y
    k2y = pz * k1x - px * k1z
    k2z = px * k1y - py * k1x
    return (
        tx - 0.5 * k1x + d * k2x,
        ty - 0.5 * k1y + d * k2y,
        tz - 0.5 * k1z + d * k2z,
        px, py, pz,
    )


def compose_rows(a, b):
    """(R_a | t_a) @ (R_b | t_b) on 12 columns."""
    out = []
    for r in range(3):
        a0, a1, a2, at = a[4 * r : 4 * r + 4]
        for c in range(3):
            out.append(a0 * b[c] + a1 * b[4 + c] + a2 * b[8 + c])
        out.append(a0 * b[3] + a1 * b[7] + a2 * b[11] + at)
    return tuple(out)


def inverse_rows(m):
    """[R^T | -R^T t] on 12 columns."""
    r00, r01, r02, tx, r10, r11, r12, ty, r20, r21, r22, tz = m
    return (
        r00, r10, r20, -(r00 * tx + r10 * ty + r20 * tz),
        r01, r11, r21, -(r01 * tx + r11 * ty + r21 * tz),
        r02, r12, r22, -(r02 * tx + r12 * ty + r22 * tz),
    )


def chol_solve6(h21, rhs):
    """Damped-system solve by an unrolled 6x6 Cholesky (upper packing)."""

    def hij(i, j):
        return h21[_UPPER[(i, j)]] if i <= j else h21[_UPPER[(j, i)]]

    L = [[None] * 6 for _ in range(6)]
    for j in range(6):
        s = hij(j, j)
        for t in range(j):
            s = s - L[j][t] * L[j][t]
        djj = torch.sqrt(torch.clamp(s, min=1e-30))
        L[j][j] = djj
        inv = 1.0 / djj
        for i in range(j + 1, 6):
            s = hij(i, j)
            for t in range(j):
                s = s - L[i][t] * L[j][t]
            L[i][j] = s * inv
    y = [None] * 6
    for i in range(6):
        s = rhs[i]
        for t in range(i):
            s = s - L[i][t] * y[t]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for t in range(i + 1, 6):
            s = s - L[t][i] * x[t]
        x[i] = s / L[i][i]
    return tuple(x)


# ---------------------------------------------------------------------------
# The plain version.
# ---------------------------------------------------------------------------


def level_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over a level's pixels (the last two dimensions), added in
    float64 and rounded once to float32, as the kernel adds them: the
    total does not depend on the order of the sum, so the kernel, this
    version on the card and this version on the CPU agree bit for bit
    (``csrc/level_solver.cu``)."""
    return x.sum(dim=(-2, -1), dtype=torch.float64).to(torch.float32)


def _reduce(res, valid, gray, jac, lam, dof, unroll, use_tweights,
            normalize_scale, illum_bias, illum_affine, total=level_sum):
    """Illumination pre-fit, t-scale and the weighted sums of one evaluation.

    res (B, hp, wp) already zero where invalid.  -> (h21, rhs, err, count,
    lam) with the bias or affine Schur applied, as in ``_level_kernel``'s
    evaluate.  ``total`` takes every sum over the pixels.
    """
    validf = valid.to(torch.float32)
    count = total(validf)
    count_safe = torch.clamp(count, min=1.0)
    zero = torch.zeros_like(res)
    if illum_bias or illum_affine:
        mu0 = total(res) / count_safe
        res = torch.where(valid, res - mu0[:, None, None], zero)
    if illum_affine:
        tpl_mu = total(torch.where(valid, gray, zero)) / count_safe
        tpl_c = torch.where(valid, gray - tpl_mu[:, None, None], zero)
        alpha = total(tpl_c * res) / torch.clamp(
            total(tpl_c * tpl_c), min=1e-6
        )
        res = torch.where(valid, res - alpha[:, None, None] * tpl_c, zero)
    rsq = res * res
    if use_tweights:
        for _ in range(unroll):
            w_est = (dof + 1.0) / (dof + rsq * lam[:, None, None])
            sigma_sq = total(validf * rsq * w_est)
            if normalize_scale:
                sigma_sq = sigma_sq / count_safe
            lam = 1.0 / torch.clamp(sigma_sq, min=1e-20)
        weights = validf * (dof + 1.0) / (dof + rsq * lam[:, None, None])
    else:
        weights = validf
    jw = [jac[:, i] * weights for i in range(6)]
    h21 = tuple(total(jw[i] * jac[:, j]) for i, j in _PAIRS)
    rhs = tuple(-total(jw[i] * res) for i in range(6))
    err = total(weights * rsq) / count_safe
    if illum_affine:
        s_ii = total(weights * tpl_c * tpl_c)
        s_i1 = total(weights * tpl_c)
        s_11 = total(weights)
        t_i = total(weights * tpl_c * res)
        t_1 = total(weights * res)
        det = torch.clamp(s_ii * s_11 - s_i1 * s_i1, min=1e-6)
        g_i = tuple(total(jw[k] * tpl_c) for k in range(6))
        g_1 = tuple(total(jw[k]) for k in range(6))
        beta_i = (s_11 * t_i - s_i1 * t_1) / det
        beta_1 = (s_ii * t_1 - s_i1 * t_i) / det
        m_i = tuple((s_11 * g_i[k] - s_i1 * g_1[k]) / det for k in range(6))
        m_1 = tuple((s_ii * g_1[k] - s_i1 * g_i[k]) / det for k in range(6))
        h21 = tuple(
            h - (g_i[i] * m_i[j] + g_1[i] * m_1[j]) for (i, j), h in zip(_PAIRS, h21)
        )
        rhs = tuple(r + g_i[k] * beta_i + g_1[k] * beta_1 for k, r in enumerate(rhs))
        err = err - (t_i * beta_i + t_1 * beta_1) / count_safe
    elif illum_bias:
        s_safe = torch.clamp(total(weights), min=1e-6)
        rho = total(weights * res)
        g6 = tuple(total(jw[i]) for i in range(6))
        h21 = tuple(h - g6[i] * g6[j] / s_safe for (i, j), h in zip(_PAIRS, h21))
        rhs = tuple(r + g6[i] * rho / s_safe for i, r in enumerate(rhs))
        err = err - rho * rho / s_safe / count_safe
    return h21, rhs, err, count, lam


def _add_depth(h21, rhs, err, valid, z_meas, xp, yp, zp, zgrad, fx, fy, depth_weight,
               depth_huber_delta, total=level_sum):
    """The depth term of one evaluation added to its reduced system, after
    the illumination Schur, as ``_level_kernel`` adds it: on the pixels of
    ``valid`` whose tent-sampled current depth ``z_meas`` is positive, the
    residual z_meas - z' with Huber weights and the Jacobian
    grad Z . J_w - [0, 0, 1, y', -x', 0] at the warped point (x', y', z'),
    grad Z the previous depth's gradients ``zgrad`` (B, 2, H', W')."""
    ok_z = valid & (z_meas > 0.0)
    zero = torch.zeros_like(zp)
    r_z = torch.where(ok_z, z_meas - zp, zero)
    w_z = huber_weights(r_z * r_z, ok_z, depth_huber_delta)
    izz = 1.0 / torch.where(ok_z, zp, torch.ones_like(zp))
    izz2 = izz * izz
    gzx = zgrad[:, 0] * fx
    gzy = zgrad[:, 1] * fy
    jz = (
        gzx * izz,
        gzy * izz,
        -(gzx * xp + gzy * yp) * izz2 - 1.0,
        -gzx * xp * yp * izz2 - gzy * (1.0 + yp * yp * izz2) - yp,
        gzx * (1.0 + xp * xp * izz2) + gzy * xp * yp * izz2 + xp,
        -gzx * yp * izz + gzy * xp * izz,
    )
    jz = tuple(torch.where(ok_z, c, zero) for c in jz)
    jwz = [c * w_z for c in jz]
    dw = float(depth_weight)
    h21 = tuple(h + dw * total(jwz[i] * jz[j]) for (i, j), h in zip(_PAIRS, h21))
    rhs = tuple(r - dw * total(jwz[i] * r_z) for i, r in enumerate(rhs))
    count_z = torch.clamp(total(ok_z.to(torch.float32)), min=1.0)
    err = err + dw * total(w_z * r_z * r_z) / count_z
    return h21, rhs, err


def _add_prior(h21, rhs, err, anchor, sigma, reference_prior_energy):
    """The motion prior added to a reduced system, last, as
    ``_level_kernel`` adds it: H += I/sigma, rhs += log(anchor)/sigma, and
    the energy 0.5 |log|^2 / sigma (``reference_prior_energy``: the
    reference's 0.5 sigma |log|)."""
    lg = se3_log_rows(anchor)
    icov = 1.0 / sigma
    h21 = tuple(h + icov if k in _DIAG else h for k, h in enumerate(h21))
    rhs = tuple(r + icov * g for r, g in zip(rhs, lg))
    sq = lg[0] * lg[0]
    for g in lg[1:]:
        sq = sq + g * g
    if reference_prior_energy:
        return h21, rhs, err + 0.5 * sigma * torch.sqrt(sq)
    return h21, rhs, err + 0.5 * icov * sq


def in_cols(layout: WindowLayout) -> int:
    """Scalar-row columns of a layout: :data:`IN_COLS`, and with blocks each
    block's cu then each block's cv from column 40 on (the Pallas kernel's
    layout)."""
    return IN_COLS + (2 * layout.blocks if layout.blocks > 1 else 0)


def centre_maps(scal: torch.Tensor, layout: WindowLayout, hp: int, wp: int):
    """-> (cu, cv) of every grid pixel's block, (B, H', W') float32, from
    the scalar row."""
    if layout.blocks == 1:
        return scal[:, 37][:, None, None], scal[:, 38][:, None, None]
    n = layout.blocks
    blk, _, _ = block_index(layout, hp, wp, scal.device)
    return scal[:, IN_COLS:IN_COLS + n][:, blk], scal[:, IN_COLS + n:IN_COLS + 2 * n][:, blk]


def level_evaluation(
    planes, points, gray_prev, jac_planes, scal, est, wlam, radius, grid_stride,
    image_h, image_w, dof, unroll, use_tweights, normalize_scale,
    illum_bias=False, illum_affine=False, depth_planes=None, zgrad=None,
    depth_weight=1.0, depth_huber_delta=0.03, layout: Optional[WindowLayout] = None,
):
    """One evaluation of the pose ``est`` (12 columns (R | t), row-major,
    each (B,)) with the t-scale warm-started at ``wlam`` (B,), on the level
    kernel's inputs: warp of the NaN-poisoned template points, ball /
    in-bounds / in-front masks, tent taps of the frozen window, then
    :func:`_reduce`, and with ``depth_planes`` (the current depth's frozen
    window) and ``zgrad`` the depth term (:func:`_add_depth`, its depth
    tent-sampled at the same taps).  ``layout``: row blocks or tiles, each
    pixel's displacement taken from its block's centre and sampled from its
    block's window, inside the ball |du| < r, |dv| < r_y (default: one
    centre).  -> (h21, rhs, err, count, lam).  The plain version of the
    evaluation that the level kernel runs once per LM iteration and the
    fused kernel once (``csrc/cluster_eval.cuh``)."""
    dev = points.device
    hp, wp = points.shape[-2], points.shape[-1]
    s = grid_stride
    if layout is None:
        layout = window_layout(hp, wp, radius, s)
    px, py, pz = points[:, 0], points[:, 1], points[:, 2]
    fx, fy, cx, cy = (scal[:, k][:, None, None] for k in (33, 34, 35, 36))
    col = torch.arange(wp, dtype=torch.float32, device=dev)[None, None, :]
    row = torch.arange(hp, dtype=torch.float32, device=dev)[None, :, None]
    cu, cv = centre_maps(scal, layout, hp, wp)
    coli = col * float(s) + cu
    rowi = row * float(s) + cv
    rad, rad_y = float(radius), float(layout.radius_y)
    r00, r01, r02, tx, r10, r11, r12, ty, r20, r21, r22, tz = (
        e[:, None, None] for e in est
    )
    xp = r00 * px + r01 * py + r02 * pz + tx
    yp = r10 * px + r11 * py + r12 * pz + ty
    zp = r20 * px + r21 * py + r22 * pz + tz
    in_front = zp > 1e-6
    z_safe = torch.where(in_front, zp, torch.ones_like(zp))
    u = (fx * xp + cx * zp) / z_safe
    v = (fy * yp + cy * zp) / z_safe
    du = u - coli
    dv = v - rowi
    in_ball = (du > -rad) & (du < rad) & (dv > -rad_y) & (dv < rad_y)
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    in_bounds = (
        (x0 >= 0.0) & (y0 >= 0.0)
        & (x0 + 1.0 <= float(image_w - 1)) & (y0 + 1.0 <= float(image_h - 1))
    )
    valid = in_ball & in_bounds & in_front
    acc = tent_sample(planes, du, dv, radius, s, layout)
    res = torch.where(valid, acc - gray_prev, torch.zeros_like(acc))
    h21, rhs, err, count, lam = _reduce(
        res, valid, gray_prev, jac_planes, wlam, dof, unroll, use_tweights,
        normalize_scale, illum_bias, illum_affine,
    )
    if depth_planes is not None:
        h21, rhs, err = _add_depth(
            h21, rhs, err, valid, tent_sample(depth_planes, du, dv, radius, s, layout),
            xp, yp, zp, zgrad, fx, fy, depth_weight, depth_huber_delta,
        )
    return h21, rhs, err, count, lam


def lm_level_plain(
    planes, points, gray_prev, jac_planes, scal, radius, grid_stride,
    image_h, image_w, dof, unroll, use_tweights, normalize_scale, tolerance,
    lm_lambda0, lm_up, lm_down, lm_lambda_max, max_iterations,
    illum_bias=False, illum_affine=False, depth_planes=None, zgrad=None,
    sigma=None, reference_prior_energy=False, depth_weight=1.0,
    depth_huber_delta=0.03, n_blocks=1, n_blocks_x=1, radius_y=None,
) -> torch.Tensor:
    """Plain-PyTorch version of the level kernel: same inputs, same
    (B, 48) rows (row blocks, tiles and ``radius_y`` as :func:`lm_level`
    takes them).  The loop runs while any element is active; finished
    elements keep their state, which is the kernel's per-element exit.
    Each evaluation adds the depth term (``depth_planes``) and then the
    motion prior (``sigma``) at the trial anchor."""
    b, _, hp, wp = points.shape
    dev = points.device
    rel = scal[:, 39]
    layout = window_layout(hp, wp, radius, grid_stride, n_blocks, n_blocks_x, radius_y)
    check_inputs(planes, points, gray_prev, jac_planes, scal, grid_stride, radius,
                 depth_planes, zgrad, layout)

    def evaluate(est, anchor, wlam):
        h21, rhs, err, count, lam = level_evaluation(
            planes, points, gray_prev, jac_planes, scal, est, wlam, radius,
            grid_stride, image_h, image_w, dof, unroll, use_tweights,
            normalize_scale, illum_bias, illum_affine, depth_planes, zgrad,
            depth_weight, depth_huber_delta, layout,
        )
        if sigma is not None:
            h21, rhs, err = _add_prior(h21, rhs, err, anchor, sigma, reference_prior_energy)
        return h21, rhs, err, count, lam

    zero = torch.zeros(b, dtype=torch.float32, device=dev)
    est0 = tuple(scal[:, 4 * r + c] for r in range(3) for c in range(4))
    anchor0 = tuple(scal[:, 16 + 4 * r + c] for r in range(3) for c in range(4))
    its = torch.zeros(b, dtype=torch.int32, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    lm_lam = torch.full((b,), lm_lambda0, dtype=torch.float32, device=dev)
    wlam = scal[:, 32].clone()
    err_acc = torch.full((b,), FMAX, dtype=torch.float32, device=dev)
    count_acc = zero.clone()
    est_acc, anchor_acc, est_try, anchor_try = est0, anchor0, est0, anchor0
    hess_acc = tuple(zero for _ in range(21))
    rhs_acc = tuple(zero for _ in range(6))

    for _ in range(max_iterations):
        active = ~done
        if not bool(active.any()):
            break
        h21, rhs, err, count, wlam2 = evaluate(est_try, anchor_try, wlam)
        ok_eval = torch.isfinite(err) & (count >= 6.0)
        take = (err < err_acc) & ok_eval
        n_est_acc = _where(take, est_try, est_acc)
        n_anchor_acc = _where(take, anchor_try, anchor_acc)
        n_hess = _where(take, h21, hess_acc)
        n_rhs = _where(take, rhs, rhs_acc)
        n_err = torch.where(take, err, err_acc)
        n_count = torch.where(take, count, count_acc)
        n_lam = torch.where(take, lm_lam * lm_down, lm_lam * lm_up)
        n_lam = torch.clamp(n_lam, 1e-10, lm_lambda_max)

        trace = (
            n_hess[0] + n_hess[6] + n_hess[11] + n_hess[15] + n_hess[18] + n_hess[20]
        )
        floor = 1e-8 * (1.0 + trace)
        damped = tuple(
            h + (n_lam * h + floor) if k in _DIAG else h + 0.0
            for k, h in enumerate(n_hess)
        )
        delta = chol_solve6(damped, n_rhs)
        okd = torch.ones_like(done)
        for d in delta:
            okd = okd & torch.isfinite(d)
        ok = okd & (n_count >= 6.0)
        delta = tuple(torch.where(ok, d, torch.zeros_like(d)) for d in delta)
        pred = delta[0] * n_rhs[0]
        for d, r in zip(delta[1:], n_rhs[1:]):
            pred = pred + d * r
        pred = pred / torch.clamp(n_count, min=1.0)
        converged = (pred < tolerance) | (
            (rel >= 0.0) & (pred < rel * torch.abs(n_err))
        )
        done2 = done | (converged & ok_eval) | ~ok | (n_lam >= lm_lambda_max)
        inc = se3_exp_rows(delta)
        inc_inv = inverse_rows(inc)
        apply_final = converged & ok_eval & ok
        n_est_acc = _where(apply_final, compose_rows(inc, n_est_acc), n_est_acc)
        n_anchor_acc = _where(
            apply_final, compose_rows(inc_inv, n_anchor_acc), n_anchor_acc
        )
        move = ~done2
        n_est_try = _where(move, compose_rows(inc, n_est_acc), n_est_acc)
        n_anchor_try = _where(move, compose_rows(inc_inv, n_anchor_acc), n_anchor_acc)

        # Finished elements keep their state (the kernel's per-element exit).
        est_acc = _where(active, n_est_acc, est_acc)
        anchor_acc = _where(active, n_anchor_acc, anchor_acc)
        est_try = _where(active, n_est_try, est_try)
        anchor_try = _where(active, n_anchor_try, anchor_try)
        hess_acc = _where(active, n_hess, hess_acc)
        rhs_acc = _where(active, n_rhs, rhs_acc)
        err_acc = torch.where(active, n_err, err_acc)
        count_acc = torch.where(active, n_count, count_acc)
        lm_lam = torch.where(active, n_lam, lm_lam)
        wlam = torch.where(active, wlam2, wlam)
        its = its + active.to(torch.int32)
        done = torch.where(active, done2, done)

    out = torch.zeros((b, OUT_COLS), dtype=torch.float32, device=dev)
    out[:, 0:12] = torch.stack(est_acc, dim=1)
    out[:, 16:28] = torch.stack(anchor_acc, dim=1)
    out[:, 15] = 1.0
    out[:, 31] = 1.0
    out[:, 32] = wlam
    out[:, 33] = lm_lam
    out[:, 34] = torch.where(err_acc >= FMAX, torch.full_like(err_acc, FMAX), err_acc)
    out[:, 35] = count_acc
    out[:, 36] = its.to(torch.float32)
    return out


# ---------------------------------------------------------------------------
# The kernel.
# ---------------------------------------------------------------------------


def check_inputs(planes, points, gray_prev, jac_planes, scal, grid_stride, radius,
                 depth_planes=None, zgrad=None, layout: Optional[WindowLayout] = None):
    """Raise unless the level kernel's inputs (and the fused kernel's) have
    the layout, type and device the kernels take; the depth term's two
    inputs come together or not at all.  ``layout``: the windows of row
    blocks or tiles, (B, blocks, s^2, ph, pw), and their centres in the
    scalar row (default: one window, (B, s^2, ph, pw))."""
    b, _, hp, wp = points.shape
    s = grid_stride
    if s < 1:
        raise ValueError(f"grid_stride must be >= 1, got {s}")
    if layout is None:
        layout = window_layout(hp, wp, radius, s)
    window = (b,) + ((layout.blocks,) if layout.blocks > 1 else ()) + (
        s * s, layout.ph, layout.pw)
    expect = {
        "planes": (planes, window),
        "points": (points, (b, 3, hp, wp)),
        "gray_prev": (gray_prev, (b, hp, wp)),
        "jac_planes": (jac_planes, (b, 6, hp, wp)),
        "scal": (scal, (b, in_cols(layout))),
    }
    if (depth_planes is None) != (zgrad is None):
        raise ValueError("depth_planes and zgrad come together")
    if depth_planes is not None:
        expect["depth_planes"] = (depth_planes, window)
        expect["zgrad"] = (zgrad, (b, 2, hp, wp))
    for name, (t, shape) in expect.items():
        if t.device != points.device:
            raise ValueError(f"{name} is on {t.device}, expected {points.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@dataclasses.dataclass(frozen=True)
class LevelGeometry:
    """How one launch spreads a level over the card: each batch element on
    a cluster of ``cluster`` CTAs, CTA rank k on the template rows
    ``band_rows(hp, cluster)[k]``."""

    cluster: int
    band_pixels: int  # pixels of the largest band
    band_stride: int  # floats per band plane in shared memory (16-byte multiple)
    resident: bool  # inputs copied into shared memory once per launch
    shared_bytes: int  # static allowance + dynamic shared bytes of one CTA
    max_active_clusters: Optional[int]  # clusters the card holds at once; None: not asked

    @property
    def dynamic_bytes(self) -> int:
        return self.shared_bytes - STATIC_SHARED_BYTES


@dataclasses.dataclass(frozen=True)
class ClusterKernel:
    """What the geometry rule needs to know of a cluster kernel."""

    library: str  # the kernel's source, csrc/<library>.cu
    resident_planes: int  # band planes kept in shared memory where they fit
    one_wave: bool  # prefer a size whose B clusters the card holds at once


LEVEL_KERNEL = ClusterKernel("level_solver", RESIDENT_PLANES, one_wave=False)


def band_rows(hp: int, cluster: int) -> List[Tuple[int, int]]:
    """Template rows [r0, r1) of each CTA rank, as the kernel splits them."""
    return [(k * hp // cluster, (k + 1) * hp // cluster) for k in range(cluster)]


def _layout(hp: int, wp: int, cluster: int, resident_planes: int = RESIDENT_PLANES,
            centre_floats: int = 0):
    """(band pixels, band stride, resident, shared bytes) of a cluster size,
    or None where even the band's residuals do not fit in shared memory.
    ``resident_planes``: the band planes a kernel keeps in shared memory
    where they fit (the residuals among them); else it keeps the residuals
    alone.  ``resident``: more than the residuals are kept.
    ``centre_floats``: the block centres the level kernel keeps after the
    planes (:func:`centre_floats`)."""
    band = max(r1 - r0 for r0, r1 in band_rows(hp, cluster)) * wp
    stride = -(-band // 4) * 4
    for planes in (resident_planes, 1):
        shared = STATIC_SHARED_BYTES + 4 * (planes * stride + centre_floats)
        if shared <= SHARED_LIMIT:
            return band, stride, planes > 1, shared
    return None


def centre_floats(layout: WindowLayout) -> int:
    """Floats of shared memory the level kernel gives a launch's block
    centres (each block's cu and cv; none with one centre)."""
    return 2 * layout.blocks if layout.blocks > 1 else 0


def geometries(hp: int, wp: int, kernel: ClusterKernel, centres: int = 0) -> List[LevelGeometry]:
    """Every launch geometry of ``kernel`` that fits an ``hp`` x ``wp``
    level (with ``centres`` floats of block centres): each cluster size,
    with the resident planes where they fit and with the residuals alone;
    the card is not asked.  The geometries a launch may take on some batch
    size or card (``_launch(..., geometry=...)`` runs each)."""
    out = []
    for c in CLUSTER_SIZES:
        layout = _layout(hp, wp, c, kernel.resident_planes, centres) if c <= hp else None
        if layout is None:
            continue
        band, stride, resident, _ = layout
        for planes in sorted({kernel.resident_planes if resident else 1, 1}, reverse=True):
            out.append(LevelGeometry(c, band, stride, planes > 1,
                                     STATIC_SHARED_BYTES + 4 * (planes * stride + centres),
                                     None))
    return out


def level_geometry(
    batch: int,
    hp: int,
    wp: int,
    sm_count: int,
    max_active_clusters: Optional[Callable[[int, bool, int], int]] = None,
    kernel: ClusterKernel = LEVEL_KERNEL,
    centres: int = 0,
) -> LevelGeometry:
    """The launch geometry of a level of B = ``batch`` elements on an
    ``hp`` x ``wp`` template grid, on a card of ``sm_count`` SMs, for
    ``kernel`` (the level kernel's :data:`LEVEL_KERNEL` or the fused
    kernel's ``fused_iter.FUSED_KERNEL``).

    The cluster size C is the largest of :data:`CLUSTER_SIZES` that
    1. gives every CTA at least one template row and fits the band's
       residuals in shared memory (with the kernel's other resident planes
       too where they fit: ``resident``);
    2. keeps B * C within the card's SMs and at least one pixel per thread
       in a CTA, unless it is the smallest size that passes 1;
    3. the card schedules: ``max_active_clusters(C, resident,
       dynamic_bytes)`` (``cudaOccupancyMaxActiveClusters``) is at least 1,
       and, for a ``one_wave`` kernel, at least B, where some size passing
       2 is held B at once.  Without the callable (CPU), every size
       passing 2 counts as scheduled.
    A batch of more clusters than the card holds at once runs in waves.
    On an H100 (7 clusters of 16 at once) B=8 at 640x480's level 0: the
    level kernel runs faster on 16-CTA clusters with resident inputs, in
    two waves, than on 8-CTA clusters that stream them every LM iteration;
    the fused kernel, which reads its inputs once, runs faster on the
    8-CTA clusters in one wave (PERF.md).  ``centres``: floats of block
    centres in shared memory (:func:`centre_floats`).  Raises if no size
    passes 1, or the card schedules none.
    """
    layouts = {c: _layout(hp, wp, c, kernel.resident_planes, centres)
               for c in CLUSTER_SIZES if c <= hp}
    fitting = [c for c, lay in layouts.items() if lay is not None]
    if not fitting:
        raise ValueError(
            f"a {hp}x{wp} level's residual band does not fit in {SHARED_LIMIT} "
            f"bytes of shared memory at any cluster size"
        )
    wanted = [
        c for c in fitting
        if c == fitting[0] or (batch * c <= sm_count and hp * wp >= c * THREADS)
    ]
    scheduled = []
    for c in reversed(wanted):
        band, stride, resident, shared = layouts[c]
        active = None
        if max_active_clusters is not None:
            active = max_active_clusters(c, resident, shared - STATIC_SHARED_BYTES)
        if active is None or active >= 1:
            geometry = LevelGeometry(c, band, stride, resident, shared, active)
            if not kernel.one_wave or active is None or active >= batch:
                return geometry
            scheduled.append(geometry)
    if scheduled:
        return scheduled[0]
    raise RuntimeError(f"the card schedules no cluster of sizes {wanted} for a {hp}x{wp} level")


def _illum_code(illum_bias: bool, illum_affine: bool) -> int:
    return ILLUM_AFFINE if illum_affine else ILLUM_BIAS if illum_bias else ILLUM_NONE


_active_clusters: Dict[tuple, int] = {}
_geometries: Dict[tuple, LevelGeometry] = {}


def _max_active_clusters(device: torch.device, library: str, illum: int, grid_stride: int,
                         cluster: int, resident: bool, dynamic_bytes: int,
                         depth: bool = False) -> int:
    """cudaOccupancyMaxActiveClusters of one variant and shape of the
    kernel of ``csrc/<library>.cu``, asked once per process."""
    key = (device.index, library, illum, grid_stride, cluster, resident,
           dynamic_bytes, depth)
    if key not in _active_clusters:
        fn = build.load(library).dvo_max_active_clusters
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        count = ctypes.c_int(0)
        with torch.cuda.device(device):
            status = fn(illum, grid_stride, int(resident), int(depth), cluster, dynamic_bytes,
                        ctypes.byref(count))
        build.check(status, f"{library} occupancy query")
        _active_clusters[key] = count.value
    return _active_clusters[key]


def launch_geometry(points: torch.Tensor, grid_stride: int, illum_bias: bool = False,
                    illum_affine: bool = False,
                    kernel: ClusterKernel = LEVEL_KERNEL, depth: bool = False,
                    centres: int = 0) -> LevelGeometry:
    """The geometry :func:`lm_level` (or, for ``fused_iter.FUSED_KERNEL``,
    ``fused_evaluation``) launches with for these CUDA inputs; ``depth``:
    the level kernel's variant with the depth term, a kernel function of
    its own whose occupancy the card is asked for; ``centres``: floats of
    block centres (:func:`centre_floats`)."""
    b, _, hp, wp = points.shape
    dev = points.device
    illum = _illum_code(illum_bias, illum_affine)
    key = (dev.index, kernel, b, hp, wp, grid_stride, illum, depth, centres)
    if key not in _geometries:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _geometries[key] = level_geometry(
            b, hp, wp, sms,
            lambda c, resident, dyn: _max_active_clusters(
                dev, kernel.library, illum, grid_stride, c, resident, dyn, depth),
            kernel, centres,
        )
    return _geometries[key]


def _launch(planes, points, gray_prev, jac_planes, scal, radius, grid_stride,
            image_h, image_w, dof, unroll, use_tweights, normalize_scale,
            tolerance, lm_lambda0, lm_up, lm_down, lm_lambda_max,
            max_iterations, illum_bias=False, illum_affine=False, depth_planes=None,
            zgrad=None, sigma=None, reference_prior_energy=False, depth_weight=1.0,
            depth_huber_delta=0.03, n_blocks=1, n_blocks_x=1, radius_y=None,
            geometry: Optional[LevelGeometry] = None) -> torch.Tensor:
    """Launch the kernel, at ``geometry`` or at :func:`launch_geometry`'s."""
    depth = depth_planes is not None
    b, _, hp, wp = points.shape
    layout = window_layout(hp, wp, radius, grid_stride, n_blocks, n_blocks_x, radius_y)
    check_inputs(planes, points, gray_prev, jac_planes, scal, grid_stride, radius,
                 depth_planes, zgrad, layout)
    if geometry is None:
        geometry = launch_geometry(points, grid_stride, illum_bias, illum_affine, depth=depth,
                                   centres=centre_floats(layout))
    lib = build.load("level_solver")
    fn = lib.dvo_level_solver
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_float] * 5 + [ctypes.c_int]
        + [ctypes.c_int, ctypes.c_float, ctypes.c_float]
        + [ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int]
        + [ctypes.c_int] * 5
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    out = torch.empty((b, OUT_COLS), dtype=torch.float32, device=points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    status = fn(
        planes.data_ptr(), points.data_ptr(), gray_prev.data_ptr(),
        jac_planes.data_ptr(), scal.data_ptr(),
        depth_planes.data_ptr() if depth else None, zgrad.data_ptr() if depth else None,
        out.data_ptr(),
        b, grid_stride, layout.ph, layout.pw, hp, wp, in_cols(layout), radius, image_h,
        image_w, dof, unroll, int(use_tweights), int(normalize_scale),
        _illum_code(illum_bias, illum_affine), tolerance, lm_lambda0, lm_up, lm_down,
        lm_lambda_max, max_iterations,
        int(depth), depth_weight, depth_huber_delta,
        int(sigma is not None), 0.0 if sigma is None else 1.0 / sigma,
        0.0 if sigma is None else sigma, int(reference_prior_energy),
        layout.radius_y, layout.nby, layout.nbx, layout.t_y, layout.t_x,
        geometry.cluster, int(geometry.resident), geometry.band_stride,
        geometry.dynamic_bytes, stream,
    )
    build.check(status, "level_solver")
    lm_level.launches += 1
    if grid_stride >= 3:
        lm_level.runtime_stride_launches += 1
    if layout.tiles:
        lm_level.tile_launches += 1
    elif layout.blocks > 1:
        lm_level.block_launches += 1
    return out


def lm_level(
    planes: torch.Tensor,
    points: torch.Tensor,
    gray_prev: torch.Tensor,
    jac_planes: torch.Tensor,
    scal: torch.Tensor,
    radius: int,
    grid_stride: int,
    image_h: int,
    image_w: int,
    dof: float,
    unroll: int,
    use_tweights: bool,
    normalize_scale: bool,
    tolerance: float,
    lm_lambda0: float,
    lm_up: float,
    lm_down: float,
    lm_lambda_max: float,
    max_iterations: int,
    illum_bias: bool = False,
    illum_affine: bool = False,
    depth_planes: Optional[torch.Tensor] = None,
    zgrad: Optional[torch.Tensor] = None,
    sigma: Optional[float] = None,
    reference_prior_energy: bool = False,
    depth_weight: float = 1.0,
    depth_huber_delta: float = 0.03,
    n_blocks: int = 1,
    n_blocks_x: int = 1,
    radius_y: Optional[int] = None,
) -> torch.Tensor:
    """Solve one level for every element: planes (B, s^2, ph, pw), points
    (B, 3, H', W') with NaN at invalid depth, gray_prev (B, H', W'),
    jac_planes (B, 6, H', W'), scal (B, 40) -> (B, 48) rows (layouts in
    ``csrc/level_solver.cu``).  ``n_blocks`` row blocks, or with
    ``n_blocks_x`` > 1 ``n_blocks`` x ``n_blocks_x`` tiles, each with its
    own window and centre (``shiftwarp.window_layout``; planes (B, blocks,
    s^2, ph, pw), scal (B, 40 + 2 blocks)), inside the ball |du| < r,
    |dv| < ``radius_y`` (default ``radius``).  ``illum_affine`` takes precedence over
    ``illum_bias``.  ``depth_planes`` (B, s^2, ph, pw), the current depth's
    frozen window at the same centres, with ``zgrad`` (B, 2, H', W'), the
    previous depth's gradients, add the depth term (``depth_weight``,
    Huber ``depth_huber_delta``); ``sigma`` the motion prior toward the
    anchor of ``scal`` (``reference_prior_energy``: the reference's energy
    term), as ``lm_level_pallas`` takes them.  CUDA tensors run the kernel,
    CPU tensors the plain version; each checks its inputs first
    (:func:`check_inputs`)."""
    args = (planes, points, gray_prev, jac_planes, scal, radius, grid_stride,
            image_h, image_w, dof, unroll, use_tweights, normalize_scale,
            tolerance, lm_lambda0, lm_up, lm_down, lm_lambda_max,
            max_iterations, illum_bias, illum_affine, depth_planes, zgrad, sigma,
            reference_prior_energy, depth_weight, depth_huber_delta, n_blocks, n_blocks_x,
            radius_y)
    if points.device.type == "cuda":
        return _launch(*args)
    if points.device.type == "cpu":
        return lm_level_plain(*args)
    raise RuntimeError(f"lm_level: no kernel for device {points.device}")


lm_level.launches = 0
lm_level.block_launches = 0  # of them, with row blocks
lm_level.tile_launches = 0  # of them, with tiles
lm_level.runtime_stride_launches = 0  # of them, at a grid stride >= 3


def level_inputs(
    cu: torch.Tensor,
    cv: torch.Tensor,
    depth_prev_m: torch.Tensor,
    intrinsics: torch.Tensor,
    estimate0: torch.Tensor,
    anchor0: torch.Tensor,
    wlam0: torch.Tensor,
    rel: Optional[torch.Tensor],
    grid_stride: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's per-element inputs: -> (points (B, 3, H', W'), scal
    (B, 40), or (B, 40 + 2 blocks) with blocks).

    depth_prev_m (B, H', W') on the strided grid; cu / cv (B,) int32 window
    centres, or one per block: (B, blocks) or (B, nby, nbx); intrinsics
    (3, 3) or (B, 3, 3); estimate0 / anchor0 (B, 4, 4); wlam0 (B,); rel (B,)
    relative tolerance or None.
    """
    b, hp, wp = depth_prev_m.shape
    dev = depth_prev_m.device
    kmat = torch.broadcast_to(intrinsics, (b, 3, 3))
    kinv = inverse_intrinsics(kmat)
    ugrid = torch.arange(wp, dtype=torch.float32, device=dev) * grid_stride
    vgrid = torch.arange(hp, dtype=torch.float32, device=dev) * grid_stride

    def coef(i, j):
        return kinv[:, i, j][:, None, None]

    ray_x = coef(0, 0) * ugrid[None, None, :] + coef(0, 1) * vgrid[None, :, None] + coef(0, 2)
    ray_y = coef(1, 0) * ugrid[None, None, :] + coef(1, 1) * vgrid[None, :, None] + coef(1, 2)
    # Camera-frame template points, NaN where the depth is invalid so every
    # validity comparison in the solver fails there.
    okd = depth_prev_m > 0.0
    nan = torch.full_like(depth_prev_m, float("nan"))
    points = torch.stack(
        [
            torch.where(okd, ray_x * depth_prev_m, nan),
            torch.where(okd, ray_y * depth_prev_m, nan),
            torch.where(okd, depth_prev_m, nan),
        ],
        dim=1,
    ).contiguous()

    cu = cu.reshape(b, -1).to(torch.float32)
    cv = cv.reshape(b, -1).to(torch.float32)
    n = cu.shape[1]
    scal = torch.zeros((b, IN_COLS + (2 * n if n > 1 else 0)), dtype=torch.float32, device=dev)
    scal[:, 0:16] = torch.broadcast_to(estimate0, (b, 4, 4)).reshape(b, 16)
    scal[:, 16:32] = torch.broadcast_to(anchor0, (b, 4, 4)).reshape(b, 16)
    scal[:, 32] = torch.broadcast_to(wlam0, (b,))
    scal[:, 33] = kmat[:, 0, 0]
    scal[:, 34] = kmat[:, 1, 1]
    scal[:, 35] = kmat[:, 0, 2]
    scal[:, 36] = kmat[:, 1, 2]
    if n > 1:
        scal[:, IN_COLS:IN_COLS + n] = cu
        scal[:, IN_COLS + n:] = cv
    else:
        scal[:, 37] = cu[:, 0]
        scal[:, 38] = cv[:, 0]
    scal[:, 39] = -1.0 if rel is None else torch.broadcast_to(rel, (b,))
    return points, scal


class LevelInputs(NamedTuple):
    """The level kernel's inputs: the first five are :func:`lm_level`'s
    arguments, on which the fused kernel also evaluates a pose (with one
    window centre: it has no depth term, row blocks or tiles)."""

    planes: torch.Tensor
    points: torch.Tensor
    gray_prev: torch.Tensor
    jac_planes: torch.Tensor
    scal: torch.Tensor
    depth_planes: Optional[torch.Tensor] = None  # the current depth's window(s), as planes
    zgrad: Optional[torch.Tensor] = None  # (B, 2, H', W') previous depth's gradients


def with_window(
    inputs: LevelInputs, planes: torch.Tensor, cu: torch.Tensor, cv: torch.Tensor
) -> LevelInputs:
    """``inputs`` (one window centre per element) with another window: its
    planes and its centres (B,)."""
    scal = inputs.scal.clone()
    scal[:, 37] = cu.to(torch.float32)
    scal[:, 38] = cv.to(torch.float32)
    return inputs._replace(planes=planes, scal=scal)


def solve_level_fused(inputs: LevelInputs, image_h: int, image_w: int,
                      **settings) -> Tuple[torch.Tensor, ...]:
    """One level solved in one launch of :func:`lm_level` on ``inputs``
    (the scalar row as :func:`level_inputs` builds it; the depth term with
    ``depth_planes`` and ``zgrad``) under ``settings``, :func:`lm_level`'s
    other keyword arguments.  -> (est, anchor, wlam, err, count,
    iterations), iterations being the batch maximum (a 0-d int32 tensor).
    """
    b = inputs.points.shape[0]
    out = lm_level(*inputs[:5], image_h=image_h, image_w=image_w,
                   depth_planes=inputs.depth_planes, zgrad=inputs.zgrad, **settings)
    est = out[:, 0:16].reshape(b, 4, 4).clone()
    anchor = out[:, 16:32].reshape(b, 4, 4).clone()
    # The bottom row is structural: write it rather than trust the kernel.
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32, device=out.device)
    est[:, 3, :] = bottom
    anchor[:, 3, :] = bottom
    its = torch.max(out[:, 36]).to(torch.int32)
    return est, anchor, out[:, 32], out[:, 34], out[:, 35], its
