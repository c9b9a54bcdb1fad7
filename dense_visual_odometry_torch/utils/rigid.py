"""Rigid-body alignment of corresponded 3-D point sets (Procrustes).

Counterpart of ``dense_visual_odometry_tpu/utils/rigid.py``: weighted
SVD/Kabsch with the reflection fix and Horn's quaternion method, batched over
leading axes, weights instead of point compaction, and degeneracy reported as
a validity flag instead of an exception, so that nothing is read back to the
host.

The Kabsch fit takes the SVD of its 3x3 covariance by one-sided Jacobi
(:func:`svd3`): a fixed number of sweeps of plane rotations, elementwise
over the batch.  ``torch.linalg.svd`` waits on the host for its convergence
flags on a CUDA tensor (two reads a call on the H100), and RANSAC runs it
twice a frame.  The sweeps are ~500 small launches, so on the card they are
captured once per input shape as a CUDA graph and replayed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class RigidFit(NamedTuple):
    transform: torch.Tensor  # (..., 4, 4) mapping src -> dst
    rmse: torch.Tensor  # (...,) weighted RMSE of the fit
    valid: torch.Tensor  # (...,) bool: well-conditioned problem


def _as_points(src, dst, weights):
    src = torch.as_tensor(src, dtype=torch.float32)
    dst = torch.as_tensor(dst, dtype=torch.float32, device=src.device)
    w = (torch.ones(src.shape[:-1], dtype=torch.float32, device=src.device)
         if weights is None
         else torch.as_tensor(weights, dtype=torch.float32, device=src.device))
    return src, dst, w


def _weighted_stats(src, dst, w):
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    wn = w / wsum
    mu_s = torch.einsum("...n,...ni->...i", wn, src)
    mu_d = torch.einsum("...n,...ni->...i", wn, dst)
    cs = src - mu_s[..., None, :]
    cd = dst - mu_d[..., None, :]
    cov = torch.einsum("...n,...ni,...nj->...ij", wn, cd, cs)
    return mu_s, mu_d, cs, cd, cov, wn


def _assemble(rot, mu_s, mu_d):
    t = mu_d - torch.einsum("...ij,...j->...i", rot, mu_s)
    out = torch.zeros(rot.shape[:-2] + (4, 4), dtype=rot.dtype, device=rot.device)
    out[..., :3, :3] = rot
    out[..., :3, 3] = t
    out[..., 3, 3].fill_(1.0)  # fill_: assigning a number to a 0-dim CUDA view syncs
    return out


JACOBI_SWEEPS = 6
# Column pairs of a sweep, in order.
_PAIRS = ((0, 1), (0, 2), (1, 2))


def _pair_masks(eye: torch.Tensor):
    """For each pair (p, q): (p, q, e_p e_p^T + e_q e_q^T, e_p e_q^T - e_q
    e_p^T), built on the device from ``eye`` (no host-to-device copy)."""
    out = []
    for p, q in _PAIRS:
        ep, eq = eye[:, p:p + 1], eye[:, q:q + 1]
        out.append((p, q, ep @ ep.T + eq @ eq.T, ep @ eq.T - eq @ ep.T))
    return out


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Determinants of (..., 3, 3) matrices, as the triple product of the
    columns."""
    return (m[..., :, 0] * torch.linalg.cross(m[..., :, 1], m[..., :, 2], dim=-1)).sum(-1)


_GRAPHS = {}


def svd3(a: torch.Tensor):
    """:func:`jacobi_svd3` of ``a``; on the card through a CUDA graph
    captured for ``a``'s shape on first use and replayed (the same kernels,
    one launch)."""
    if a.device.type != "cuda":
        return jacobi_svd3(a)
    key = (tuple(a.shape), a.dtype, a.device)
    if key not in _GRAPHS:
        static_in = a.clone()
        side = torch.cuda.Stream(a.device)
        side.wait_stream(torch.cuda.current_stream(a.device))
        with torch.cuda.stream(side):  # warm-up outside the capture
            jacobi_svd3(static_in)
        torch.cuda.current_stream(a.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = jacobi_svd3(static_in)
        _GRAPHS[key] = (graph, static_in, static_out)
    graph, static_in, static_out = _GRAPHS[key]
    static_in.copy_(a)
    graph.replay()
    return tuple(t.clone() for t in static_out)


def jacobi_svd3(a: torch.Tensor):
    """SVD of (..., 3, 3) matrices by one-sided Jacobi -> (U, s, V), s
    descending, with ``a = U diag(s) V^T``.  Each rotation zeroes the inner
    product of two columns of ``a V``; ``JACOBI_SWEEPS`` cyclic sweeps reach
    float32 precision.  The third left vector is the cross product of the
    first two, signed by ``a v_3`` (so U is orthonormal even where s_3 is
    rounding noise); a singular value zero to rounding (below 1e-7 of the
    largest) in the first two takes the right vector's projection
    orthogonal to the left ones before it (U = V on the null space).
    Nothing is read back to the host."""
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    g, v = a, eye.expand(a.shape).clone()
    tiny = torch.finfo(a.dtype).tiny
    masks = _pair_masks(eye)
    for _ in range(JACOBI_SWEEPS):
        for p, q, diag, skew in masks:
            gp, gq = g[..., :, p], g[..., :, q]
            alpha = (gp * gp).sum(-1)
            beta = (gq * gq).sum(-1)
            gamma = (gp * gq).sum(-1)
            rotate = gamma.abs() > tiny
            zeta = (beta - alpha) / torch.where(rotate, 2.0 * gamma, torch.ones_like(gamma))
            t = torch.where(zeta >= 0, 1.0, -1.0) / (zeta.abs() + torch.sqrt(1.0 + zeta * zeta))
            t = torch.where(rotate, t, torch.zeros_like(t))
            c = torch.rsqrt(1.0 + t * t)
            sn = c * t
            j = eye + (c - 1.0)[..., None, None] * diag + sn[..., None, None] * skew
            g, v = g @ j, v @ j
    s = torch.linalg.vector_norm(g, dim=-2)
    s, order = torch.sort(s, dim=-1, descending=True)
    idx = order[..., None, :].expand(g.shape)
    g, v = g.gather(-1, idx), v.gather(-1, idx)
    cols = []
    for i in range(2):
        live = s[..., i] > 1e-7 * s[..., 0]
        u = g[..., :, i] / torch.where(live, s[..., i], torch.ones_like(s[..., i]))[..., None]
        w = v[..., :, i]
        for prev in cols:
            w = w - (w * prev).sum(-1, keepdim=True) * prev
        w = w / torch.clamp(torch.linalg.vector_norm(w, dim=-1, keepdim=True), min=tiny)
        cols.append(torch.where(live[..., None], u, w))
    u3 = torch.linalg.cross(cols[0], cols[1], dim=-1)
    sign = torch.where((g[..., :, 2] * u3).sum(-1) < 0.0, -1.0, 1.0)
    cols.append(u3 * sign[..., None])
    return torch.stack(cols, dim=-1), s, v


def kabsch_rotation(cov: torch.Tensor):
    """The rotation maximizing ``tr(R^T cov)`` -> (R, singular values):
    ``U diag(1, 1, det(U) det(V)) V^T`` of ``cov``'s SVD, the last singular
    direction flipped where the best orthogonal map is a reflection."""
    u, s, v = svd3(cov)
    flip = torch.where(_det3(u) * _det3(v) < 0.0, -1.0, 1.0)
    d = torch.cat([torch.ones_like(s[..., :2]), flip[..., None]], dim=-1)
    return torch.einsum("...ik,...k,...jk->...ij", u, d, v), s


def _fit_rmse(transform, src, dst, wn):
    moved = (torch.einsum("...ij,...nj->...ni", transform[..., :3, :3], src)
             + transform[..., None, :3, 3])
    err2 = ((moved - dst) ** 2).sum(-1)
    return torch.sqrt(torch.einsum("...n,...n->...", wn, err2))


def _finite(transform):
    return torch.isfinite(transform).all(-1).all(-1)


def fit_rigid_svd(src, dst, weights: Optional[torch.Tensor] = None) -> RigidFit:
    """Weighted Kabsch: the SE(3) transform minimizing
    ``sum_n w_n ||T @ src_n - dst_n||^2``.

    src, dst : (..., N, 3) corresponded points; weights : (..., N)
    non-negative, or None for uniform.  With det(U) det(V^T) < 0 the last
    singular direction flips (no reflection); fewer than 2.5 effective
    points, a covariance of rank < 2 or a non-finite transform set
    ``valid`` False.  The fit does not depend on the signs of the singular
    vectors.
    """
    src, dst, w = _as_points(src, dst, weights)
    mu_s, mu_d, _, _, cov, wn = _weighted_stats(src, dst, w)
    rot, s = kabsch_rotation(cov)

    transform = _assemble(rot, mu_s, mu_d)
    rmse = _fit_rmse(transform, src, dst, wn)
    eff_points = 1.0 / torch.clamp((wn * wn).sum(-1), min=1e-12)
    valid = (eff_points >= 2.5) & (s[..., 1] > 1e-9) & _finite(transform)
    return RigidFit(transform=transform, rmse=rmse, valid=valid)


def fit_rigid_quat(src, dst, weights: Optional[torch.Tensor] = None) -> RigidFit:
    """Horn's closed-form quaternion method: the rotation is the eigenvector
    of the 4x4 matrix N built from the weighted covariance, for its largest
    eigenvalue (sign chosen so that w >= 0)."""
    src, dst, w = _as_points(src, dst, weights)
    mu_s, mu_d, _, _, cov_ds, wn = _weighted_stats(src, dst, w)
    m = cov_ds.transpose(-1, -2)  # Horn's S = sum w * src_c dst_c^T

    sxx, sxy, sxz = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    syx, syy, syz = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    szx, szy, szz = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    n = torch.stack(
        [
            torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
            torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
            torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], -1),
            torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], -1),
        ],
        -2,
    )
    _, eigvecs = torch.linalg.eigh(n)
    quat = eigvecs[..., :, -1]  # the largest eigenvalue (ascending order)
    quat = quat * torch.sign(quat[..., :1] + 1e-30)
    qw, qx, qy, qz = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    rot = torch.stack(
        [
            torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
                         2 * (qx * qz + qw * qy)], -1),
            torch.stack([2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
                         2 * (qy * qz - qw * qx)], -1),
            torch.stack([2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
                         1 - 2 * (qx * qx + qy * qy)], -1),
        ],
        -2,
    )
    transform = _assemble(rot, mu_s, mu_d)
    rmse = _fit_rmse(transform, src, dst, wn)
    eff_points = 1.0 / torch.clamp((wn * wn).sum(-1), min=1e-12)
    valid = (eff_points >= 2.5) & _finite(transform)
    return RigidFit(transform=transform, rmse=rmse, valid=valid)
