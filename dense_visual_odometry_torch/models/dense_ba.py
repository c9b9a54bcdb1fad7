"""Dense windowed bundle adjustment: joint pose + inverse-depth refinement
with a Schur complement over the depth blocks.

Counterpart of the single-device half of
``dense_visual_odometry_tpu/models/dense_ba.py``.  Over K keyframe poses
(camera-to-world) and K x P inverse depths on a fixed subsampled pixel
grid per keyframe it minimizes, over directed keyframe pairs (i -> j),

    sum_{(i,j)} sum_p  w_huber( I_j(pi(X_j^-1 X_i  X(p, rho_ip))) - I_i(p) )
      + depth anchors  w_a (rho_ip - rho_ip^meas)^2

- Edges are a (K, M) owner table (owner k observes up to M keyframes, -1
  pads): every residual of owner k touches only k's depths, so the
  depth-depth block is diagonal and is eliminated owner by owner.
- Each point's Jacobian row is the JAX package's after its non-finite
  entries are zeroed (see :func:`point_terms`): the translation and
  inverse-depth columns by the chain rule, the rotation columns 0.
- The reduced (6K, 6K) pose system is formed with einsums and
  scatter-adds, solved by a float32 Cholesky, and the depths are recovered
  by back-substitution.  Every iteration stays on the device.
- Distribution is owner sharding (:func:`optimize_dense_ba_sharded`): each
  rank holds K/world owners' rows (intensities, depths, validity, targets)
  while images, the grid, the intrinsics and the poses are replicated; it
  Schur-reduces its owners' depth blocks, one ``all_reduce`` (SUM) of (chi2,
  A', b') a Gauss-Newton iteration gives every rank the pose system, and
  each rank back-substitutes its own depths.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from dense_visual_odometry_torch.models.posegraph import gauge_prior, solve_normal_system
from dense_visual_odometry_torch.models.robust import resolve_device
from dense_visual_odometry_torch.parallel.collectives import (
    BATCH_AXIS,
    all_gather_batch,
    all_reduce_system,
    mesh_rank,
)
from dense_visual_odometry_torch.utils.lie import se3


@dataclasses.dataclass(frozen=True)
class DenseBAConfig:
    """Knobs of the dense BA solver."""

    max_iterations: int = 8
    huber_delta: float = 8.0  # intensity units
    depth_anchor_weight: float = 1.0e2  # (1/m)^-2 pull toward measured depth
    depth_damping: float = 1.0e-3  # extra diagonal on D
    gauge_weight: float = 1.0e6  # pose-0 gauge prior
    pose_damping: float = 1.0e-5
    min_inv_depth: float = 1.0e-2  # 100 m ceiling
    max_inv_depth: float = 1.0e2  # 1 cm floor


class DenseBAData(NamedTuple):
    """Static problem data (owner-major layout) on one device."""

    images: torch.Tensor  # (K, H, W) f32 keyframe intensities (sample targets)
    intensity: torch.Tensor  # (K, P) f32 template values at the grid points
    inv_depth0: torch.Tensor  # (K, P) f32 measured inverse depth (anchor)
    valid: torch.Tensor  # (K, P) f32 {0,1} grid validity (measured depth > 0)
    grid_u: torch.Tensor  # (P,) f32 grid pixel x
    grid_v: torch.Tensor  # (P,) f32
    targets: torch.Tensor  # (K, M) int32 observed keyframe indices (-1 pad)
    target_valid: torch.Tensor  # (K, M) f32 {0,1}
    intrinsics: torch.Tensor  # (3, 3)


class DenseBAResult(NamedTuple):
    poses: torch.Tensor  # (K, 4, 4)
    inv_depth: torch.Tensor  # (K, P)
    chi2: torch.Tensor  # scalar, final
    chi2_history: torch.Tensor  # (max_iterations,)


def clip_grad(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """d clip(x, lo, hi) / dx as ``jnp.clip`` (a maximum, then a minimum)
    differentiates it: 1 inside, 0 outside, 0.5 at either bound, where the
    max / min splits the derivative between its two equal arguments."""
    one = torch.ones_like(x)
    inside = torch.where((x > lo) & (x < hi), one, torch.zeros_like(x))
    return torch.where((x == lo) | (x == hi), 0.5 * one, inside)


def _bilinear(images: torch.Tensor, idx: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Bilinear samples of ``images[idx]`` at (u, v) with clamped taps and
    their derivatives with respect to u and v -> (value, ok, d/du, d/dv).
    ``ok`` is False outside the valid interpolation domain."""
    h, w = images.shape[-2], images.shape[-1]
    ok = (u >= 0.0) & (v >= 0.0) & (u <= w - 1.0) & (v <= h - 1.0)
    uc = torch.clamp(u, 0.0, w - 1.0)
    vc = torch.clamp(v, 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(uc), 0.0, w - 2.0)
    y0 = torch.clamp(torch.floor(vc), 0.0, h - 2.0)
    fx = uc - x0
    fy = vc - y0
    flat = images.reshape(images.shape[0], -1)
    base = idx * (h * w) + y0.long() * w + x0.long()
    flat = flat.reshape(-1)
    i00 = flat[base]
    i01 = flat[base + 1]
    i10 = flat[base + w]
    i11 = flat[base + w + 1]
    top = i00 * (1.0 - fx) + i01 * fx
    bot = i10 * (1.0 - fx) + i11 * fx
    value = top * (1.0 - fy) + bot * fy
    d_fx = (i01 - i00) * (1.0 - fy) + (i11 - i10) * fy
    d_fy = bot - top
    return value, ok, d_fx * clip_grad(u, 0.0, w - 1.0), d_fy * clip_grad(v, 0.0, h - 1.0)


def point_terms(
    poses: torch.Tensor,
    inv_depth: torch.Tensor,
    data: DenseBAData,
    cfg: DenseBAConfig,
    owners: Optional[torch.Tensor] = None,
):
    """Every (owner, target, point) residual and its Jacobian row.

    -> r, w (Ko, M, P); gi, gj (Ko, M, P, 6); grho (Ko, M P): the
    photometric residual, its Huber IRLS weight (0 where invalid), and its
    derivatives with respect to left-multiplicative perturbations of the
    owner and target poses and to the owner's inverse depth, at zero
    perturbation.  ``data``'s owner rows (and ``inv_depth``) are those of
    the owners ``owners`` (Ko,) (global indices into ``poses`` (K, 4, 4));
    None means every keyframe in order (Ko = K).

    The JAX package takes this row by reverse-mode AD through ``se3.exp``
    at zero (``dense_ba.py:165``); there ``theta = sqrt(theta_sq)`` has an
    infinite derivative at 0, so all six rotation columns come out NaN,
    and ``dense_ba.py:202`` sets every non-finite entry to 0.  Its dense BA
    therefore refines translations and inverse depths only.  The rotation
    columns here are 0 for the same result; the translation and
    inverse-depth columns follow the chain rule (at zero rotation the
    translation perturbation moves a pose's translation by exactly itself).
    """
    k_mat = data.intrinsics
    fx, fy = k_mat[0, 0], k_mat[1, 1]
    cx, cy = k_mat[0, 2], k_mat[1, 2]
    tgt = torch.clamp(data.targets.long(), min=0)  # (Ko, M)
    kk, m = tgt.shape
    p = data.grid_u.shape[0]
    owner_poses = poses if owners is None else poses[owners]

    rho_t = inv_depth[:, None, :]  # (K, 1, P)
    z = 1.0 / torch.clamp(rho_t, min=1e-6)
    # d z / d rho: d max(rho, 1e-6) / d rho splits at a tie, as jnp.maximum.
    dmax = torch.where(rho_t > 1e-6, torch.ones_like(rho_t),
                       torch.where(rho_t == 1e-6, 0.5 * torch.ones_like(rho_t),
                                   torch.zeros_like(rho_t)))
    dz = -(z * z) * dmax
    a = (data.grid_u - cx) / fx  # (P,)
    b = (data.grid_v - cy) / fy
    x_cam_i = torch.stack([a * z, b * z, z.expand(kk, 1, p)], dim=-1)  # (K, 1, P, 3)

    pose_j = poses[tgt]  # (K, M, 4, 4)
    r_i = owner_poses[:, None, :3, :3].expand(kk, m, 3, 3)
    t_i = owner_poses[:, None, :3, 3]
    r_j = pose_j[..., :3, :3]
    t_j = pose_j[..., :3, 3]
    x_world = torch.einsum("kab,kpb->kpa", r_i[:, 0], x_cam_i[:, 0])[:, None] + t_i[:, :, None, :]
    x_cam_j = torch.einsum("kmba,kmpb->kmpa", r_j, x_world - t_j[:, :, None, :])

    z_j = x_cam_j[..., 2]
    in_front = z_j > 1e-6
    z_safe = torch.where(in_front, z_j, torch.ones_like(z_j))
    u_j = fx * x_cam_j[..., 0] / z_safe + cx
    v_j = fy * x_cam_j[..., 1] / z_safe + cy
    img_idx = tgt[:, :, None].expand(kk, m, p)
    value, in_bounds, g_u, g_v = _bilinear(data.images, img_idx, u_j, v_j)
    r = value - data.intensity[:, None, :]
    ok = in_front & in_bounds

    # d r / d x_cam_j through the projection (z enters only in front).
    g_x = g_u * fx / z_safe
    g_y = g_v * fy / z_safe
    g_z = torch.where(
        in_front,
        -(g_u * fx * x_cam_j[..., 0] + g_v * fy * x_cam_j[..., 1]) / (z_safe * z_safe),
        torch.zeros_like(z_safe),
    )
    g_xcj = torch.stack([g_x, g_y, g_z], dim=-1)  # (K, M, P, 3)
    g_world = torch.einsum("kmab,kmpb->kmpa", r_j, g_xcj)  # d r / d x_world
    g_cam_i = torch.einsum("kmba,kmpb->kmpa", r_i, g_world)  # d r / d x_cam_i
    grho = (g_cam_i[..., 0] * a + g_cam_i[..., 1] * b + g_cam_i[..., 2]) * dz
    zero3 = torch.zeros_like(g_world)
    gi = torch.cat([g_world, zero3], dim=-1)
    gj = torch.cat([-g_world, zero3], dim=-1)

    absr = torch.abs(r)
    w_huber = torch.where(absr <= cfg.huber_delta, torch.ones_like(absr),
                          cfg.huber_delta / torch.clamp(absr, min=1e-9))
    w = w_huber * ok.to(torch.float32) * data.valid[:, None, :] * data.target_valid[:, :, None]
    finite = torch.isfinite(r)
    w = torch.where(finite, w, torch.zeros_like(w))
    r = torch.where(finite, r, torch.zeros_like(r))

    def finite_or_zero(x):
        return torch.where(torch.isfinite(x), x, torch.zeros_like(x))

    return r, w, finite_or_zero(gi), finite_or_zero(gj), finite_or_zero(grho)


def build_reduced_system(
    poses: torch.Tensor,
    inv_depth: torch.Tensor,
    data: DenseBAData,
    cfg: DenseBAConfig,
    owners: Optional[torch.Tensor] = None,
):
    """Linearize and Schur-eliminate the depth block of each owner of
    ``data`` (``owners``: as :func:`point_terms`; the JAX package's
    ``_ShardData.owner_index`` and ``k_total``, K = ``poses.shape[0]``).

    -> (chi2, A' (K, K, 6, 6), b' (K, 6), dinv (Ko, P), gd (Ko, P),
    y (Ko, P, K, 6)): these owners' additive share of the reduced pose
    system and their back-substitution data.  ``y`` is Ko * P * K * 6
    floats (472 MB at Ko = K = 64, P = 4,800).
    """
    r, w, gi, gj, grho = point_terms(poses, inv_depth, data, cfg, owners)
    kk, m, p = r.shape
    k_total = poses.shape[0]
    dev = r.device
    chi2 = torch.sum(w * r * r)

    # Pose-pose block A and pose gradient b, scattered over K.
    a_ii = torch.einsum("omp,ompi,ompj->oij", w, gi, gi)
    a_jj = torch.einsum("omp,ompi,ompj->omij", w, gj, gj)
    a_ij = torch.einsum("omp,ompi,ompj->omij", w, gi, gj)
    wr = w * r
    b_i = -torch.einsum("omp,ompi->oi", wr, gi)
    b_j = -torch.einsum("omp,ompi->omi", wr, gj)

    local = torch.arange(kk, device=dev)
    own = local if owners is None else owners.long()
    own_m = own[:, None].expand(kk, m)
    tgt = torch.clamp(data.targets.long(), min=0)
    a = torch.zeros((k_total, k_total, 6, 6), dtype=torch.float32, device=dev)
    a.index_put_((own, own), a_ii, accumulate=True)
    a.index_put_((tgt, tgt), a_jj, accumulate=True)
    a.index_put_((own_m, tgt), a_ij, accumulate=True)
    a.index_put_((tgt, own_m), a_ij.transpose(-1, -2), accumulate=True)
    bvec = torch.zeros((k_total, 6), dtype=torch.float32, device=dev)
    bvec.index_put_((own,), b_i, accumulate=True)
    bvec.index_put_((tgt,), b_j, accumulate=True)

    # Depth blocks (diagonal, owner-local), with the depth anchors
    # (residual rho - rho0, Jacobian 1).
    d = torch.sum(w * grho * grho, dim=1)
    gd = -torch.sum(w * grho * r, dim=1)
    wa = cfg.depth_anchor_weight * data.valid
    r_anchor = inv_depth - data.inv_depth0
    chi2 = chi2 + torch.sum(wa * r_anchor * r_anchor)
    d = d + wa
    gd = gd - wa * r_anchor

    # y[o, p] in R^{K x 6}: the depth-pose coupling w * grho * g_pose,
    # scattered at (owner, target); built as (o, k, p, 6) and viewed as
    # (o, p, k, 6).
    wg = w * grho
    y_own = torch.einsum("omp,ompi->opi", wg, gi)
    y_tgt = wg[..., None] * gj
    y = torch.zeros((kk, k_total, p, 6), dtype=torch.float32, device=dev)
    y.index_put_((local, own), y_own, accumulate=True)
    y.index_put_((local[:, None].expand(kk, m), tgt), y_tgt, accumulate=True)
    y = y.permute(0, 2, 1, 3)

    # Schur elimination of the diagonal depth block.
    dinv = data.valid / (d + cfg.depth_damping)
    ydinv = y * dinv[..., None, None]
    a_red = a - torch.einsum("opki,oplj->klij", ydinv, y)
    b_red = bvec - torch.einsum("op,opki->ki", gd * dinv, y)
    return chi2, a_red, b_red, dinv, gd, y


def ba_iteration(poses, inv_depth, data: DenseBAData, cfg: DenseBAConfig,
                 owners: Optional[torch.Tensor] = None, group=None):
    """One Gauss-Newton iteration: linearize, Schur-reduce, solve the poses,
    back-substitute the depths -> (poses, inv_depth, chi2, ok).  With a
    ``group`` (``data`` and ``inv_depth`` holding this rank's ``owners``) the
    reduced system is summed over its ranks first."""
    chi2, a_red, b_red, dinv, gd, y = build_reduced_system(
        poses, inv_depth, data, cfg, owners)
    if group is not None:
        chi2, a_red, b_red = all_reduce_system(chi2, a_red, b_red, group)
    gauge = gauge_prior(poses.shape[0], cfg.gauge_weight, poses.device)
    delta_x, ok = solve_normal_system(a_red, b_red, gauge, cfg.pose_damping)
    delta_rho = dinv * (gd - torch.einsum("opki,ki->op", y, delta_x))
    new_poses = torch.where(ok, se3.exp(delta_x) @ poses, poses)
    new_rho = torch.clamp(
        inv_depth + torch.where(ok, delta_rho, torch.zeros_like(delta_rho)),
        cfg.min_inv_depth, cfg.max_inv_depth,
    )
    new_rho = torch.where(data.valid > 0, new_rho, inv_depth)
    return new_poses, new_rho, chi2, ok


def optimize_dense_ba(
    poses: torch.Tensor,
    data: DenseBAData,
    cfg: DenseBAConfig = DenseBAConfig(),
) -> DenseBAResult:
    """Dense BA over all K keyframes on the device of the data: a fixed
    ``cfg.max_iterations`` iterations, no host read."""
    ps = poses.to(device=data.images.device, dtype=torch.float32)
    rho = data.inv_depth0
    hist = torch.full((cfg.max_iterations,), float("inf"), dtype=torch.float32,
                      device=ps.device)
    for it in range(cfg.max_iterations):
        ps, rho, chi2, _ = ba_iteration(ps, rho, data, cfg)
        hist[it] = chi2
    chi2, *_ = build_reduced_system(ps, rho, data, cfg)
    return DenseBAResult(poses=ps, inv_depth=rho, chi2=chi2, chi2_history=hist)


def owner_shard(data: DenseBAData, rank: int, world: int):
    """Rank ``rank``'s contiguous K/world owners of ``data`` -> (the data
    with their rows alone, their global indices); raises ``ValueError``
    unless K divides the ranks."""
    k = data.intensity.shape[0]
    if k % world:
        raise ValueError(f"keyframes ({k}) must divide the ranks ({world})")
    ko = k // world
    sl = slice(rank * ko, (rank + 1) * ko)
    shard = data._replace(
        intensity=data.intensity[sl], inv_depth0=data.inv_depth0[sl],
        valid=data.valid[sl], targets=data.targets[sl],
        target_valid=data.target_valid[sl],
    )
    return shard, torch.arange(rank * ko, (rank + 1) * ko, device=data.intensity.device)


def reduced_system_sharded(
    mesh: DeviceMesh,
    poses: torch.Tensor,
    data: DenseBAData,
    cfg: DenseBAConfig = DenseBAConfig(),
    axis_name: str = BATCH_AXIS,
):
    """The reduced pose system (chi2, A', b') at ``poses`` and the measured
    depths, each rank reducing its owners and one ``all_reduce`` summing
    them: what :func:`build_reduced_system` gives on one device, summed in
    another order."""
    rank, world, group = mesh_rank(mesh, axis_name)
    shard, owners = owner_shard(data, rank, world)
    chi2, a_red, b_red, *_ = build_reduced_system(poses, shard.inv_depth0, shard, cfg, owners)
    return all_reduce_system(chi2, a_red, b_red, group)


def optimize_dense_ba_sharded(
    mesh: DeviceMesh,
    poses: torch.Tensor,
    data: DenseBAData,
    cfg: DenseBAConfig = DenseBAConfig(),
    axis_name: str = BATCH_AXIS,
) -> DenseBAResult:
    """:func:`optimize_dense_ba` with the owners sharded over ``mesh``:
    every rank passes the whole problem, keeps its contiguous K/world
    owners' rows (:func:`owner_shard`), and returns the whole result (poses
    replicated, the inverse depths all-gathered to (K, P)).  One
    ``all_reduce`` of the reduced pose system a Gauss-Newton iteration, and
    one of the final chi2.  K must divide the ranks (pad with zero-valid
    owners upstream).  Every rank of the mesh must call this together.

    The JAX version turns shard_map's replication check off
    (``check_vma=False``) because its reverse-mode Jacobians would
    otherwise sum every device's cotangents; the Jacobians here are closed
    form (:func:`point_terms`), so nothing needs turning off.
    """
    rank, world, group = mesh_rank(mesh, axis_name)
    shard, owners = owner_shard(data, rank, world)
    ps = poses.to(device=data.images.device, dtype=torch.float32)
    rho = shard.inv_depth0
    hist = torch.full((cfg.max_iterations,), float("inf"), dtype=torch.float32,
                      device=ps.device)
    for it in range(cfg.max_iterations):
        ps, rho, chi2, _ = ba_iteration(ps, rho, shard, cfg, owners, group)
        hist[it] = chi2
    chi2 = build_reduced_system(ps, rho, shard, cfg, owners)[0].reshape(1)
    dist.all_reduce(chi2, op=dist.ReduceOp.SUM, group=group)
    return DenseBAResult(poses=ps, inv_depth=all_gather_batch(rho, group),
                         chi2=chi2[0], chi2_history=hist)


def build_dense_ba_data(
    grays: Sequence,
    depths_m: Sequence,
    intrinsics,
    grid_stride: int = 8,
    window: int = 2,
    targets: Optional[np.ndarray] = None,
    device=None,
) -> DenseBAData:
    """A :class:`DenseBAData` from K keyframe images and metric depth maps
    (arrays or tensors), on ``device`` (default: that of the first image
    if it is a tensor, else the GPU, as :func:`resolve_device` gives it).

    grid_stride : grid subsampling (every Nth pixel in each direction).
    window : each owner k observes keyframes within +-window (excluding
        itself), unless an explicit (K, M) ``targets`` table is given.
    """
    if device is None and isinstance(grays[0], torch.Tensor):
        device = grays[0].device
    device = resolve_device(device)

    def stack(xs):
        return torch.stack([torch.as_tensor(x, dtype=torch.float32).to(device) for x in xs])

    k = len(grays)
    images = stack(grays)
    depth_full = stack(depths_m)
    h, w = images.shape[-2], images.shape[-1]
    vs = np.arange(0, h, grid_stride, dtype=np.float32)
    us = np.arange(0, w, grid_stride, dtype=np.float32)
    vv, uu = np.meshgrid(vs, us, indexing="ij")
    grid_u = torch.as_tensor(uu.reshape(-1), device=device)
    grid_v = torch.as_tensor(vv.reshape(-1), device=device)

    intensity = images[:, ::grid_stride, ::grid_stride].reshape(k, -1)
    depth = depth_full[:, ::grid_stride, ::grid_stride].reshape(k, -1)
    valid = (depth > 1e-6).to(torch.float32)
    inv_depth0 = torch.where(depth > 1e-6, 1.0 / torch.clamp(depth, min=1e-6),
                             torch.ones_like(depth))

    if targets is None:
        m = 2 * window
        targets = np.full((k, m), -1, np.int64)
        for o in range(k):
            cands = [t for t in range(o - window, o + window + 1) if t != o and 0 <= t < k]
            targets[o, : len(cands)] = cands
    targets = np.asarray(targets)
    return DenseBAData(
        images=images,
        intensity=intensity.contiguous(),
        inv_depth0=inv_depth0.contiguous(),
        valid=valid.contiguous(),
        grid_u=grid_u,
        grid_v=grid_v,
        targets=torch.as_tensor(targets.astype(np.int32), device=device),
        target_valid=torch.as_tensor((targets >= 0).astype(np.float32), device=device),
        intrinsics=torch.as_tensor(np.asarray(intrinsics, np.float32)).to(device)
        if not isinstance(intrinsics, torch.Tensor)
        else intrinsics.to(device=device, dtype=torch.float32),
    )
