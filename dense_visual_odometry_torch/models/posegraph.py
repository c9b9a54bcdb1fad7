"""Windowed pose-graph optimization (motion-only bundle adjustment).

Counterpart of ``dense_visual_odometry_tpu/models/posegraph.py``: keyframe
poses in a window are re-optimized jointly against pairwise relative-pose
measurements, each weighted by the 6x6 information (the tracker's final
photometric Hessian J^T W J).

- Edge Jacobians are exact: forward-mode dual numbers through the SE(3)
  exp / inverse / log chain, one tangent per basis direction of the two
  endpoint perturbations, all E x 12 tangents in one batch (the JAX
  package's ``jax.jacfwd``).
- The (6K, 6K) normal system is assembled with scatter-adds and solved by
  a float32 Cholesky; a matrix that is not positive definite gives
  ``ok = False`` and a zero update, never an exception.
- The Gauss-Newton loop runs a fixed number of trips with device-side done
  masks (the JAX package's ``fori_loop``): no host read inside it.
- The gauge is fixed by a strong prior on pose 0.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.autograd.forward_ad as fwad

from dense_visual_odometry_torch.utils.lie import se3


class PoseGraphEdges(NamedTuple):
    """E relative-pose constraints between window poses.

    measurement[e] is the measured ``X_i^-1 @ X_j`` (the pose of j in i);
    information[e] its 6x6 weight.
    """

    i: torch.Tensor  # (E,) int source pose index
    j: torch.Tensor  # (E,) int target pose index
    measurement: torch.Tensor  # (E, 4, 4)
    information: torch.Tensor  # (E, 6, 6)


class PoseGraphResult(NamedTuple):
    poses: torch.Tensor  # (K, 4, 4) optimized camera-to-world poses
    chi2: torch.Tensor  # scalar final weighted squared error
    chi2_history: torch.Tensor  # (iters,) chi2 per iteration
    iterations: torch.Tensor  # int32: iterations that updated poses


def edge_residual(x_i: torch.Tensor, x_j: torch.Tensor, measurement: torch.Tensor) -> torch.Tensor:
    """r = log(Z^-1 @ X_i^-1 @ X_j), zero when the graph agrees with Z."""
    return se3.log(se3.inverse(measurement) @ se3.inverse(x_i) @ x_j)


def edge_residuals_and_jacobians(
    x_i: torch.Tensor, x_j: torch.Tensor, measurement: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(E, 4, 4) x3 -> residuals (E, 6) and the exact (E, 6, 6) Jacobians
    with respect to left-multiplicative updates ``X <- exp(delta) @ X`` of
    both endpoints.  Each edge is repeated 12 times, the k-th copy carrying
    the k-th basis vector of (delta_i, delta_j) as its tangent."""
    e = x_i.shape[0]
    eye12 = torch.eye(12, dtype=torch.float32, device=x_i.device)
    zero = torch.zeros((e * 12, 12), dtype=torch.float32, device=x_i.device)
    rep_i = x_i.repeat_interleave(12, dim=0)
    rep_j = x_j.repeat_interleave(12, dim=0)
    rep_m = measurement.repeat_interleave(12, dim=0)
    with fwad.dual_level():
        deltas = fwad.make_dual(zero, eye12.repeat(e, 1))
        r = edge_residual(
            se3.exp(deltas[:, :6]) @ rep_i, se3.exp(deltas[:, 6:]) @ rep_j, rep_m
        )
        primal, tangent = fwad.unpack_dual(r)
    r0 = primal.reshape(e, 12, 6)[:, 0]
    jac = tangent.reshape(e, 12, 6).transpose(1, 2)  # (E, 6, 12)
    return r0, jac[..., :6], jac[..., 6:]


def build_normal_system(
    poses: torch.Tensor,
    edges: PoseGraphEdges,
    k: int,
    robust_delta: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Linearize all edges at ``poses`` -> (chi2, H (K, K, 6, 6), b (K, 6)).

    Additive over edges: edges with zero information add nothing, so
    padding is free.  ``robust_delta`` applies the redescending
    Geman-McClure weight ``(d^2 / (d^2 + chi^2))^2`` per edge, chi the
    Mahalanobis error sqrt(r^T Omega r).
    """
    i, j = edges.i.long(), edges.j.long()
    r, j_i, j_j = edge_residuals_and_jacobians(poses[i], poses[j], edges.measurement)
    omega = edges.information
    if robust_delta is not None:
        chi_sq = torch.clamp(torch.einsum("ea,eab,eb->e", r, omega, r), min=1e-12)
        d_sq = robust_delta * robust_delta
        w = (d_sq / (d_sq + chi_sq)) ** 2
        omega = omega * w[:, None, None]
    omega_r = torch.einsum("eab,eb->ea", omega, r)
    chi2 = torch.sum(r * omega_r)

    h_ii = torch.einsum("eai,eab,ebj->eij", j_i, omega, j_i)
    h_jj = torch.einsum("eai,eab,ebj->eij", j_j, omega, j_j)
    h_ij = torch.einsum("eai,eab,ebj->eij", j_i, omega, j_j)
    b_i = torch.einsum("eai,ea->ei", j_i, omega_r)
    b_j = torch.einsum("eai,ea->ei", j_j, omega_r)

    # Scatter-adds; on CUDA the order of duplicate-index sums is not fixed.
    hess = torch.zeros((k, k, 6, 6), dtype=torch.float32, device=poses.device)
    hess.index_put_((i, i), h_ii, accumulate=True)
    hess.index_put_((j, j), h_jj, accumulate=True)
    hess.index_put_((i, j), h_ij, accumulate=True)
    hess.index_put_((j, i), h_ij.transpose(-1, -2), accumulate=True)
    rhs = torch.zeros((k, 6), dtype=torch.float32, device=poses.device)
    rhs.index_put_((i,), -b_i, accumulate=True)
    rhs.index_put_((j,), -b_j, accumulate=True)
    return chi2, hess, rhs


def solve_normal_system(
    hess: torch.Tensor, rhs: torch.Tensor, gauge: torch.Tensor, damping: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, K, 6, 6), (K, 6) -> per-pose update deltas (K, 6) and an ok flag
    (a bool tensor); not positive definite -> ok False and zero deltas."""
    k = rhs.shape[0]
    dim = 6 * k
    hmat = hess.permute(0, 2, 1, 3).reshape(dim, dim)
    hmat = hmat + torch.diag(gauge.reshape(dim))
    eye = torch.eye(dim, dtype=torch.float32, device=hess.device)
    hmat = hmat + damping * (1.0 + torch.trace(hmat) / dim) * eye
    chol, info = torch.linalg.cholesky_ex(hmat)
    delta = torch.cholesky_solve(rhs.reshape(dim, 1), chol).reshape(k, 6)
    ok = (info == 0) & torch.all(torch.isfinite(delta))
    return torch.where(ok, delta, torch.zeros_like(delta)), ok


def gauge_prior(k: int, weight: float, device) -> torch.Tensor:
    """(K, 6) diagonal prior that holds pose 0 (the gauge) in place."""
    gauge = torch.zeros((k, 6), dtype=torch.float32, device=device)
    gauge[0] = weight
    return gauge


def optimize_pose_graph(
    poses: torch.Tensor,
    edges: PoseGraphEdges,
    max_iterations: int = 10,
    tolerance: float = 1e-9,
    gauge_weight: float = 1e6,
    damping: float = 1e-6,
    robust_delta: Optional[float] = None,
) -> PoseGraphResult:
    """Gauss-Newton over the window on the device of ``poses``.

    poses : (K, 4, 4) initial camera-to-world poses.
    robust_delta : optional Geman-McClure threshold on the per-edge
        Mahalanobis error (see :func:`build_normal_system`).
    """
    k = poses.shape[0]
    return gauss_newton(
        poses, lambda ps: build_normal_system(ps, edges, k, robust_delta),
        max_iterations, tolerance, gauge_weight, damping,
    )


def gauss_newton(
    poses: torch.Tensor,
    system: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    max_iterations: int,
    tolerance: float,
    gauge_weight: float,
    damping: float,
) -> PoseGraphResult:
    """The JAX package's fixed-trip loop over ``system(poses) -> (chi2, H,
    b)``: a failed solve or a chi2 change below ``tolerance`` freezes the
    poses and the iteration count, with device-side masks (no host read)."""
    k = poses.shape[0]
    dev = poses.device
    gauge = gauge_prior(k, gauge_weight, dev)
    ps = poses.to(torch.float32)
    hist = torch.full((max_iterations,), float("inf"), dtype=torch.float32, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    for _ in range(max_iterations):
        chi2, hess, rhs = system(ps)
        delta, ok = solve_normal_system(hess, rhs, gauge, damping)
        ps = torch.where(done | ~ok, ps, se3.exp(delta) @ ps)
        hist = hist.index_put((it.long().reshape(1),), chi2.reshape(1))
        prev = torch.where(it > 0, hist[torch.clamp(it - 1, min=0).long()], inf)
        new_done = done | ~ok | (torch.abs(prev - chi2) < tolerance)
        it = torch.where(done, it, it + 1)
        done = new_done
    final_chi2, _, _ = system(ps)
    return PoseGraphResult(poses=ps, chi2=final_chi2, chi2_history=hist, iterations=it)


def odometry_chain_edges(
    transforms: torch.Tensor, informations: Optional[torch.Tensor] = None
) -> PoseGraphEdges:
    """Sequential-odometry edges from tracker outputs: transforms[t] maps
    frame-t points into frame t+1, so ``X_t^-1 @ X_{t+1} = transform^-1``."""
    n = transforms.shape[0]
    dev = transforms.device
    if informations is None:
        informations = torch.eye(6, dtype=torch.float32, device=dev).expand(n, 6, 6).clone()
    return PoseGraphEdges(
        i=torch.arange(n, dtype=torch.int32, device=dev),
        j=torch.arange(1, n + 1, dtype=torch.int32, device=dev),
        measurement=se3.inverse(transforms),
        information=informations,
    )


def concat_edges(*edge_sets: PoseGraphEdges) -> PoseGraphEdges:
    return PoseGraphEdges(
        i=torch.cat([e.i for e in edge_sets]),
        j=torch.cat([e.j for e in edge_sets]),
        measurement=torch.cat([e.measurement for e in edge_sets]),
        information=torch.cat([e.information for e in edge_sets]),
    )
