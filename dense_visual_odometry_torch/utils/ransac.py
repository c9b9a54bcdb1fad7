"""Vectorized RANSAC for rigid-body fitting.

Counterpart of ``dense_visual_odometry_tpu/utils/ransac.py``: every
hypothesis is fitted and scored in one batch (a hypothesis count from the
confidence formula), the first one with the most inliers wins, and its
consensus set is refitted with weights.

Randomness is an input.  ``ransac_rigid`` takes the minimal samples as
``sample_indices`` (H, sample_size), or draws them from a ``torch.Generator``
by the JAX package's own method for ``jax.random.choice(p=...,
replace=False)``: the top ``sample_size`` of ``log(p) + Gumbel`` noise, first
index first among equals.  The noise comes from a CPU generator and is moved
to the device, so the card and the CPU draw the same hypotheses from one
seed.  Rows without mass sort last; with fewer than ``sample_size`` rows of
mass the sample takes the first massless rows, as the JAX package does, and
the fit's gates reject the result downstream.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from dense_visual_odometry_torch.utils.rigid import RigidFit, fit_rigid_svd


def max_samples_by_confidence(confidence: float, sample_size: int, inlier_ratio: float) -> int:
    """Iterations needed to draw an all-inlier sample with ``confidence``."""
    p_all_inlier = inlier_ratio**sample_size
    if p_all_inlier >= 1.0:
        return 1
    denom = math.log(1.0 - p_all_inlier)
    if denom >= 0.0:
        return 1
    return max(1, math.ceil(math.log(1.0 - confidence) / denom))


class RansacResult(NamedTuple):
    fit: RigidFit  # final consensus refit
    inliers: torch.Tensor  # (N,) bool
    inlier_count: torch.Tensor  # int32
    best_hypothesis: torch.Tensor  # int32 index of the winning minimal sample


def sample_probabilities(sample_mask: Optional[torch.Tensor], n: int, device) -> torch.Tensor:
    """(N,) sampling distribution: uniform over the rows of ``sample_mask``
    (all rows without a mask, or when no row is set)."""
    if sample_mask is None:
        return torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    raw = sample_mask.to(torch.float32)
    total = raw.sum()
    return torch.where(total > 0.0, raw / torch.clamp(total, min=1.0),
                       torch.full_like(raw, 1.0 / n))


def first_top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest values along the last axis, the lower
    index first among equals (``jax.lax.top_k``'s order; ``torch.topk``
    keeps no order among ties)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def gumbel_samples(probs: torch.Tensor, num_hypotheses: int, sample_size: int,
                   generator: torch.Generator) -> torch.Tensor:
    """(H, sample_size) minimal samples without replacement: the top
    ``sample_size`` of ``log(p) + Gumbel`` per hypothesis, the noise drawn
    on the CPU from ``generator`` and moved to ``probs``'s device."""
    noise = torch.empty((num_hypotheses, probs.shape[0]), dtype=torch.float32)
    noise.exponential_(generator=generator)
    gumbel = -torch.log(noise)
    if probs.device.type == "cuda":  # pinned: the copy does not wait for the card
        gumbel = gumbel.pin_memory().to(probs.device, non_blocking=True)
    return first_top_k(gumbel + torch.log(probs), sample_size)


def ransac_rigid(
    src: torch.Tensor,
    dst: torch.Tensor,
    *,
    sample_indices: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    threshold: float = 0.05,
    confidence: float = 0.99,
    inlier_ratio: float = 0.5,
    sample_size: int = 4,
    num_hypotheses: Optional[int] = None,
    weights: Optional[torch.Tensor] = None,
    sample_mask: Optional[torch.Tensor] = None,
) -> RansacResult:
    """Robust SE(3) fit of ``dst ~= T @ src`` under outliers.

    src, dst : (N, 3) corresponded points; threshold : inlier distance in
    meters.  ``sample_indices`` (H, sample_size) gives the minimal samples;
    without it they are drawn from ``generator`` (``gumbel_samples``), H
    being ``num_hypotheses`` or the confidence formula's count.
    ``sample_mask`` (N,) bool restricts the draw to real rows.  The
    hypothesis with the most inliers (the first of equals) wins; its
    consensus set is refitted with ``weights``, and the fit is valid only if
    that count is at least ``sample_size``.
    """
    src = torch.as_tensor(src, dtype=torch.float32)
    dst = torch.as_tensor(dst, dtype=torch.float32, device=src.device)
    n = src.shape[0]
    if sample_indices is None:
        if generator is None:
            raise ValueError("ransac_rigid needs sample_indices or a generator")
        if num_hypotheses is None:
            num_hypotheses = max_samples_by_confidence(confidence, sample_size, inlier_ratio)
        probs = sample_probabilities(sample_mask, n, src.device)
        sample_indices = gumbel_samples(probs, num_hypotheses, sample_size, generator)
    idx = torch.as_tensor(sample_indices, device=src.device).long()

    fits = fit_rigid_svd(src[idx], dst[idx])  # (H,) minimal fits
    rot, t = fits.transform[:, :3, :3], fits.transform[:, :3, 3]
    moved = src @ rot.transpose(-1, -2) + t[:, None, :]
    dist = torch.linalg.vector_norm(moved - dst, dim=-1)
    inlier_masks = (dist < threshold) & fits.valid[:, None]
    counts = inlier_masks.to(torch.int32).sum(-1, dtype=torch.int32)
    # Index with a (1,) tensor: a 0-dim index would be read back to the host.
    best = first_top_k(counts, 1)
    inliers = inlier_masks[best][0]
    best_count = counts[best][0]

    w = inliers.to(torch.float32)
    if weights is not None:
        w = w * torch.as_tensor(weights, dtype=torch.float32, device=src.device)
    final = fit_rigid_svd(src, dst, w)
    final = final._replace(valid=final.valid & (best_count >= sample_size))
    return RansacResult(fit=final, inliers=inliers, inlier_count=best_count,
                        best_hypothesis=best[0].to(torch.int32))
