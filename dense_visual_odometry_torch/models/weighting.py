"""IRLS weights: the t-distribution with a per-element scale fixed point,
and Huber weights for the depth term.

Counterpart of ``dense_visual_odometry_tpu/models/weighting.py``: the scale
may be estimated on a strided subset (``scale_subsample``), the fixed point
runs either ``unroll_iterations`` unrolled steps or the convergence-checked
loop (each element freezes once ``|lambda' - lambda| < tolerance``; the
loop ends when all have, or after ``max_iterations``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dense_visual_odometry_torch.config import TWeighterConfig


def t_distribution_weights(
    residuals_sq: torch.Tensor,
    valid: torch.Tensor,
    cfg: TWeighterConfig,
    event_ndim: int = 0,
    init_lambda: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`t_distribution_weights_with_scale`'s weights alone."""
    return t_distribution_weights_with_scale(
        residuals_sq, valid, cfg, event_ndim, init_lambda
    )[0]


def t_distribution_weights_with_scale(
    residuals_sq: torch.Tensor,
    valid: torch.Tensor,
    cfg: TWeighterConfig,
    event_ndim: int = 0,
    init_lambda: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (weights ``(dof+1) / (dof + r^2 lambda)`` zero where invalid,
    lambda = 1/sigma^2 per leading element)."""
    dof = float(cfg.dof)
    validf = valid.to(torch.float32)
    axes = tuple(range(-event_ndim, 0)) if event_ndim else None
    batch_shape = (
        residuals_sq.shape[: residuals_sq.ndim - event_ndim] if event_ndim else ()
    )
    expand = (Ellipsis,) + (None,) * event_ndim

    sub = cfg.scale_subsample
    if sub > 1 and event_ndim >= 2:
        r_est = residuals_sq[..., ::sub, ::sub]
        v_est = validf[..., ::sub, ::sub]
    else:
        r_est, v_est = residuals_sq, validf

    def total(x):
        return torch.sum(x, dim=axes) if axes else torch.sum(x)

    count = torch.clamp(total(v_est), min=1.0)
    denom = count if cfg.normalize_scale else torch.ones_like(count)
    if init_lambda is None:
        lam = torch.full(
            batch_shape, 1.0 / (cfg.initial_sigma**2), dtype=torch.float32,
            device=residuals_sq.device,
        )
    else:
        lam = torch.broadcast_to(init_lambda, batch_shape)

    def fixed_point(lam):
        sigma_sq = total(v_est * r_est * (dof + 1.0) / (dof + r_est * lam[expand])) / denom
        return 1.0 / torch.clamp(sigma_sq, min=1e-20)

    if cfg.unroll_iterations is not None:
        for _ in range(cfg.unroll_iterations):
            lam = fixed_point(lam)
    else:
        done = torch.zeros(batch_shape, dtype=torch.bool, device=lam.device)
        it = 0
        while it < cfg.max_iterations and bool(torch.any(~done)):
            new_lam = torch.where(done, lam, fixed_point(lam))
            done = done | (torch.abs(new_lam - lam) < cfg.tolerance)
            lam = new_lam
            it += 1
    weights = validf * (dof + 1.0) / (dof + residuals_sq * lam[expand])
    return weights, lam


def huber_weights(
    residuals_sq: torch.Tensor, valid: torch.Tensor, delta: float = 4.0
) -> torch.Tensor:
    """Huber IRLS weights: 1 inside |r| <= delta, delta/|r| outside, zero
    where invalid."""
    r = torch.sqrt(torch.clamp(residuals_sq, min=1e-20))
    # A true division (``delta / r`` would multiply by r's reciprocal).
    w = torch.where(r <= delta, torch.ones_like(r), torch.full_like(r, delta) / r)
    return valid.to(torch.float32) * w


def weighted_error(
    residuals_sq: torch.Tensor, weights: torch.Tensor, valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean weighted squared error over the valid pixels -> (error, count)."""
    count = torch.sum(valid.to(torch.float32))
    return torch.sum(weights * residuals_sq) / torch.clamp(count, min=1.0), count
