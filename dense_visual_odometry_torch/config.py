"""Typed configuration for the tracking solvers (the port's own copy).

Field for field the same knobs, defaults and validations as
``dense_visual_odometry_tpu/config.py``, whose comments give each knob's
rationale, so both packages read the shipped ``configs/*.json`` verbatim.
A frozen dataclass; ``from_dict`` accepts the reference JSON schema
(``method``, ``use_gpu``, ``height`` and ``width`` are ignored) with the
weighter hyper-parameters as a nested dict.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TWeighterConfig:
    """t-distribution IRLS scale estimation."""

    dof: float = 5.0
    initial_sigma: float = 5.0
    tolerance: float = 1e-3
    max_iterations: int = 50
    # Kerl's sigma^2 fixed point divides by N; False drops the 1/N like
    # the original implementation.
    normalize_scale: bool = True
    # Estimate the scale from every Nth pixel in each direction (the
    # weights themselves are always computed at full resolution).
    scale_subsample: int = 1
    # Warm-start the fixed point from the previous evaluation's lambda.
    warm_start: bool = True
    # Exactly N fixed-point steps instead of the convergence-checked loop.
    unroll_iterations: Optional[int] = None

    def __post_init__(self):
        if self.scale_subsample < 1:
            raise ValueError("scale_subsample must be >= 1")
        if self.unroll_iterations is not None and self.unroll_iterations < 1:
            raise ValueError("unroll_iterations must be >= 1 or None")


@dataclasses.dataclass(frozen=True)
class RobustDVOConfig:
    """Coarse-to-fine photometric Gauss-Newton / LM tracking configuration."""

    levels: int = 4
    use_weighter: bool = False
    max_increased_steps_allowed: int = 0
    sigma: Optional[float] = None  # motion-prior strength (None = no prior)
    tolerance: float = 1e-6
    max_iterations: int = 100
    # Per-level iteration caps indexed by pyramid level (0 = finest).
    max_iterations_per_level: Optional[Tuple[int, ...]] = None
    # Relative stopping rule; None disables.
    relative_tolerance: Optional[float] = None
    # Precomputed (inverse-compositional) Jacobian from the template.
    approximate_image2_gradient: bool = False
    max_distance: float = 5.0
    weighter: TWeighterConfig = dataclasses.field(default_factory=TWeighterConfig)
    quantize_intensity: bool = False
    # Seed each solve with the last accepted frame-to-frame transform.
    constant_velocity_init: bool = False
    # Sample image taps through f16-packed neighbour pairs.
    packed_sampling: bool = False
    finest_stride: int = 1
    # Per-level residual-grid strides; overrides finest_stride when set.
    grid_strides: Optional[Tuple[int, ...]] = None
    # Frozen-window ("shift ball") sampling radius and the levels using it.
    shift_stack_radius: Optional[int] = None
    shift_stack_levels: Tuple[int, ...] = (0,)
    use_pallas_stack: bool = False
    # Hard-motion fallback to the gather path, and its three triggers.
    shift_stack_fallback: bool = False
    shift_fallback_min_coverage: float = 0.8
    fallback_max_displacement: float = 3.0
    fallback_max_rotation: float = 0.03
    # Scale-gated retrack of elements whose finest-level sigma exceeds this.
    retrack_max_scale: Optional[float] = None
    # Relative-tolerance factor for (element, level) pairs that start hard.
    fallback_tolerance_scale: float = 0.1
    # Score {identity, init guess} at the coarsest level and keep the best.
    robust_init_selection: bool = False
    init_scale_ladder: Optional[Tuple[float, ...]] = None
    # One fused evaluation kernel per iteration at the shift-stack levels.
    use_fused_iteration: bool = False
    # Extract the frozen window once per level at its starting estimate.
    freeze_shift_window: bool = False
    # Levenberg-Marquardt mode (None = Gauss-Newton).
    lm_lambda0: Optional[float] = None
    lm_up: float = 4.0
    lm_down: float = 0.5
    lm_lambda_max: float = 1e5
    # Whole per-level LM loop in one kernel launch.
    use_level_kernel: bool = False
    # Per-row-block / per-tile recentering of the frozen window.
    recenter_blocks: Optional[int] = None
    recenter_col_blocks: Optional[int] = None
    recenter_center_bound: Optional[int] = None
    shift_stack_radius_y: Optional[int] = None
    # ESM gradient averaging and the levels it applies to.
    use_esm_gradients: bool = False
    esm_levels: Optional[Tuple[int, ...]] = None
    esm_fallback_max_rotation: Optional[float] = None
    # Geometric (depth) residual term.
    use_depth_residuals: bool = False
    depth_weight: float = 1.0e4
    depth_huber_delta: float = 0.03
    # None, "bias" (rank-1 Schur) or "affine" (rank-2 Schur).
    illumination: Optional[str] = None
    # Reference-parity quirk modes.
    raw_sobel_gain: bool = False
    reference_prior_energy: bool = False

    def stride_for_level(self, level: int) -> int:
        if self.grid_strides is not None:
            return self.grid_strides[level]
        return self.finest_stride if level == 0 else 1

    def max_iterations_for_level(self, level: int) -> int:
        if self.max_iterations_per_level is not None:
            return self.max_iterations_per_level[level]
        return self.max_iterations

    def __post_init__(self):
        if self.levels < 1:
            raise ValueError(f"levels must be >= 1, got {self.levels}")
        if self.max_iterations < 1:
            raise ValueError("max_iterations must be >= 1")
        if self.max_iterations_per_level is not None:
            object.__setattr__(
                self, "max_iterations_per_level",
                tuple(int(n) for n in self.max_iterations_per_level),
            )
            if len(self.max_iterations_per_level) != self.levels:
                raise ValueError(
                    "max_iterations_per_level length must equal levels"
                )
            if any(n < 1 for n in self.max_iterations_per_level):
                raise ValueError(
                    "max_iterations_per_level entries must be >= 1"
                )
        if self.sigma is not None and self.sigma <= 0:
            raise ValueError("sigma must be positive or None")
        if self.finest_stride < 1:
            raise ValueError("finest_stride must be >= 1")
        if self.lm_lambda0 is not None and self.lm_lambda0 <= 0:
            raise ValueError("lm_lambda0 must be positive or None")
        if self.lm_up <= 1.0 or not (0.0 < self.lm_down < 1.0):
            raise ValueError("need lm_up > 1 and 0 < lm_down < 1")
        if self.illumination not in (None, "bias", "affine"):
            raise ValueError("illumination must be None, 'bias' or 'affine'")
        if self.recenter_blocks is not None:
            if self.recenter_blocks < 1:
                raise ValueError("recenter_blocks must be >= 1 or None")
            if self.recenter_blocks > 1:
                if not self.use_level_kernel:
                    raise ValueError(
                        "recenter_blocks > 1 requires use_level_kernel "
                        "(per-block centers are a level-solver feature)"
                    )
                if self.use_esm_gradients:
                    raise ValueError(
                        "recenter_blocks is incompatible with "
                        "use_esm_gradients (the ESM warped image assumes "
                        "a single frozen window center)"
                    )
        if self.recenter_col_blocks is not None:
            if self.recenter_col_blocks < 1:
                raise ValueError(
                    "recenter_col_blocks must be >= 1 or None"
                )
            if self.recenter_col_blocks > 1:
                if self.recenter_blocks is None:
                    raise ValueError(
                        "recenter_col_blocks requires recenter_blocks "
                        "(the row-block count of the tile grid; 1 is "
                        "a valid row count)"
                    )
                if not self.use_level_kernel:
                    raise ValueError(
                        "recenter_col_blocks > 1 requires "
                        "use_level_kernel (per-tile centers are a "
                        "level-solver feature)"
                    )
                if self.use_esm_gradients:
                    raise ValueError(
                        "recenter_col_blocks is incompatible with "
                        "use_esm_gradients (the ESM warped image "
                        "assumes a single frozen window center)"
                    )
        if self.recenter_center_bound is not None:
            if self.recenter_col_blocks is None or self.recenter_col_blocks < 2:
                raise ValueError(
                    "recenter_center_bound requires recenter_col_blocks "
                    "> 1 (it parameterizes the tile path)"
                )
            if self.recenter_center_bound < 1:
                raise ValueError("recenter_center_bound must be >= 1")
        if self.shift_stack_radius_y is not None:
            if self.recenter_blocks is None or self.recenter_blocks < 2:
                raise ValueError(
                    "shift_stack_radius_y requires recenter_blocks > 1 "
                    "(the anisotropic ball is a block-path feature)"
                )
            if self.shift_stack_radius_y < 1:
                raise ValueError("shift_stack_radius_y must be >= 1")
            if (
                self.shift_stack_radius is not None
                and self.shift_stack_radius_y > self.shift_stack_radius
            ):
                raise ValueError(
                    "shift_stack_radius_y must not exceed "
                    "shift_stack_radius (vertical recentering shrinks "
                    "the vertical radius, never grows it)"
                )
        if self.init_scale_ladder is not None:
            object.__setattr__(
                self, "init_scale_ladder", tuple(self.init_scale_ladder)
            )
            if not self.robust_init_selection:
                raise ValueError(
                    "init_scale_ladder requires robust_init_selection "
                    "(the ladder extends the warm-start selector)"
                )
        if self.use_esm_gradients:
            if not self.approximate_image2_gradient:
                raise ValueError(
                    "use_esm_gradients requires approximate_image2_gradient "
                    "(ESM averages the precomputed template gradient with "
                    "the level-start warped gradient)"
                )
            if self.use_fused_iteration and not self.freeze_shift_window:
                raise ValueError(
                    "use_esm_gradients with use_fused_iteration requires "
                    "freeze_shift_window (the warped image is derived from "
                    "the frozen window planes)"
                )
        if self.grid_strides is not None:
            # JSON gives a list; coerce so the config stays hashable.
            object.__setattr__(self, "grid_strides", tuple(self.grid_strides))
            if len(self.grid_strides) != self.levels:
                raise ValueError("grid_strides length must equal levels")
            if any(s < 1 for s in self.grid_strides):
                raise ValueError("grid_strides entries must be >= 1")
        object.__setattr__(
            self, "shift_stack_levels", tuple(self.shift_stack_levels)
        )
        if self.esm_levels is not None:
            object.__setattr__(self, "esm_levels", tuple(self.esm_levels))

    @classmethod
    def from_dict(cls, data: dict) -> "RobustDVOConfig":
        """Build from a reference-style JSON config dict."""
        data = dict(data)
        for ignored in ("use_gpu", "height", "width", "method"):
            data.pop(ignored, None)
        wdata = data.pop("weighter", None)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        if wdata is not None:
            data["weighter"] = (
                wdata if isinstance(wdata, TWeighterConfig) else TWeighterConfig(**wdata)
            )
        return cls(**data)

    @classmethod
    def from_json(cls, path) -> "RobustDVOConfig":
        with Path(path).open("r") as fp:
            return cls.from_dict(json.load(fp))
