"""``track_pair`` of the port against the JAX package on
``configs/reference_default.json``: the reference-semantics tier.

Exact gradients (the current image's Sobel gradients sampled bilinearly at
the warp), the "plain" evaluation at every level, the Gauss-Newton loop
with the reference's stopping rules, and the convergence-checked IRLS
scale.  Held against the JAX package on the hard and easy batches of
``test_torch_track.py``, and on the first 10 pairs of the reference
oracle's ``trajectory_scale_exact`` sequence (60x80 synthetic frames,
``tests/reference_oracle/make_goldens.py``) under its reference-semantics
configuration (``make_goldens.ours_config``).  The Gauss-Newton loop stops
on an absolute tolerance, so the iteration counts are held to the gaps
measured in ``ITER_GAPS`` (``test_torch_track_accurate.ITER_GAPS`` says
why; ``test_torch_stopping_quantum.py`` pins it on level 1 of the easy
batch).
"""

import numpy as np
import pytest

from dense_visual_odometry_torch.camera import CameraModel as TCamera
from dense_visual_odometry_torch.config import RobustDVOConfig as TConfig
from dense_visual_odometry_torch.config import TWeighterConfig as TWConfig
from dense_visual_odometry_torch.models import robust as trobust
from tests.reference_oracle import make_goldens as mg
from tests.test_torch_track import BATCHES, jax_track, scene, tier_configs  # noqa: F401
from tests.test_torch_track_accurate import check_track

ATOL = 1e-5
# Measured, per level (3 to 0), port against the JAX package.
ITER_GAPS = {
    "easy": 2,  # [4, 3, 13, 18] against [4, 3, 15, 17]
    "hard": 2,  # [4, 4, 13, 19] against [4, 4, 13, 17]
}
# trajectory_scale_exact: the pairs (0-based) that stop at other points of a
# flat valley, with their measured transform gaps: 2.2e-4, 9.8e-5, 1.6e-4
# and 1.2e-4; the other six agree within ATOL.
PLATEAU_PAIRS = (3, 4, 6, 8)
PLATEAU_ATOL = 2.5e-4


@pytest.fixture(scope="module")
def reference_tier(scene):  # noqa: F811
    jcfg, tcfg = tier_configs("reference_default")
    return tcfg, jax_track(scene, jcfg)


@pytest.mark.parametrize("batch", list(BATCHES))
def test_track_pair_matches_jax(scene, reference_tier, batch, monkeypatch):  # noqa: F811
    tcfg, ref = reference_tier
    routes = check_track(scene, tcfg, ref[batch], batch, monkeypatch,
                         iter_slack=ITER_GAPS[batch])
    assert routes.cascade() == {lv: {"gn", "plain"} for lv in range(4)}
    assert not routes.retracked


def port_config(case_cfg: dict) -> TConfig:
    """The port's twin of ``make_goldens.ours_config``."""
    return TConfig(
        levels=case_cfg["levels"],
        use_weighter=case_cfg["use_weighter"],
        max_increased_steps_allowed=case_cfg["max_increased_steps_allowed"],
        sigma=case_cfg["sigma"],
        tolerance=case_cfg["tolerance"],
        max_iterations=case_cfg["max_iterations"],
        approximate_image2_gradient=case_cfg["approximate_image2_gradient"],
        raw_sobel_gain=True,
        reference_prior_energy=case_cfg["sigma"] is not None,
        weighter=TWConfig(normalize_scale=False, warm_start=False),
    )


def run_port_case(case_cfg: dict, n_frames: int, source: str) -> dict:
    """The port's twin of ``make_goldens.run_ours_case`` on the CPU:
    consecutive pairs, each anchored at the previous pair's transform."""
    frames, k, scale = mg.load_synthetic_frames(n_frames, mode=source)
    cam = TCamera.create(k, scale)
    cfg = port_config(case_cfg)
    fds = [
        trobust.preprocess_frame(
            gray.astype(np.float32), depth, cam, levels=cfg.levels,
            max_distance=cfg.max_distance, device="cpu",
        )
        for gray, depth in frames
    ]

    def batch1(f):
        return trobust.FrameData(tuple(g[None] for g in f.gray), tuple(d[None] for d in f.depth_m))

    transforms, iters, last = [], [], None
    for n in range(1, len(fds)):
        r = trobust.track_pair(batch1(fds[n - 1]), batch1(fds[n]), cam, cfg, last_transform=last)
        transforms.append(r.transform[0].numpy().astype(np.float64))
        iters.append(r.diagnostics.iterations.tolist())
        last = r.transform
    return {"transforms": np.stack(transforms), "iters": iters}


def test_trajectory_scale_exact_matches_jax():
    """The first 10 pairs of ``trajectory_scale_exact``.

    At this 60x80 scale the Gauss-Newton loop stops on plateaus where float32
    resolves the error no finer than the tolerance (the reference parity
    tests make the same observation against the original solver), so the
    two packages take different numbers of iterations on eight of the ten
    pairs, and four of them (``PLATEAU_PAIRS``) stop at different points of
    a flat valley.  Held: every other pair's transform within 1e-5, the
    plateau pairs' within ``PLATEAU_ATOL``, and the same iteration counts
    on the first and the last pair."""
    case_cfg = dict(mg.CASES[[c[0] for c in mg.CASES].index("trajectory_scale_exact")][3])
    port = run_port_case(case_cfg, 11, "traj")
    jax_run = mg.run_ours_case(case_cfg, 0, 11, "traj")
    gaps = np.abs(port["transforms"] - jax_run["transforms"]).reshape(10, -1).max(axis=1)
    bounds = np.where(np.isin(np.arange(10), PLATEAU_PAIRS), PLATEAU_ATOL, ATOL)
    assert (gaps < bounds).all(), gaps
    assert port["iters"][0] == jax_run["iters"][0]
    assert port["iters"][9] == jax_run["iters"][9]
