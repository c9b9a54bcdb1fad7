"""The port's rigid fits and RANSAC against the JAX package's, on the CPU.

- ``fit_rigid_svd`` and ``fit_rigid_quat`` on the cases of
  ``tests/unit/test_rigid.py`` (identity, a known motion, the near-planar
  cloud that tempts SVD into a reflection, zero-weighted outliers, noise,
  collinear points, a batch of 4): transforms and RMSE within 1e-5, equal
  validity flags.
- ``ransac_rigid`` fed the JAX package's minimal samples (drawn with its own
  key, :func:`jax_sample_indices`): equal inlier masks, counts and best
  hypothesis, the consensus fit within 1e-5, with and without a sample mask,
  and with fewer valid rows than a sample (no raise, the fit rejected).
- The confidence formula gives the JAX package's counts exactly; the
  port's ranking keeps ``jax.lax.top_k``'s order among ties; the port's own
  sampler (Gumbel top-k on a CPU ``torch.Generator``) draws distinct rows of
  the mask, repeats from its seed, and takes the first massless rows when
  the mask has too few, as ``jax.random.choice`` does.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.utils import ransac as transac
from dense_visual_odometry_torch.utils import rigid as trigid
from dense_visual_odometry_tpu.utils import ransac as jransac
from dense_visual_odometry_tpu.utils import rigid as jrigid
from dense_visual_odometry_tpu.utils.lie import se3 as jse3

ATOL = 1e-5
FITS = {"svd": (jax.jit(jrigid.fit_rigid_svd), trigid.fit_rigid_svd),
        "quat": (jax.jit(jrigid.fit_rigid_quat), trigid.fit_rigid_quat)}


@partial(jax.jit, static_argnums=(2, 3))
def _jax_indices(key, mask, hypotheses, sample_size):
    n = mask.shape[0]
    raw = mask.astype(jnp.float32)
    total = jnp.sum(raw)
    probs = jnp.where(total > 0.0, raw / jnp.maximum(total, 1.0), 1.0 / n)
    return jax.vmap(lambda k: jax.random.choice(
        k, n, shape=(sample_size,), replace=False, p=probs))(jax.random.split(key, hypotheses))


@partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_indices_unmasked(key, n, hypotheses, sample_size):
    return jax.vmap(lambda k: jax.random.choice(k, n, shape=(sample_size,), replace=False))(
        jax.random.split(key, hypotheses))


def jax_sample_indices(key, mask, hypotheses: int, sample_size: int = 4, n=None):
    """The minimal samples ``jax.random.choice`` draws inside the JAX
    package's ``ransac_rigid`` from ``key`` (its ``sample_mask`` as a
    numpy or torch bool array, or None for ``n`` unmasked rows) -> (H, s)
    int64 tensor."""
    if mask is None:
        idx = _jax_indices_unmasked(key, n, hypotheses, sample_size)
    else:
        mask = mask.cpu().numpy() if isinstance(mask, torch.Tensor) else np.asarray(mask)
        idx = _jax_indices(key, jnp.asarray(mask), hypotheses, sample_size)
    return torch.tensor(np.asarray(idx), dtype=torch.int64)


def _transform(rng, scale=0.5):
    xi = rng.normal(size=6).astype(np.float32) * scale
    return np.asarray(jax.jit(jse3.exp)(jnp.asarray(xi)), np.float64)


def _cloud(rng, n=50):
    return rng.normal(size=(n, 3)).astype(np.float32) * 2.0


def _moved(pts, t):
    return (pts @ t[:3, :3].T + t[:3, 3]).astype(np.float32)


def fit_cases():
    """-> {name: (src, dst, weights or None)} of ``test_rigid.py``."""
    rng = np.random.default_rng(0)
    cases = {}
    pts = _cloud(rng)
    cases["identity"] = (pts, pts, None)
    pts = _cloud(rng)
    cases["known"] = (pts, _moved(pts, _transform(rng)), None)
    r5 = np.random.default_rng(5)
    pts = r5.normal(size=(30, 3)).astype(np.float32)
    pts[:, 2] *= 0.01
    cases["reflection"] = (pts, _moved(pts, _transform(r5)), None)
    pts = _cloud(rng)
    moved = _moved(pts, _transform(rng))
    moved[:5] += 10.0
    w = np.ones(len(pts), np.float32)
    w[:5] = 0.0
    cases["weighted"] = (pts, moved, w)
    pts = _cloud(rng, n=200)
    cases["noise"] = (pts, _moved(pts, _transform(rng))
                      + rng.normal(size=pts.shape).astype(np.float32) * 0.01, None)
    line = np.linspace(0, 1, 20, dtype=np.float32)[:, None] * np.array([[1.0, 0, 0]], np.float32)
    cases["collinear"] = (line, line + 1.0, None)
    pts = np.stack([_cloud(rng) for _ in range(4)])
    ts = np.stack([_transform(rng) for _ in range(4)])
    moved = np.einsum("bij,bnj->bni", ts[:, :3, :3], pts) + ts[:, None, :3, 3]
    cases["batched"] = (pts, moved.astype(np.float32), None)
    return cases


CASES = fit_cases()


@pytest.mark.parametrize("fit", sorted(FITS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_matches_jax(fit, case):
    src, dst, w = CASES[case]
    jfit, tfit = FITS[fit]
    j = jfit(jnp.asarray(src), jnp.asarray(dst), None if w is None else jnp.asarray(w))
    t = tfit(torch.tensor(src), torch.tensor(dst), None if w is None else torch.tensor(w))
    np.testing.assert_allclose(t.transform.numpy(), np.asarray(j.transform), atol=ATOL)
    np.testing.assert_allclose(t.rmse.numpy(), np.asarray(j.rmse), atol=ATOL)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    if case == "reflection":
        assert np.linalg.det(t.transform.numpy()[:3, :3]) == pytest.approx(1.0, abs=1e-4)
    if case == "collinear" and fit == "svd":
        assert not bool(t.valid)  # rank-deficient covariance


def _outlier_scene(seed=1, n=100, n_out=30):
    rng = np.random.default_rng(seed)
    pts = _cloud(rng, n=n)
    t = _transform(rng)
    moved = _moved(pts, t)
    moved[:n_out] = rng.normal(size=(n_out, 3)).astype(np.float32) * 5.0
    return pts, moved, t


def _ransac_pair(src, dst, key, mask=None, weights=None, hypotheses=64, threshold=0.05):
    j = jax.jit(lambda k, s, d, m, w: jransac.ransac_rigid(
        k, s, d, threshold=threshold, num_hypotheses=hypotheses, weights=w,
        sample_mask=m))(key, jnp.asarray(src), jnp.asarray(dst),
                        None if mask is None else jnp.asarray(mask),
                        None if weights is None else jnp.asarray(weights))
    idx = jax_sample_indices(key, mask, hypotheses, n=len(src))
    t = transac.ransac_rigid(
        torch.tensor(src), torch.tensor(dst), sample_indices=idx, threshold=threshold,
        weights=None if weights is None else torch.tensor(weights),
        sample_mask=None if mask is None else torch.tensor(mask))
    return j, t


def _assert_same_ransac(j, t):
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    assert int(t.inlier_count) == int(j.inlier_count)
    assert int(t.best_hypothesis) == int(j.best_hypothesis)
    assert bool(t.fit.valid) == bool(j.fit.valid)
    np.testing.assert_allclose(t.fit.transform.numpy(), np.asarray(j.fit.transform), atol=ATOL)
    np.testing.assert_allclose(t.fit.rmse.numpy(), np.asarray(j.fit.rmse), atol=ATOL)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_ransac_matches_jax(masked):
    """The outlier scene of ``test_rigid.py`` (30 of 100 rows gross outliers);
    masked: 20 more rows out of the sample, confidence weights."""
    src, dst, t_true = _outlier_scene()
    mask = weights = None
    if masked:
        mask = np.ones(len(src), bool)
        mask[30:50] = False
        weights = np.random.default_rng(2).uniform(0.5, 1.0, len(src)).astype(np.float32)
    j, t = _ransac_pair(src, dst, jax.random.key(0), mask, weights)
    _assert_same_ransac(j, t)
    assert bool(t.fit.valid) and int(t.inlier_count) >= 60
    assert not t.inliers.numpy()[:30].any()
    np.testing.assert_allclose(t.fit.transform.numpy(), t_true, atol=1e-3)


def test_ransac_with_too_few_valid_rows():
    """Two valid rows for samples of 4: neither package raises, and both
    reject the fit (the JAX package samples the first massless rows)."""
    src, dst, _ = _outlier_scene(seed=3, n=40, n_out=0)
    mask = np.zeros(len(src), bool)
    mask[[7, 21]] = True
    j, t = _ransac_pair(src, dst, jax.random.key(4), mask, hypotheses=16)
    _assert_same_ransac(j, t)
    gen = torch.Generator().manual_seed(0)
    own = transac.ransac_rigid(torch.tensor(src), torch.tensor(dst), generator=gen,
                               num_hypotheses=16, sample_mask=torch.tensor(mask))
    assert own.fit.transform.shape == (4, 4)


@pytest.mark.parametrize("confidence, sample_size, ratio", [
    (0.99, 4, 0.5), (0.99, 3, 1.0), (0.95, 4, 0.3), (0.999, 3, 0.7), (0.5, 1, 0.9),
    (0.99, 8, 0.05), (0.9, 4, 0.0)])
def test_confidence_formula_is_exact(confidence, sample_size, ratio):
    assert transac.max_samples_by_confidence(confidence, sample_size, ratio) == \
        jransac.max_samples_by_confidence(confidence, sample_size, ratio)
    assert transac.max_samples_by_confidence(0.99, 4, 0.5) == 72


def test_ranking_keeps_jax_tie_order():
    """``first_top_k`` on ties: ``jax.lax.top_k``'s order, where
    ``torch.topk`` keeps none."""
    rng = np.random.default_rng(0)
    arrays = [np.array([0, 1, 1, 0, 2, 1, 0], np.float32),
              rng.integers(0, 4, size=300).astype(np.float32),
              np.where(rng.uniform(size=200) < 0.5, -np.inf, 1.0).astype(np.float32)]
    for a in arrays:
        for k in (1, 5, len(a)):
            want = np.asarray(jax.lax.top_k(jnp.asarray(a), k)[1])
            np.testing.assert_array_equal(transac.first_top_k(torch.tensor(a), k).numpy(), want)


def test_gumbel_sampler():
    """The port's own draw: distinct rows of the mask, one seed one draw,
    and the first massless rows after the masked ones when too few."""
    mask = torch.zeros(50, dtype=torch.bool)
    mask[::3] = True
    probs = transac.sample_probabilities(mask, 50, "cpu")
    draw = [transac.gumbel_samples(probs, 64, 4, torch.Generator().manual_seed(7))
            for _ in range(2)]
    assert torch.equal(draw[0], draw[1])
    idx = draw[0]
    assert idx.shape == (64, 4)
    assert bool(mask[idx].all())
    assert all(len(set(row.tolist())) == 4 for row in idx)
    few = torch.zeros(50, dtype=torch.bool)
    few[[9, 30]] = True
    idx = transac.gumbel_samples(transac.sample_probabilities(few, 50, "cpu"), 8, 4,
                                 torch.Generator().manual_seed(1))
    for row in idx.tolist():
        assert sorted(row[:2]) == [9, 30] and row[2:] == [0, 1]
    # An empty mask samples uniformly over every row.
    none = transac.sample_probabilities(torch.zeros(10, dtype=torch.bool), 10, "cpu")
    assert torch.allclose(none, torch.full((10,), 0.1))


def _svd_cases():
    rng = np.random.default_rng(11)
    a = rng.normal(size=(64, 3, 3)).astype(np.float32)
    rank2 = a.copy()
    rank2[:, :, 2] = rank2[:, :, 0] + 0.5 * rank2[:, :, 1]
    rank1 = np.einsum("bi,bj->bij", rng.normal(size=(8, 3)), rng.normal(size=(8, 3)))
    close = np.einsum("bij,j,bkj->bik", np.linalg.qr(rng.normal(size=(8, 3, 3)))[0],
                      np.array([1.0, 1.0 - 1e-6, 1e-3]), np.linalg.qr(rng.normal(size=(8, 3, 3)))[0])
    return {"random": a, "rank2": rank2, "rank1": rank1.astype(np.float32),
            "close": close.astype(np.float32), "zero": np.zeros((2, 3, 3), np.float32),
            "diagonal": np.diag([3.0, 0.0, 0.0]).astype(np.float32)}


@pytest.mark.parametrize("case", sorted(_svd_cases()))
def test_svd3(case):
    """The Kabsch fit's one-sided Jacobi SVD: orthonormal U and V, U diag(s)
    V^T the input within float32 rounding, singular values descending and
    within 1e-6 of LAPACK's (float64) relative to the largest."""
    a = _svd_cases()[case]
    u, s, v = trigid.svd3(torch.tensor(a))
    u, s, v = u.numpy(), s.numpy(), v.numpy()
    eye = np.broadcast_to(np.eye(3), u.shape)
    np.testing.assert_allclose(np.swapaxes(u, -1, -2) @ u, eye, atol=2e-6)
    np.testing.assert_allclose(np.swapaxes(v, -1, -2) @ v, eye, atol=2e-6)
    scale = max(float(np.abs(a).max()), 1e-30)
    np.testing.assert_allclose(np.einsum("...ik,...k,...jk->...ij", u, s, v), a,
                               atol=2e-6 * scale)
    ref = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(s, ref, atol=1e-6 * scale)
    assert np.all(np.diff(s, axis=-1) <= 0)
