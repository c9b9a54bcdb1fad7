"""The port's dense BA against the JAX package's, on the CPU.

The scenes are ``tests/unit/test_dense_ba.py``'s 48x64 textured planes at
2 m, the camera stepping 2 cm in x, with a seeded perturbation of every
pose but the first (translations of scale 4 mm, rotations of scale 0.01
rad).

- Point rows: the JAX package differentiates each point residual by
  reverse-mode AD at zero perturbation; its rotation columns come out NaN
  (``sqrt`` at theta = 0) and are zeroed (``dense_ba.py:200-202``).  The
  port's rows equal them: rotation columns exactly 0, the rest within 1e-5
  of each column's largest magnitude (float32 sums in another order).
- A clip tie: with fx = 64, cx = 32, a depth of 2 m and identical poses,
  grid column 0 projects exactly onto u = 0 of its target, where
  ``jnp.clip`` gives the derivative 0.5; the port's rows there equal the
  JAX package's.
- The reduced system within 1e-5 of each array's scale (b and gd also
  within the residuals' rounding, see the test); ``optimize_dense_ba``
  poses within 1e-5, inverse depths and chi2 within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.models import dense_ba as tba
from dense_visual_odometry_tpu.models import dense_ba as jba
from tests.unit.test_dense_ba import K_MAT, _planar_sequence
from tests.test_torch_slam import one_torch_thread  # noqa: F401  (autouse)

ITERS = 4
STRIDES = (4, 3)  # grid strides of the two data sets


def _rot(rng, scale):
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(rng.normal(size=3) * scale).as_matrix()


def _problem(k=4, stride=4, k_mat=K_MAT, tx=0.02, perturb=True, seed=0):
    grays, depths, gt = _planar_sequence(k, tx=tx)
    poses = gt.copy()
    if perturb:
        rng = np.random.default_rng(seed)
        for t in range(1, k):
            poses[t, :3, 3] += rng.normal(size=3) * 0.004
            poses[t, :3, :3] = _rot(rng, 0.01) @ poses[t, :3, :3]
    jd = jba.build_dense_ba_data(grays, depths, k_mat, grid_stride=stride)
    td = tba.build_dense_ba_data(grays, depths, k_mat, grid_stride=stride, device="cpu")
    return poses.astype(np.float32), jd, td


def _shard(jd, poses):
    k = poses.shape[0]
    return jba._ShardData(
        images=jd.images, intensity=jd.intensity, inv_depth0=jd.inv_depth0,
        inv_depth_current=jd.inv_depth0, valid=jd.valid, grid_u=jd.grid_u,
        grid_v=jd.grid_v, targets=jd.targets, target_valid=jd.target_valid,
        intrinsics=jd.intrinsics, owner_poses=jnp.asarray(poses),
        owner_index=jnp.arange(k, dtype=jnp.int32))


def _port_rows(poses, td):
    """The port's per-point terms as ``_jax_rows`` gives the JAX package's:
    rows (K, M, P, 13) [d_i | d_j | d_rho], r, w (K, M, P)."""
    r, w, gi, gj, grho = tba.point_terms(torch.tensor(poses), td.inv_depth0, td,
                                         tba.DenseBAConfig())
    return torch.cat([gi, gj, grho[..., None]], dim=-1), r, w


@jax.jit
def _jax_terms(poses, shard):
    """The JAX package's ``_owner_terms`` over every owner (jitted once)."""
    return jax.vmap(lambda op, tr, tv, it, rh, vr: jba._owner_terms(
        op, tr, tv, poses, shard.images, it, rh, vr, shard.grid_u, shard.grid_v,
        shard.intrinsics, jba.DenseBAConfig()))(
        shard.owner_poses, shard.targets, shard.target_valid, shard.intensity,
        shard.inv_depth_current, shard.valid)


@jax.jit
def _jax_reduced(poses, shard):
    return jba._build_reduced_system(poses, shard.inv_depth_current, shard,
                                     jba.DenseBAConfig(), poses.shape[0])


def _jax_rows(poses, jd):
    """The JAX package's per-point terms: r, w (K, M, P), rows (K, M, P, 13)."""
    r, w, gi, gj, grho = (np.asarray(x) for x in _jax_terms(jnp.asarray(poses),
                                                             _shard(jd, poses)))
    return r, w, np.concatenate([gi, gj, grho[..., None]], axis=-1)


@pytest.mark.parametrize("stride", STRIDES)
def test_data_matches_jax(stride):
    _, jd, td = _problem(stride=stride)
    for name in jd._fields:
        np.testing.assert_array_equal(getattr(td, name).numpy(), np.asarray(getattr(jd, name)),
                                      err_msg=name)


@pytest.mark.parametrize("perturb", [False, True], ids=["truth", "perturbed"])
def test_point_rows_match_jax(perturb):
    poses, jd, td = _problem(perturb=perturb)
    r_j, w_j, rows_j = _jax_rows(poses, jd)
    rows_t, r_t, w_t = _port_rows(poses, td)
    rows_t, r_t, w_t = rows_t.numpy(), r_t.numpy(), w_t.numpy()
    rot = [3, 4, 5, 9, 10, 11]
    np.testing.assert_array_equal(rows_j[..., rot], 0.0)
    np.testing.assert_array_equal(rows_t[..., rot], 0.0)
    scale = np.abs(rows_j).reshape(-1, 13).max(axis=0)
    assert (scale[[0, 1, 2, 6, 7, 8, 12]] > 1.0).all()
    np.testing.assert_allclose(rows_t, rows_j, atol=1e-5 * scale.max())
    for c in range(13):
        np.testing.assert_allclose(rows_t[..., c], rows_j[..., c],
                                   atol=1e-5 * max(scale[c], 1e-6), err_msg=f"column {c}")
    np.testing.assert_allclose(r_t, r_j, atol=1e-5 * np.abs(r_j).max())
    np.testing.assert_allclose(w_t, w_j, rtol=1e-5)


def test_clip_tie_gives_half_the_derivative(monkeypatch):
    """``jnp.clip``'s derivative at either bound is 0.5 (torch.clamp's is
    1): the helper splits it, and points that land exactly on u = 0 or
    v = 0 take the JAX package's rows."""
    x = torch.tensor([-1.0, 0.0, 5.0, 63.0, 64.0])
    np.testing.assert_array_equal(tba.clip_grad(x, 0.0, 63.0).numpy(), [0, 0.5, 1, 0.5, 0])
    g = jax.vmap(jax.grad(lambda u: jnp.clip(u, 0.0, 63.0)))(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(tba.clip_grad(x, 0.0, 63.0).numpy(), np.asarray(g))

    k_mat = np.array([[64.0, 0.0, 32.0], [0.0, 64.0, 24.0], [0.0, 0.0, 1.0]], np.float32)
    grays, depths, _ = _planar_sequence(2, tx=0.0)
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (2, 4, 4)).copy()
    jd = jba.build_dense_ba_data(grays, depths, k_mat, grid_stride=4)
    td = tba.build_dense_ba_data(grays, depths, k_mat, grid_stride=4, device="cpu")
    _, _, rows_j = _jax_rows(poses, jd)
    rows_t, _, _ = _port_rows(poses, td)
    rows_t = rows_t.numpy()
    on_edge = (td.grid_u.numpy() == 0) | (td.grid_v.numpy() == 0)
    assert on_edge.sum() > 20
    edge_j = rows_j[:, 0, on_edge]
    edge_scale = np.abs(edge_j[..., [0, 1, 6, 7]]).max()
    assert edge_scale > 1.0
    np.testing.assert_allclose(rows_t, rows_j, atol=1e-5 * np.abs(rows_j).max())
    # With torch.clamp's derivative (1 at the bounds) those rows part.
    monkeypatch.setattr(tba, "clip_grad",
                        lambda x, lo, hi: ((x >= lo) & (x <= hi)).to(x.dtype))
    rows_one, _, _ = _port_rows(poses, td)
    assert np.abs(rows_one.numpy()[:, 0, on_edge] - edge_j).max() > 0.25 * edge_scale


@pytest.mark.parametrize("perturb", [False, True], ids=["truth", "perturbed"])
def test_reduced_system_matches_jax(perturb):
    poses, jd, td = _problem(perturb=perturb)
    want = _jax_reduced(jnp.asarray(poses), _shard(jd, poses))
    got = tba.build_reduced_system(torch.tensor(poses), td.inv_depth0, td, tba.DenseBAConfig())
    # b and gd are linear in the residuals, which the packages round apart
    # by a few float32 steps of the intensities (r = I_j(warp) - I_i, both
    # up to 255): each entry is held to that rounding times the sum of its
    # terms' |w * J|, not to its own size, which cancels near the truth.
    _, w, rows = _jax_rows(poses, jd)
    eps_r = 4 * float(np.spacing(np.float32(255.0)))
    wg = np.abs(w[..., None] * rows)
    tgt = np.maximum(np.asarray(jd.targets), 0)
    b_terms = wg[..., :6].sum(axis=(1, 2))
    np.add.at(b_terms, tgt, wg[..., 6:12].sum(axis=2))
    slack = {"b": eps_r * b_terms, "gd": eps_r * wg[..., 12].sum(axis=1)}
    for name, g, w in zip(("chi2", "a", "b", "dinv", "gd", "y"), got, want):
        w = np.asarray(w)
        atol = 1e-5 * np.abs(w).max() + slack.get(name, 0.0)
        assert (np.abs(g.numpy() - w) <= atol).all(), name

@pytest.fixture(scope="module")
def optimized():
    """Both packages' ``optimize_dense_ba`` on the perturbed planes (4
    keyframes, window 2) and on 5 keyframes with an explicit target table
    that adds the pair (0, 4)."""
    out = {}
    cfg_j, cfg_t = jba.DenseBAConfig(max_iterations=ITERS), tba.DenseBAConfig(max_iterations=ITERS)
    for name, k, stride, targets in (("window", 4, 4, None),
                                     ("targets", 5, 3, np.array([[1, 4, -1], [0, 2, -1],
                                                                 [1, 3, -1], [2, 4, -1],
                                                                 [0, 3, -1]]))):
        grays, depths, _ = _planar_sequence(k)
        poses, _, _ = _problem(k=k)
        jd = jba.build_dense_ba_data(grays, depths, K_MAT, grid_stride=stride, targets=targets)
        td = tba.build_dense_ba_data(grays, depths, K_MAT, grid_stride=stride, targets=targets,
                                     device="cpu")
        out[name] = (poses, jba.optimize_dense_ba(jnp.asarray(poses), jd, cfg_j),
                     tba.optimize_dense_ba(torch.tensor(poses), td, cfg_t))
    return out


@pytest.mark.parametrize("name", ["window", "targets"])
def test_optimize_matches_jax(optimized, name):
    poses0, want, got = optimized[name]
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), atol=1e-5)
    np.testing.assert_allclose(got.inv_depth.numpy(), np.asarray(want.inv_depth), rtol=1e-4)
    np.testing.assert_allclose(float(got.chi2), float(want.chi2), rtol=1e-4)
    np.testing.assert_allclose(got.chi2_history.numpy(), np.asarray(want.chi2_history), rtol=1e-4)
    # The chi2 falls, and (the reference's rotation columns being 0) no
    # rotation moves in either package.
    assert float(got.chi2) < 0.5 * float(got.chi2_history[0])
    np.testing.assert_array_equal(got.poses.numpy()[:, :3, :3], poses0[:, :3, :3])
    np.testing.assert_array_equal(np.asarray(want.poses)[:, :3, :3], poses0[:, :3, :3])


@pytest.mark.cuda
def test_cuda_matches_cpu():
    """The dense BA on the card against the CPU: poses within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    grays, depths, _ = _planar_sequence(4)
    poses, _, _ = _problem()
    cfg = tba.DenseBAConfig(max_iterations=ITERS)
    out = []
    for dev in ("cpu", "cuda"):
        data = tba.build_dense_ba_data(grays, depths, K_MAT, grid_stride=4, device=dev)
        out.append(tba.optimize_dense_ba(torch.tensor(poses, device=dev), data, cfg))
    np.testing.assert_allclose(out[1].poses.cpu().numpy(), out[0].poses.numpy(), atol=1e-5)
    np.testing.assert_allclose(out[1].inv_depth.cpu().numpy(), out[0].inv_depth.numpy(),
                               rtol=1e-4)


def test_build_takes_the_device_of_its_inputs():
    """Numpy inputs without a device go to the GPU, as every entry point
    does (and raise where there is none); tensor inputs keep their own."""
    grays, depths, _ = _planar_sequence(2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tba.build_dense_ba_data(grays, depths, K_MAT, grid_stride=4)
    data = tba.build_dense_ba_data([torch.as_tensor(g) for g in grays], depths, K_MAT,
                                   grid_stride=4)
    assert data.images.device.type == "cpu" and data.targets.device.type == "cpu"
