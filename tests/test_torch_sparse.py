"""The port's sparse pipeline against the JAX package's, on the CPU.

Inputs: the blocky random texture and the fixed 120x160 camera of
``tests/unit/test_sparse.py`` (its cases: a checkerboard, a flat image, a
pure 5-pixel shift, a 3-pixel shift at 2 m, half the depth invalid, matches
injected from outside, no valid match, a two-frame session), and the seeded
120x160 synthetic scene (``io.synthetic.textured_scene``) rendered along a
hand-held trajectory (``handheld_trajectory``), smooth texture with real
motion.  RANSAC's minimal samples are the JAX package's own: the port is fed
the indices that ``jax.random.choice`` draws from the JAX key of each call
(:func:`jax_sampler`, and :func:`replay_session` for the session's key
chain).

- Harris: the corners are the JAX package's, in its order, apart from
  counted swaps of corners whose scores lie within :data:`HARRIS_ULPS`
  float32 steps of each other (XLA:CPU contracts ``det - kappa * tr^2`` into
  fused multiply-adds, PyTorch does not; measured: none on these cases).
- ``match_patches``, ``track_sparse``, ``fit_from_matches`` and a 5-frame
  ``SparseVO`` session: outputs within :data:`ATOL` (1e-5), equal validity,
  success flags and inlier counts.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.camera import CameraModel as TCamera
from dense_visual_odometry_torch.io import synthetic as tsyn
from dense_visual_odometry_torch.models import sparse as tsparse
from dense_visual_odometry_tpu.camera import CameraModel as JCamera
from dense_visual_odometry_tpu.models import sparse as jsparse
from tests.test_torch_rigid_ransac import jax_sample_indices

ATOL = 1e-5
# Corner swaps allowed where two scores lie this many float32 steps apart.
HARRIS_ULPS = 8
H, W = 120, 160
K = np.array([[120.0, 0.0, (W - 1) / 2], [0.0, 120.0, (H - 1) / 2], [0.0, 0.0, 1.0]],
             dtype=np.float32)
Z0 = 2.0
_SPARSE_VO = tsparse.SparseVO  # the class itself, where a test patches the module's name


def jax_sampler(key):
    """A port sampler that draws what the JAX package's RANSAC draws from
    ``key``."""
    return lambda mask, hypotheses, size: jax_sample_indices(key, mask, hypotheses, size)


def jax_session_keys(seed: int = 0):
    """-> keys(step): the RANSAC key of tracked pair ``step`` in the JAX
    package's ``SparseVO(seed=seed)``, the second half of the ``step + 1``-th
    split of ``jax.random.key(seed)``."""
    subs = []

    def keys(step):
        key = jax.random.key(seed) if not subs else subs[-1][0]
        while len(subs) <= step:
            key, sub = jax.random.split(key)
            subs.append((key, sub))
        return subs[step][1]

    return keys


def replay_session(camera, matcher: str = "zncc", seed: int = 0, swaps=None, **kw):
    """A port ``SparseVO`` on the CPU whose RANSAC draws the samples of the
    JAX package's ``SparseVO(seed=seed)``.  With the learned matcher the two
    packages' coarse selections may rank near-equal confidences apart (their
    probabilities part by rounding: ``test_torch_matcher.P_ATOL``), and
    RANSAC samples rows by rank, so the JAX samples are mapped onto the
    port's rows through ``matcher.selection_order`` against the JAX
    package's selection of the same pair (which must hold the same matches,
    confidences within ``P_ATOL``); the ranks that part are appended to
    ``swaps``."""
    keys = jax_session_keys(seed)
    kw.setdefault("device", "cpu")
    vo = _SPARSE_VO(camera, seed=seed, matcher=matcher, **kw)
    if matcher != "learned":
        vo.sampler = lambda step, mask, h, s: jax_sample_indices(keys(step), mask, h, s)
        return vo
    from dense_visual_odometry_torch.models import matcher as tm
    from dense_visual_odometry_tpu.models import matcher as jm
    from tests.test_torch_matcher import P_ATOL

    params, seen, coarse = jm.load_params(), {}, vo.model.match_coarse

    def recording(g1, g2, **ckw):
        seen["pair"], seen["port"] = (g1, g2), coarse(g1, g2, **ckw)
        seen["kw"] = ckw
        return seen["port"]

    def sampler(step, mask, h, s):
        g1, g2 = (jnp.asarray(g.cpu().numpy()) for g in seen["pair"])
        ref = tsparse.Matches(*(torch.tensor(np.asarray(f))
                                for f in jm.match_coarse(params, g1, g2, **seen["kw"])))
        order = tm.selection_order(ref, seen["port"])
        np.testing.assert_allclose(seen["port"].confidence[order].numpy(),
                                   ref.confidence.numpy(), atol=P_ATOL)
        if swaps is not None:
            swaps.append(int((order != torch.arange(len(order))).sum()))
        return order[jax_sample_indices(keys(step), mask.cpu()[order], h, s)]

    vo.model.match_coarse = recording
    vo.sampler = sampler
    return vo


def _textured(rng):
    base = rng.uniform(50, 200, size=(H // 8, W // 8)).astype(np.float32)
    return np.kron(base, np.ones((8, 8), np.float32))


def smooth_pair(seed=0, frames=2):
    """The seeded synthetic scene along a hand-held trajectory -> (grays,
    depths, intrinsics, poses)."""
    gray, depth, k = tsyn.textured_scene(H, W, seed=seed)
    poses = tsyn.handheld_trajectory(frames, seed=seed)
    grays, depths = tsyn.render_sequence(gray, depth, k, poses)
    return grays, depths, k, poses


def checkerboard():
    img = np.zeros((H, W), np.float32)
    img[: H // 2, : W // 2] = 200.0
    img[H // 2:, W // 2:] = 200.0
    return img


def harris_images():
    rng = np.random.default_rng(0)
    grays = smooth_pair(frames=2)[0]
    return {"checkerboard": (checkerboard(), 16), "flat": (np.zeros((H, W), np.float32), 32),
            "blocky": (_textured(rng), 64), "smooth": (grays[1], 256),
            "smooth_all": (grays[0], 1024)}


def ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def corner_swaps(j_corners, j_scores, t_corners, t_scores) -> int:
    """How many ranks hold another corner in the port than in the JAX
    package; raises unless each such rank's score lies within HARRIS_ULPS
    of a score the JAX package ranks beside it (a tie broken by rounding)."""
    differ = np.nonzero(np.any(j_corners != t_corners, axis=-1))[0]
    finite = np.isfinite(j_scores)
    assert np.array_equal(finite, np.isfinite(t_scores))
    assert ulps(j_scores[finite], t_scores[finite]).max(initial=0) <= HARRIS_ULPS
    for i in differ:
        near = [ulps(j_scores[i], j_scores[n]) for n in (i - 1, i + 1) if 0 <= n < len(j_scores)]
        assert min(near) <= HARRIS_ULPS, f"rank {i} parts without a tie"
    return len(differ)


@pytest.mark.parametrize("case", sorted(harris_images()))
def test_harris_matches_jax(case):
    img, k = harris_images()[case]
    jc, js = jax.jit(lambda g: jsparse.harris_corners(g, k=k))(jnp.asarray(img))
    tc, ts = tsparse.harris_corners(torch.tensor(img), k=k)
    swaps = corner_swaps(np.asarray(jc), np.asarray(js), tc.numpy(), ts.numpy())
    assert swaps == 0, f"{swaps} corners swapped within {HARRIS_ULPS} ulps"
    if case == "checkerboard":
        assert abs(tc[0, 0] - W // 2) < 6 and abs(tc[0, 1] - H // 2) < 6


def _assert_matches(j, t, atol=ATOL):
    for field in ("uv_prev", "uv_curr", "confidence"):
        np.testing.assert_allclose(getattr(t, field).numpy(), np.asarray(getattr(j, field)),
                                   atol=atol, err_msg=field)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))


def patch_cases():
    rng = np.random.default_rng(0)
    img = _textured(rng)
    grays = smooth_pair()[0]
    return {"shift5": (img, np.roll(img, 5, axis=1), 64), "smooth": (grays[0], grays[1], 256)}


@pytest.mark.parametrize("case", sorted(patch_cases()))
def test_match_patches_matches_jax(case):
    prev, curr, k = patch_cases()[case]
    corners = jsparse.harris_corners(jnp.asarray(prev), k=k)[0]
    j = jax.jit(jsparse.match_patches)(jnp.asarray(prev), jnp.asarray(curr), corners)
    t = tsparse.match_patches(torch.tensor(prev), torch.tensor(curr),
                              torch.tensor(np.asarray(corners)))
    _assert_matches(j, t)
    valid = t.valid.numpy()
    assert valid.sum() >= 32
    if case == "shift5":
        med = np.median((t.uv_curr - t.uv_prev).numpy()[valid], axis=0)
        assert abs(med[0] - 5) <= 1 and abs(med[1]) <= 1
    # Recentred search windows (the learned matcher's fine stage).
    centers = np.asarray(corners) + np.float32(2.6)
    j = jax.jit(partial(jsparse.match_patches, search=6, min_zncc=0.5))(
        jnp.asarray(prev), jnp.asarray(curr), corners, centers_curr=jnp.asarray(centers))
    t = tsparse.match_patches(torch.tensor(prev), torch.tensor(curr),
                              torch.tensor(np.asarray(corners)), search=6, min_zncc=0.5,
                              centers_curr=torch.tensor(centers))
    _assert_matches(j, t)


def _assert_result(j, t, atol=ATOL):
    assert bool(t.success) == bool(j.success)
    assert int(t.inlier_count) == int(j.inlier_count)
    np.testing.assert_allclose(t.transform.numpy(), np.asarray(j.transform), atol=atol)
    np.testing.assert_allclose(float(t.rmse), float(j.rmse), atol=atol)


def track_cases():
    rng = np.random.default_rng(0)
    img = _textured(rng)
    flat = np.full((H, W), Z0, np.float32)
    half = flat.copy()
    half[:, : W // 2] = 0.0
    grays, depths, k, _ = smooth_pair()
    return {
        "shift3": ((img, flat, np.roll(img, -3, axis=1), flat, K), {}),
        "half_depth": ((img, half, img, half, K), {}),
        "smooth": ((grays[0], depths[0], grays[1], depths[1], k), {}),
        "smooth_session_defaults": ((grays[0], depths[0], grays[1], depths[1], k),
                                    {"num_corners": 1024, "depth_edge_tol": 0.03}),
        "smooth_no_cycle": ((grays[0], depths[0], grays[1], depths[1], k),
                            {"cycle_tolerance": None}),
    }


@pytest.mark.parametrize("case", sorted(track_cases()))
def test_track_sparse_matches_jax(case):
    arrays, kw = track_cases()[case]
    key = jax.random.key(3)
    j = jax.jit(partial(jsparse.track_sparse, **kw))(key, *(jnp.asarray(a) for a in arrays))
    t = tsparse.track_sparse(*(torch.tensor(a) for a in arrays), sampler=jax_sampler(key), **kw)
    _assert_result(j, t)
    assert bool(t.success)
    if case == "shift3":
        assert abs(float(t.transform[0, 3]) + 3 * Z0 / K[0, 0]) < 0.02
    if case == "half_depth":
        np.testing.assert_allclose(t.transform.numpy(), np.eye(4), atol=5e-3)


def _external_matches(rng):
    """Matches of 200 random points under a known 6-DoF motion, with depth
    maps that hold them (``test_sparse.py``'s deep-matcher hook)."""
    n = 200
    xi = jnp.asarray([0.02, -0.01, 0.015, 0.01, -0.008, 0.012], jnp.float32)
    from dense_visual_odometry_tpu.utils.lie import se3

    t_gt = np.asarray(se3.exp(xi))
    pts = np.stack([rng.uniform(-1.0, 1.0, n), rng.uniform(-0.8, 0.8, n),
                    rng.uniform(1.5, 3.0, n)], axis=-1).astype(np.float32)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    uv_prev = np.stack([fx * pts[:, 0] / pts[:, 2] + cx, fy * pts[:, 1] / pts[:, 2] + cy], -1)
    pts_t = pts @ t_gt[:3, :3].T + t_gt[:3, 3]
    uv_curr = np.stack([fx * pts_t[:, 0] / pts_t[:, 2] + cx,
                        fy * pts_t[:, 1] / pts_t[:, 2] + cy], -1)
    inside = ((uv_prev[:, 0] > 1) & (uv_prev[:, 0] < W - 2) & (uv_prev[:, 1] > 1)
              & (uv_prev[:, 1] < H - 2) & (uv_curr[:, 0] > 1) & (uv_curr[:, 0] < W - 2)
              & (uv_curr[:, 1] > 1) & (uv_curr[:, 1] < H - 2))
    depth_prev = np.zeros((H, W), np.float32)
    depth_curr = np.zeros((H, W), np.float32)
    for i in np.nonzero(inside)[0]:
        depth_prev[int(round(uv_prev[i, 1])), int(round(uv_prev[i, 0]))] = pts[i, 2]
        depth_curr[int(round(uv_curr[i, 1])), int(round(uv_curr[i, 0]))] = pts_t[i, 2]
    fields = (uv_prev.astype(np.float32), uv_curr.astype(np.float32),
              np.ones(n, np.float32), inside)
    return fields, depth_prev, depth_curr, np.asarray(xi)


@pytest.mark.parametrize("case", ["external", "no_valid_match"])
def test_fit_from_matches_matches_jax(case):
    rng = np.random.default_rng(0)
    if case == "external":
        fields, dp, dc, xi = _external_matches(rng)
        kw = {"depth_edge_tol": 10.0}  # sparse synthetic depth has no edges
    else:
        n = 32
        fields = (np.zeros((n, 2), np.float32), np.zeros((n, 2), np.float32),
                  np.zeros(n, np.float32), np.zeros(n, bool))
        dp = dc = np.full((H, W), Z0, np.float32)
        kw = {}
    key = jax.random.key(0)
    j = jax.jit(partial(jsparse.fit_from_matches, **kw))(
        key, jsparse.Matches(*(jnp.asarray(f) for f in fields)), jnp.asarray(dp),
        jnp.asarray(dc), jnp.asarray(K))
    t = tsparse.fit_from_matches(tsparse.Matches(*(torch.tensor(f) for f in fields)),
                                 torch.tensor(dp), torch.tensor(dc), torch.tensor(K),
                                 sampler=jax_sampler(key), **kw)
    _assert_result(j, t)
    assert bool(t.success) == (case == "external")
    if case == "external":
        from dense_visual_odometry_torch.utils.lie import se3

        np.testing.assert_allclose(se3.log(t.transform).numpy(), xi, atol=2e-3)


def test_refine_reprojection_matches_jax():
    """The Gauss-Newton polish alone, from a perturbed start, with a row of
    zero weight and a point behind the camera."""
    rng = np.random.default_rng(1)
    (uv_prev, uv_curr, _, _), dp, _, xi = _external_matches(rng)
    z = rng.uniform(1.5, 3.0, len(uv_prev)).astype(np.float32)
    pts = np.stack([(uv_prev[:, 0] - K[0, 2]) / K[0, 0] * z,
                    (uv_prev[:, 1] - K[1, 2]) / K[1, 1] * z, z], -1).astype(np.float32)
    pts[3, 2] = -1.0
    w = rng.uniform(0.2, 1.0, len(pts)).astype(np.float32)
    w[5] = 0.0
    from dense_visual_odometry_tpu.utils.lie import se3

    t0 = np.asarray(se3.exp(jnp.asarray(xi * 0.8)))
    j = jax.jit(jsparse.refine_reprojection)(jnp.asarray(t0), jnp.asarray(pts),
                                             jnp.asarray(uv_curr), jnp.asarray(w),
                                             jnp.asarray(K))
    t = tsparse.refine_reprojection(torch.tensor(t0), torch.tensor(pts), torch.tensor(uv_curr),
                                    torch.tensor(w), torch.tensor(K))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


def session_frames(n=5):
    """The seeded scene along 5 hand-held frames, depth as raw DN (the TUM
    scale)."""
    grays, depths, k, poses = smooth_pair(seed=2, frames=n)
    raw = [np.round(d / 2e-4).astype(np.uint16) for d in depths]
    return grays, raw, k, poses


def run_sessions(matcher: str, n=5, swaps=None, **kw):
    """5-frame ``SparseVO`` sessions of both packages on ``matcher``, the
    port's replaying the JAX samples (:func:`replay_session`) -> (JAX poses,
    port poses, JAX successes, port successes, truth)."""
    grays, raw, k, poses = session_frames(n)
    jvo = jsparse.SparseVO(JCamera.create(k, 2e-4), seed=0, matcher=matcher, **kw)
    tvo = replay_session(TCamera.create(k, 2e-4), matcher, 0, swaps, **kw)
    out = {"jax": ([], []), "port": ([], [])}
    for g, d in zip(grays, raw):
        for side, vo in (("jax", jvo), ("port", tvo)):
            pose = vo.step(g, d)
            out[side][0].append(np.asarray(pose if side == "jax" else pose.numpy()))
            out[side][1].append(None if vo.last_result is None
                                else bool(vo.last_result.success))
    return (np.stack(out["jax"][0]), np.stack(out["port"][0]), out["jax"][1],
            out["port"][1], poses)


def test_session_matches_jax():
    jp, tp, js, ts, truth = run_sessions("zncc")
    assert js == ts and all(s for s in ts[1:])
    np.testing.assert_allclose(tp, jp, atol=ATOL)
    rel = np.linalg.inv(truth[0]) @ truth
    assert np.abs(tp[:, :3, 3] - rel[:, :3, 3]).max() < 0.01


def test_session_own_sampler_is_seeded():
    """Without a sampler the session draws from its seed: two sessions of
    one seed give the same poses, and they track."""
    grays, raw, k, poses = session_frames(3)
    runs = []
    for _ in range(2):
        vo = tsparse.SparseVO(TCamera.create(k, 2e-4), seed=5, device="cpu")
        runs.append(np.stack([vo.step(g, d).numpy() for g, d in zip(grays, raw)]))
    np.testing.assert_array_equal(runs[0], runs[1])
    rel = np.linalg.inv(poses[0]) @ poses
    assert np.abs(runs[0][:, :3, 3] - rel[:, :3, 3]).max() < 0.01
    with pytest.raises(ValueError, match="matcher"):
        tsparse.SparseVO(TCamera.create(k, 2e-4), matcher="orb", device="cpu")
