"""The port's dense TSDF (``models/tsdf.py``) against the JAX package's, on the CPU.

Inputs: the analytic sphere of ``tests/unit/test_tsdf.py`` (radius 0.3 m at
1 m), ray-traced into three 120x160 views, with seeded random intensities;
a 64^3 volume of 1.2 m (19 mm voxels), truncation 0.06 m.

- ``integrate`` over the three frames, plain and with ``carve_decay`` and
  ``truncation_scale_sq``: weights equal, gray within 1e-6, tsdf within
  ``TSDF_ATOL_M`` once scaled to meters, on every voxel but the tie voxels.
  XLA:CPU contracts the voxel's camera coordinates (``r . x + t``, JAX
  ``tsdf.py:123-131``) and the running average (``tsdf * w + obs``,
  ``:184``) into fused multiply-adds, and PyTorch does not, so a camera
  depth parts by a float32 ulp; the SDF is divided by the truncation, which
  turns that ulp (1.2e-7 m at 1-2 m) into 2e-6 in truncation units.  A tie
  voxel is one whose projection lies within ``TIE_EPS`` pixels of a
  half-integer in some frame (``round`` may then pick the neighbouring pixel
  in one package and not the other); every voxel that parts must be one,
  and they are at most 0.1% of the observed voxels (their count is printed).
- ``raycast_view`` with ``fill_passes`` 0 and 1 from a fourth viewpoint:
  the same validity and gray, and depth within two float32 ulps at 1-2 m,
  on at least 99.5% of the pixels.
- ``raycast_view_march``: depth within 1e-5 m on at least 99.5% of the
  pixels valid in either.
- ``extract_mesh``, ``save_mesh_ply`` and ``save_mesh_obj`` fed the same
  numpy volume: identical vertices, faces and gray, identical files.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dense_visual_odometry_torch.models import tsdf as ttsdf
from dense_visual_odometry_torch.utils.lie import se3 as tse3
from dense_visual_odometry_tpu.models import tsdf as jtsdf
from tests.unit.test_tsdf import CENTER, lookat, render_sphere_depth

H, W = 120, 160
K = np.array([[120.0, 0.0, 80.0], [0.0, 120.0, 60.0], [0.0, 0.0, 1.0]], np.float32)
EXTENT, RES, TRUNC = 1.2, 64, 0.06
EYES = ((0.0, 0.0, 0.0), (1.0, 0.0, 1.0), (0.0, -1.0, 1.0))
RENDER_EYE = (0.4, -0.3, 0.1)
TSDF_ATOL_M = 1.2e-7  # one float32 ulp of a camera depth in [1, 2) m
GRAY_ATOL = 1e-6
TIE_EPS = 1e-4  # pixels from a half-integer
TIE_SHARE = 1e-3
SPLAT_DEPTH_ATOL = 2.4e-7  # two float32 ulps at 1-2 m
MARCH_ATOL = 1e-5
MIN_EQUAL_SHARE = 0.995
VARIANTS = {"plain": {}, "carve_adaptive": {"carve_decay": 0.5, "truncation_scale_sq": 0.02}}


def sphere_frames(eyes=EYES, seed=0):
    """-> ([(depth_m, gray)], [pose (4, 4) float32]) of the sphere."""
    rng = np.random.default_rng(seed)
    poses = [lookat(e, CENTER).astype(np.float32) for e in eyes]
    frames = [(render_sphere_depth(H, W, K, p), rng.uniform(0, 255, (H, W)).astype(np.float32))
              for p in poses]
    return frames, poses


def configs(**kw):
    kw = {"truncation": TRUNC, **kw}
    return (jtsdf.TSDFConfig.around(CENTER, EXTENT, resolution=RES, **kw),
            ttsdf.TSDFConfig.around(CENTER, EXTENT, resolution=RES, **kw))


def tie_voxels(cfg, poses, k=K, eps=TIE_EPS) -> np.ndarray:
    """(D, H, W) bool: voxels in front of some camera whose projection lies
    within ``eps`` pixels of a half-integer (the port's arithmetic)."""
    k_t = torch.as_tensor(k)
    ties = torch.zeros(cfg.dims, dtype=torch.bool)
    for pose in poses:
        xc, yc, zc = ttsdf._voxel_camera_coords(cfg, tse3.inverse(torch.as_tensor(pose)))
        z_safe = torch.where(zc > cfg.min_depth, zc, torch.ones_like(zc))
        for coord, f, c in ((xc, k_t[0, 0], k_t[0, 2]), (yc, k_t[1, 1], k_t[1, 2])):
            p = f * coord / z_safe + c
            ties |= (torch.abs(p - torch.floor(p) - 0.5) < eps) & (zc > cfg.min_depth)
    return ties.numpy()


def compare_fields(jvol, tvol, ties: np.ndarray, truncation: float) -> int:
    """Holds the port's fields to the JAX package's (module docstring) ->
    the number of tie voxels that part."""
    tsdf_j, tsdf_t = np.asarray(jvol.tsdf), tvol.tsdf.cpu().numpy()
    w_j, w_t = np.asarray(jvol.weight), tvol.weight.cpu().numpy()
    g_j, g_t = np.asarray(jvol.gray), tvol.gray.cpu().numpy()
    parts = ((w_j != w_t) | (np.abs(g_j - g_t) > GRAY_ATOL)
             | (np.abs(tsdf_j.astype(np.float64) - tsdf_t) * truncation > TSDF_ATOL_M))
    assert not np.any(parts & ~ties.reshape(parts.shape)), "a voxel off the ties parts"
    n = int(parts.sum())
    assert n <= TIE_SHARE * max(int((w_j > 0).sum()), 1)
    return n


def fused(variant):
    cfg_j, cfg_t = configs(**VARIANTS[variant])
    frames, poses = sphere_frames()
    vol_j = jtsdf.integrate_frames(jtsdf.make_volume(cfg_j), frames, K, poses, cfg_j)
    vol_t = ttsdf.integrate_frames(ttsdf.make_volume(cfg_t, device="cpu"), frames, K, poses,
                                   cfg_t)
    return cfg_j, cfg_t, vol_j, vol_t, poses


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def volumes(request):
    return fused(request.param)


def test_integrate_matches_jax(volumes):
    cfg_j, cfg_t, vol_j, vol_t, poses = volumes
    assert (np.asarray(vol_j.weight) > 0).sum() > 10000
    n = compare_fields(vol_j, vol_t, tie_voxels(cfg_t, poses), cfg_t.truncation)
    print(f"tie voxels that part: {n}")


def test_integrate_updates_in_place():
    _, cfg = configs()
    frames, poses = sphere_frames()
    vol = ttsdf.make_volume(cfg, device="cpu")
    ptrs = [t.data_ptr() for t in vol]
    out = ttsdf.integrate(vol, *frames[0], K, poses[0], cfg)
    assert out is vol and [t.data_ptr() for t in vol] == ptrs
    assert float(vol.weight.max()) == 1.0 and float(vol.weight.min()) == 0.0


def test_default_device_is_the_gpu():
    _, cfg = configs()
    if torch.cuda.is_available():
        assert ttsdf.make_volume(cfg).tsdf.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ttsdf.make_volume(cfg)


def render_pose():
    return lookat(RENDER_EYE, CENTER).astype(np.float32)


@pytest.mark.parametrize("fill_passes", [0, 1])
def test_raycast_view_matches_jax(volumes, fill_passes):
    cfg_j, cfg_t, vol_j, vol_t, _ = volumes
    pose = render_pose()
    dj, gj = jtsdf.raycast_view(vol_j, jnp.asarray(K), jnp.asarray(pose), cfg_j, (H, W),
                                fill_passes=fill_passes)
    dt, gt = ttsdf.raycast_view(vol_t, K, pose, cfg_t, (H, W), fill_passes=fill_passes)
    dj, gj, dt, gt = np.asarray(dj), np.asarray(gj), dt.numpy(), gt.numpy()
    assert 0.1 < (dj > 0).mean() < 0.9
    equal = ((dj > 0) == (dt > 0)) & (gj == gt) & (np.abs(dj - dt) <= SPLAT_DEPTH_ATOL)
    assert equal.mean() >= MIN_EQUAL_SHARE, equal.mean()


def test_raycast_view_march_matches_jax(volumes):
    cfg_j, cfg_t, vol_j, vol_t, _ = volumes
    pose = render_pose()
    dj, gj = jtsdf.raycast_view_march(vol_j, jnp.asarray(K), jnp.asarray(pose), cfg_j, (H, W))
    dt, gt = ttsdf.raycast_view_march(vol_t, K, pose, cfg_t, (H, W))
    dj, dt = np.asarray(dj), dt.numpy()
    valid = (dj > 0) | (dt > 0)
    assert valid.mean() > 0.1
    assert (np.abs(dj - dt)[valid] <= MARCH_ATOL).mean() >= MIN_EQUAL_SHARE


def test_extract_and_save_mesh_match_jax(volumes, tmp_path):
    cfg_j, cfg_t, vol_j, _, _ = volumes
    host = jtsdf.TSDFVolume(*(np.asarray(a) for a in vol_j))
    mj = jtsdf.extract_mesh(host, cfg_j)
    mt = ttsdf.extract_mesh(ttsdf.TSDFVolume(*(torch.tensor(a) for a in host)), cfg_t)
    assert len(mt[1]) > 500
    for a, b in zip(mj, mt):
        np.testing.assert_array_equal(a, b)
    for ext, jsave, tsave in (("ply", jtsdf.save_mesh_ply, ttsdf.save_mesh_ply),
                              ("obj", jtsdf.save_mesh_obj, ttsdf.save_mesh_obj)):
        jsave(tmp_path / f"j.{ext}", *mj)
        tsave(tmp_path / f"t.{ext}", *mt)
        assert (tmp_path / f"j.{ext}").read_bytes() == (tmp_path / f"t.{ext}").read_bytes()
        jsave(tmp_path / f"j.{ext}", *mj[:2])
        tsave(tmp_path / f"t.{ext}", *mt[:2])
        assert (tmp_path / f"j.{ext}").read_bytes() == (tmp_path / f"t.{ext}").read_bytes()


def test_empty_volume_extracts_nothing():
    cfg = ttsdf.TSDFConfig(dims=(16, 16, 16), voxel_size=0.05)
    verts, faces, gray = ttsdf.extract_mesh(ttsdf.make_volume(cfg, device="cpu"), cfg)
    assert verts.shape == (0, 3) and faces.shape == (0, 3) and gray.shape == (0,)
