"""The port's brick TSDF (``models/brick_tsdf.py``) against the JAX package's, on
the CPU.

The inputs of ``test_torch_tsdf.py`` (the analytic sphere in three 120x160
views, seeded intensities) fused into an (8, 8, 8) grid of 8^3 bricks over
1.2 m (64^3 virtual voxels), with a pool that holds every brick the band
touches (85) and with an undersized one (64 slots, 48 active bricks a
frame), so that allocations are refused and the active list is cut.

- ``integrate_brick`` over the three frames: ``table``, ``brick_zyx``,
  ``n_used`` and ``n_dropped`` exactly equal, the pool's fields as the dense
  volume's (``test_torch_tsdf.compare_fields``: tie voxels counted and
  bounded); the port's allocated slots are unique and map back to their
  bricks;
- ``raycast_view_march_brick``: depth within 1e-5 m on at least 99.5% of the
  pixels valid in either;
- ``dense_crop`` and ``extract_mesh_bricks`` (one slab and several) fed the
  same volume: identical arrays, configurations and meshes.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dense_visual_odometry_torch.models import brick_tsdf as tbrick
from dense_visual_odometry_torch.models import tsdf as ttsdf
from dense_visual_odometry_tpu.models import brick_tsdf as jbrick
from tests.test_torch_tsdf import (
    CENTER,
    EXTENT,
    K,
    MARCH_ATOL,
    MIN_EQUAL_SHARE,
    RES,
    TRUNC,
    H,
    W,
    compare_fields,
    render_pose,
    sphere_frames,
    tie_voxels,
)

POOLS = {"roomy": dict(pool_size=4096), "undersized": dict(pool_size=64, active_bricks=48)}


def configs(pool):
    kw = dict(truncation=TRUNC, **POOLS[pool])
    return (jbrick.BrickTSDFConfig.around(CENTER, EXTENT, resolution=RES, **kw),
            tbrick.BrickTSDFConfig.around(CENTER, EXTENT, resolution=RES, **kw))


@pytest.fixture(scope="module", params=sorted(POOLS))
def volumes(request):
    cfg_j, cfg_t = configs(request.param)
    frames, poses = sphere_frames()
    vol_j = jbrick.make_brick_volume(cfg_j)
    vol_t = tbrick.make_brick_volume(cfg_t, device="cpu")
    for (depth, gray), pose in zip(frames, poses):
        vol_j = jbrick.integrate_brick(vol_j, jnp.asarray(depth), jnp.asarray(gray),
                                       jnp.asarray(K), jnp.asarray(pose), cfg_j)
        tbrick.integrate_brick(vol_t, depth, gray, K, pose, cfg_t)
    return request.param, cfg_j, cfg_t, vol_j, vol_t, poses


def pool_ties(cfg, vol, poses) -> np.ndarray:
    """(pool, bs, bs, bs) bool: the tie voxels of the virtual grid, at each
    slot's brick."""
    dense = ttsdf.TSDFConfig(dims=cfg.dims, voxel_size=cfg.voxel_size, origin=cfg.origin,
                             truncation=cfg.truncation, min_depth=cfg.min_depth)
    ties = tie_voxels(dense, poses)
    bs = cfg.brick_size
    zyx = vol.brick_zyx.numpy().astype(np.int64)[:, :, None] * bs + np.arange(bs)
    return ties[zyx[:, 0, :, None, None], zyx[:, 1, None, :, None], zyx[:, 2, None, None, :]]


def test_integrate_brick_matches_jax(volumes):
    pool, cfg_j, cfg_t, vol_j, vol_t, poses = volumes
    for name in ("table", "brick_zyx", "n_used", "n_dropped"):
        np.testing.assert_array_equal(np.asarray(getattr(vol_j, name)),
                                      getattr(vol_t, name).numpy(), err_msg=name)
    n_used, n_dropped = int(vol_t.n_used), int(vol_t.n_dropped)
    if pool == "undersized":
        assert n_used == cfg_t.pool_size and n_dropped > 0
    else:
        assert n_used > 64 and n_dropped == 0
    n = compare_fields(vol_j, vol_t, pool_ties(cfg_t, vol_t, poses), cfg_t.truncation)
    print(f"{pool}: {n_used} bricks, {n_dropped} dropped, tie voxels that part: {n}")


def test_allocated_slots_are_unique(volumes):
    _, _, cfg, _, vol, _ = volumes
    table = vol.table.numpy()
    slots = table[table >= 0]
    assert len(np.unique(slots)) == len(slots) == int(vol.n_used)
    assert slots.min() == 0 and slots.max() == int(vol.n_used) - 1
    coords = np.argwhere(table >= 0)
    np.testing.assert_array_equal(vol.brick_zyx.numpy()[table[table >= 0]], coords)


def test_integrate_brick_updates_in_place():
    _, cfg = configs("undersized")
    frames, poses = sphere_frames()
    vol = tbrick.make_brick_volume(cfg, device="cpu")
    ptrs = [t.data_ptr() for t in vol]
    out = tbrick.integrate_brick(vol, *frames[0], K, poses[0], cfg)
    assert out is vol and [t.data_ptr() for t in vol] == ptrs
    assert int(vol.n_used) > 0 and float(vol.weight.max()) == 1.0


def test_march_brick_matches_jax(volumes):
    _, cfg_j, cfg_t, vol_j, vol_t, _ = volumes
    pose = render_pose()
    dj, _ = jbrick.raycast_view_march_brick(vol_j, jnp.asarray(K), jnp.asarray(pose), cfg_j,
                                            (H, W))
    dt, _ = tbrick.raycast_view_march_brick(vol_t, K, pose, cfg_t, (H, W))
    dj, dt = np.asarray(dj), dt.numpy()
    valid = (dj > 0) | (dt > 0)
    assert valid.mean() > 0.1
    assert (np.abs(dj - dt)[valid] <= MARCH_ATOL).mean() >= MIN_EQUAL_SHARE


def as_port(vol_j):
    return tbrick.BrickTSDFVolume(*(torch.tensor(np.asarray(a)) for a in vol_j))


def test_dense_crop_matches_jax(volumes):
    _, cfg_j, cfg_t, vol_j, _, _ = volumes
    for lo, hi in (((0, 0, 0), (8, 8, 8)), ((2, 1, 3), (6, 7, 5))):
        dj, cj = jbrick.dense_crop(vol_j, cfg_j, lo, hi)
        dt, ct = tbrick.dense_crop(as_port(vol_j), cfg_t, lo, hi)
        for a, b in zip(dj, dt):
            np.testing.assert_array_equal(np.asarray(a), b)
        assert (ct.dims, ct.voxel_size, ct.origin) == (cj.dims, cj.voxel_size, cj.origin)


@pytest.mark.parametrize("slab_bytes", [256 << 20, 200_000])
def test_extract_mesh_bricks_matches_jax(volumes, slab_bytes):
    _, cfg_j, cfg_t, vol_j, _, _ = volumes
    mj = jbrick.extract_mesh_bricks(vol_j, cfg_j, max_slab_bytes=slab_bytes)
    mt = tbrick.extract_mesh_bricks(as_port(vol_j), cfg_t, max_slab_bytes=slab_bytes)
    assert len(mt[1]) > 500
    for a, b in zip(mj, mt):
        np.testing.assert_array_equal(a, b)
