"""Brick-grid (two-level sparse) TSDF volume.

Counterpart of ``dense_visual_odometry_tpu/models/brick_tsdf.py``:

- a dense coarse ``table`` over a grid of bricks (int32 pool slot, -1 =
  unallocated) and a fixed-capacity pool ``(pool_size, bs, bs, bs)`` of
  tsdf / weight / gray for the allocated bricks only;
- :func:`integrate_brick` marks the bricks the frame's truncation band
  touches, allocates new ones by a cumulative-sum rank (no host round
  trip), and fuses a fixed ``active_bricks`` list of whole bricks with the
  dense volume's observation model; it updates the volume in place;
- :func:`raycast_view_march_brick` marches with an adaptive step: half a
  brick through unallocated bricks, 0.75 voxel inside allocated ones;
- :func:`dense_crop` and :func:`extract_mesh_bricks` materialize bricks on
  the host for mesh export.

The JAX package writes the rows it drops with ``mode="drop"`` scatters
(an index one past the end).  PyTorch has no such mode: the table, flags
and active list here get one spare entry that is sliced off, and the pool's
whole-brick writeback points its padded rows at the first row's slot with
the first row's values, so that every write to a slot is the same write.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from dense_visual_odometry_torch.models.robust import resolve_device
from dense_visual_odometry_torch.models.tsdf import (
    TSDFConfig,
    TSDFVolume,
    _empty_mesh,
    _f32,
    _host,
    extract_mesh,
    fuse,
    observe,
    pixel_directions,
    pixel_rays,
    refine_hits,
    trilinear_corners,
)
from dense_visual_odometry_torch.utils.lie import se3


@dataclasses.dataclass(frozen=True)
class BrickTSDFConfig:
    """Two-level volume geometry and fusion parameters.  The virtual voxel
    grid is ``brick_grid * brick_size`` a side; only bricks a truncation
    band crossed own memory."""

    brick_grid: Tuple[int, int, int] = (64, 64, 64)  # bricks along (z, y, x)
    brick_size: int = 8  # voxels per brick edge
    pool_size: int = 16384  # total brick capacity
    # Bricks one frame may update; beyond it a brick waits for a later view.
    active_bricks: int = 6144
    voxel_size: float = 0.01  # meters per (virtual) voxel
    origin: Tuple[float, float, float] = (-2.56, -2.56, 0.0)
    truncation: float = 0.08
    max_weight: float = 64.0
    min_depth: float = 0.05
    truncation_scale_sq: float = 0.0
    carve_decay: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "brick_grid", tuple(int(d) for d in self.brick_grid))
        object.__setattr__(self, "origin", tuple(float(o) for o in self.origin))
        if self.truncation <= 0 or self.voxel_size <= 0:
            raise ValueError("voxel_size and truncation must be positive")
        if self.brick_size < 2:
            raise ValueError("brick_size must be >= 2")
        if not 0.0 <= self.carve_decay <= 1.0:
            raise ValueError("carve_decay must be in [0, 1]")
        if self.truncation_scale_sq < 0:
            raise ValueError("truncation_scale_sq must be >= 0")

    @property
    def dims(self) -> Tuple[int, int, int]:
        """Virtual dense dimensions (D, H, W) in voxels."""
        bs = self.brick_size
        return tuple(g * bs for g in self.brick_grid)

    @classmethod
    def around(cls, center, extent: float, resolution: int = 512, **kw):
        """Cube volume of side ``extent`` centred at ``center`` with
        ``resolution`` virtual voxels an edge."""
        bs = int(kw.get("brick_size", cls.brick_size))
        if resolution % bs:
            raise ValueError("resolution must be a multiple of brick_size")
        half = extent / 2.0
        c = np.asarray(center, dtype=np.float64)
        g = resolution // bs
        return cls(
            brick_grid=(g, g, g),
            voxel_size=extent / resolution,
            origin=tuple(float(x) for x in (c - half)),
            **kw,
        )


class BrickTSDFVolume(NamedTuple):
    """Sparse fusion state.  ``table`` maps brick coordinates to a pool slot
    (-1 = unallocated), ``brick_zyx`` is the reverse map; ``n_dropped``
    counts allocations refused because the pool was full."""

    table: torch.Tensor  # (Gz, Gy, Gx) int32
    brick_zyx: torch.Tensor  # (pool, 3) int32
    tsdf: torch.Tensor  # (pool, bs, bs, bs) f32
    weight: torch.Tensor  # (pool, bs, bs, bs) f32
    gray: torch.Tensor  # (pool, bs, bs, bs) f32
    n_used: torch.Tensor  # () int32
    n_dropped: torch.Tensor  # () int32


def make_brick_volume(cfg: BrickTSDFConfig, device=None) -> BrickTSDFVolume:
    """An empty brick volume on ``device`` (None = the GPU)."""
    dev = resolve_device(device)
    bs = cfg.brick_size
    p = cfg.pool_size
    return BrickTSDFVolume(
        table=torch.full(cfg.brick_grid, -1, dtype=torch.int32, device=dev),
        brick_zyx=torch.zeros((p, 3), dtype=torch.int32, device=dev),
        tsdf=torch.ones((p, bs, bs, bs), dtype=torch.float32, device=dev),
        weight=torch.zeros((p, bs, bs, bs), dtype=torch.float32, device=dev),
        gray=torch.zeros((p, bs, bs, bs), dtype=torch.float32, device=dev),
        n_used=torch.zeros((), dtype=torch.int32, device=dev),
        n_dropped=torch.zeros((), dtype=torch.int32, device=dev),
    )


# Band samples along each pixel ray at z + s * tau: a spacing of tau/2 skips
# no brick for tau under two brick edges, and s = -2 reaches one band of
# free space in front, so carving can clear a surface that moved.
_BAND_OFFSETS = (-2.0, -1.0, -0.5, 0.0, 0.5, 1.0)


def _cumsum_rank(mask: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1


def integrate_brick(
    volume: BrickTSDFVolume,
    depth_m,
    gray,
    intrinsics,
    pose,
    cfg: BrickTSDFConfig,
) -> BrickTSDFVolume:
    """Allocate and fuse one frame into ``volume`` in place; returns it.

    The dense volume's observation model (running weighted average,
    adaptive truncation, carving within the band), restricted to the
    ``active_bricks`` bricks the frame's band touches; new bricks are
    allocated on the device.  pose : (4, 4) camera-to-world.
    """
    dev = volume.tsdf.device
    depth_m, gray = _f32(depth_m, dev), _f32(gray, dev)
    intrinsics, pose = _f32(intrinsics, dev), _f32(pose, dev)
    h, w = depth_m.shape
    bs = cfg.brick_size
    gz, gy, gx = cfg.brick_grid
    g_total = gz * gy * gx
    vs = cfg.voxel_size
    ox, oy, oz = cfg.origin
    brick_edge = bs * vs

    # Mark the bricks this frame's truncation band touches.
    dx, dy = pixel_directions(intrinsics, (h, w))
    z = depth_m
    ok_px = z > cfg.min_depth
    z_safe = torch.where(ok_px, z, torch.ones_like(z))
    r = pose[:3, :3]
    t = pose[:3, 3]
    tau = cfg.truncation + cfg.truncation_scale_sq * z_safe * z_safe
    flags = torch.zeros((g_total + 1,), dtype=torch.int32, device=dev)
    for s in _BAND_OFFSETS:
        zs = z_safe + s * tau
        px = r[0, 0] * (dx * zs) + r[0, 1] * (dy * zs) + r[0, 2] * zs + t[0]
        py = r[1, 0] * (dx * zs) + r[1, 1] * (dy * zs) + r[1, 2] * zs + t[1]
        pz = r[2, 0] * (dx * zs) + r[2, 1] * (dy * zs) + r[2, 2] * zs + t[2]
        bx = torch.floor((px - ox) / brick_edge).to(torch.int32)
        by = torch.floor((py - oy) / brick_edge).to(torch.int32)
        bz = torch.floor((pz - oz) / brick_edge).to(torch.int32)
        ok = (ok_px & (zs > cfg.min_depth) & (bx >= 0) & (bx < gx) & (by >= 0) & (by < gy)
              & (bz >= 0) & (bz < gz))
        flat = torch.where(ok, (bz * gy + by) * gx + bx, torch.full_like(bx, g_total))
        flags[flat.reshape(-1).long()] = 1
    flags = flags[:g_total].bool()

    # Allocate new bricks: a dense mask and its cumulative-sum rank.
    table_flat = volume.table.reshape(-1)
    need_new = flags & (table_flat < 0)
    slot = volume.n_used + _cumsum_rank(need_new)
    can = need_new & (slot < cfg.pool_size)
    table_flat = torch.where(can, slot, table_flat)
    ids = torch.arange(g_total, dtype=torch.int32, device=dev)
    coords = torch.stack([ids // (gy * gx), (ids // gx) % gy, ids % gx], dim=-1)
    spare = torch.zeros((1, 3), dtype=torch.int32, device=dev)
    brick_zyx = torch.cat([volume.brick_zyx, spare])
    brick_zyx[torch.where(can, slot, cfg.pool_size).long()] = coords
    brick_zyx = brick_zyx[: cfg.pool_size]
    n_new = torch.sum(can, dtype=torch.int32)
    n_used = volume.n_used + n_new
    n_dropped = volume.n_dropped + torch.sum(need_new, dtype=torch.int32) - n_new

    # The fixed-size list of bricks this frame updates.
    a_cap = cfg.active_bricks
    active = flags & (table_flat >= 0)
    a_rank = _cumsum_rank(active)
    active_ids = torch.full((a_cap + 1,), -1, dtype=torch.int32, device=dev)
    active_ids[torch.where(active & (a_rank < a_cap), a_rank, a_cap).long()] = ids
    active_ids = active_ids[:a_cap]
    a_ok = active_ids >= 0
    slots = torch.where(a_ok, table_flat[torch.clamp(active_ids, min=0).long()],
                        torch.full_like(active_ids, cfg.pool_size))
    slots_c = torch.clamp(slots, 0, cfg.pool_size - 1).long()

    # Project the active bricks' voxels and fuse (the dense path's model).
    zyx = brick_zyx[slots_c].to(torch.float32)  # (A, 3)
    local = torch.arange(bs, dtype=torch.float32, device=dev) + 0.5
    wz = oz + (zyx[:, 0, None] * bs + local) * vs  # (A, bs)
    wy = oy + (zyx[:, 1, None] * bs + local) * vs
    wx = ox + (zyx[:, 2, None] * bs + local) * vs
    w2c = se3.inverse(pose)
    rc = w2c[:3, :3]
    tc = w2c[:3, 3]

    def cam_axis(row):
        return (rc[row, 0] * wx[:, None, None, :] + rc[row, 1] * wy[:, None, :, None]
                + rc[row, 2] * wz[:, :, None, None] + tc[row])

    valid, sdf, trunc, tsdf_obs, gray_s = observe(
        cfg, cam_axis(0), cam_axis(1), cam_axis(2), depth_m, gray, intrinsics)
    valid = valid & a_ok[:, None, None, None]
    new = fuse(cfg, valid, sdf, trunc, tsdf_obs, gray_s, volume.tsdf[slots_c],
               volume.weight[slots_c], volume.gray[slots_c])

    # Whole-brick writeback.  Real slots are unique; a padded row writes the
    # first row's values to the first row's slot (with no active row, the
    # unchanged contents of slot pool - 1 back to it), so that no two
    # different writes meet.
    idx = torch.where(a_ok, slots_c, slots_c[0])
    keep = a_ok[:, None, None, None]
    for field, value in zip((volume.tsdf, volume.weight, volume.gray), new):
        field[idx] = torch.where(keep, value, value[:1])
    volume.table.copy_(table_flat.reshape(cfg.brick_grid))
    volume.brick_zyx.copy_(brick_zyx)
    volume.n_used.copy_(n_used)
    volume.n_dropped.copy_(n_dropped)
    return volume


def _virtual_sample_setup(volume: BrickTSDFVolume, cfg, min_weight):
    """Confidence-masked flat pool fields and a lookup from virtual voxel
    coordinates to flat pool indices."""
    bs = cfg.brick_size
    gz, gy, gx = cfg.brick_grid
    phi_field = torch.where(volume.weight >= min_weight, volume.tsdf,
                            torch.ones_like(volume.tsdf)).reshape(-1)
    gray_field = volume.gray.reshape(-1)
    table_flat = volume.table.reshape(-1)

    def flat_index(ix, iy, iz):
        """Virtual voxel (ix, iy, iz), clipped to the virtual dims ->
        (flat pool index, allocated?)."""
        bxi = ix // bs
        byi = iy // bs
        bzi = iz // bs
        slot = table_flat[((bzi * gy + byi) * gx + bxi).long()]
        ok = slot >= 0
        lx = ix - bxi * bs
        ly = iy - byi * bs
        lz = iz - bzi * bs
        flat = torch.clamp(slot, min=0) * (bs * bs * bs) + (lz * bs + ly) * bs + lx
        return flat.long(), ok

    return phi_field, gray_field, flat_index


def raycast_view_march_brick(
    volume: BrickTSDFVolume,
    intrinsics,
    pose,
    cfg: BrickTSDFConfig,
    shape: Tuple[int, int],
    min_weight: float = 1.0,
    max_depth: float = 10.0,
    n_coarse: int = 96,
    n_fine: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render a virtual (depth, gray) view of the brick volume.

    One march of ``n_coarse + n_fine`` steps whose step is half a brick
    edge through unallocated bricks and 0.75 voxel inside allocated ones
    (the occupancy bit comes from the table lookup the field sample needs);
    the crossing is localized linearly and refined by two trilinear
    sphere-tracing steps.  -> (depth_m (H, W) f32 with 0 = no surface,
    gray (H, W) f32).
    """
    h, w = shape
    bs = cfg.brick_size
    gz, gy, gx = cfg.brick_grid
    d, hh, ww = cfg.dims
    vs = cfg.voxel_size
    ox, oy, oz = cfg.origin
    brick_edge = bs * vs
    dev = volume.tsdf.device
    intrinsics, pose = _f32(intrinsics, dev), _f32(pose, dev)

    phi_field, gray_field, flat_index = _virtual_sample_setup(volume, cfg, min_weight)
    occ_flat = volume.table.reshape(-1) >= 0
    rays = pixel_rays(intrinsics, pose, shape)

    def occ_at(t):
        px, py, pz = rays.point(t)
        bx = torch.floor((px - ox) / brick_edge).to(torch.int32)
        by = torch.floor((py - oy) / brick_edge).to(torch.int32)
        bz = torch.floor((pz - oz) / brick_edge).to(torch.int32)
        inside = (bx >= 0) & (bx < gx) & (by >= 0) & (by < gy) & (bz >= 0) & (bz < gz)
        flat = ((torch.clamp(bz, 0, gz - 1) * gy + torch.clamp(by, 0, gy - 1)) * gx
                + torch.clamp(bx, 0, gx - 1))
        return occ_flat[flat.reshape(-1).long()].reshape(h, w) & inside

    def sample_nearest_occ(t):
        """(phi, allocated?) at the nearest voxel."""
        px, py, pz = rays.point(t)
        ix = torch.round((px - ox) / vs - 0.5).to(torch.int32)
        iy = torch.round((py - oy) / vs - 0.5).to(torch.int32)
        iz = torch.round((pz - oz) / vs - 0.5).to(torch.int32)
        inside = (ix >= 0) & (ix < ww) & (iy >= 0) & (iy < hh) & (iz >= 0) & (iz < d)
        flat, ok = flat_index(torch.clamp(ix, 0, ww - 1), torch.clamp(iy, 0, hh - 1),
                              torch.clamp(iz, 0, d - 1))
        phi = phi_field[flat.reshape(-1)].reshape(h, w)
        occ = inside & ok
        return torch.where(occ, phi, torch.ones_like(phi)), occ

    def sample_trilinear(field, fill, t):
        acc = torch.zeros((h, w), dtype=torch.float32, device=dev)
        for ix, iy, iz, wgt in trilinear_corners(cfg, rays, t):
            flat, ok = flat_index(ix, iy, iz)
            val = field[flat.reshape(-1)].reshape(h, w)
            # Unallocated corners read as free space (phi 1, gray 0).
            acc = acc + wgt * torch.where(ok, val, torch.full_like(val, fill))
        return acc

    dt_c = torch.tensor(brick_edge * 0.5, dtype=torch.float32, device=dev)
    dt_f = torch.tensor(vs * 0.75, dtype=torch.float32, device=dev)
    t_prev = torch.full((h, w), cfg.min_depth, dtype=torch.float32, device=dev)
    phi_prev = sample_nearest_occ(t_prev)[0]
    t_cur = t_prev + torch.where(occ_at(t_prev), dt_f, dt_c)
    found = torch.zeros((h, w), dtype=torch.bool, device=dev)
    t_hit = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for _ in range(n_coarse + n_fine):
        phi, in_band = sample_nearest_occ(t_cur)
        # After a skip (phi_prev = 1 in empty space) the interpolation lands
        # early; the trilinear refinement below pulls it onto the surface.
        crossing = (~found) & (phi < 0.0) & (phi_prev >= 0.0)
        denom = torch.clamp(phi_prev - phi, min=1e-6)
        t_lin = t_prev + (t_cur - t_prev) * phi_prev / denom
        t_hit = torch.where(crossing, t_lin, t_hit)
        found = found | crossing
        step = torch.where(in_band, dt_f, dt_c)
        t_next = torch.where(found | (t_cur > max_depth), t_cur, t_cur + step)
        phi_prev, t_prev, t_cur = phi, t_cur, t_next
    valid = found & (t_hit > cfg.min_depth) & (t_hit <= max_depth)
    t_hit = refine_hits(cfg, valid, t_hit, lambda t: sample_trilinear(phi_field, 1.0, t))
    gray = sample_trilinear(gray_field, 0.0, t_hit)
    zero = torch.zeros_like(t_hit)
    return torch.where(valid, t_hit, zero), torch.where(valid, gray, zero)


def dense_crop(
    volume: BrickTSDFVolume,
    cfg: BrickTSDFConfig,
    brick_lo: Tuple[int, int, int],
    brick_hi: Tuple[int, int, int],
) -> Tuple[TSDFVolume, TSDFConfig]:
    """Bricks ``[lo, hi)`` as a dense :class:`TSDFVolume` of host numpy
    arrays and its :class:`TSDFConfig` (for mesh export and tests).
    Unallocated voxels read tsdf 1, weight 0, gray 0."""
    bs = cfg.brick_size
    lo = np.asarray(brick_lo, np.int64)
    hi = np.asarray(brick_hi, np.int64)
    shape_b = tuple(int(x) for x in hi - lo)
    table = _host(volume.table)
    sl = tuple(slice(int(lo[i]), int(hi[i])) for i in range(3))
    slots = table[sl]  # (nbz, nby, nbx)
    ok = slots >= 0
    slots_c = np.clip(slots, 0, None)

    def fill(pool_field, fill_value):
        src = _host(pool_field)[slots_c.reshape(-1)]  # (NB, bs, bs, bs)
        src = src.reshape(*shape_b, bs, bs, bs)
        src[~ok] = fill_value
        # (bz, by, bx, z, y, x) -> (bz*bs, by*bs, bx*bs)
        return np.ascontiguousarray(
            src.transpose(0, 3, 1, 4, 2, 5).reshape(
                shape_b[0] * bs, shape_b[1] * bs, shape_b[2] * bs))

    dense = TSDFVolume(
        tsdf=fill(volume.tsdf, 1.0),
        weight=fill(volume.weight, 0.0),
        gray=fill(volume.gray, 0.0),
    )
    origin = (
        cfg.origin[0] + int(lo[2]) * bs * cfg.voxel_size,
        cfg.origin[1] + int(lo[1]) * bs * cfg.voxel_size,
        cfg.origin[2] + int(lo[0]) * bs * cfg.voxel_size,
    )
    dcfg = TSDFConfig(
        dims=tuple(int(n) * bs for n in shape_b),
        voxel_size=cfg.voxel_size,
        origin=origin,
        truncation=cfg.truncation,
        max_weight=cfg.max_weight,
        min_depth=cfg.min_depth,
        truncation_scale_sq=cfg.truncation_scale_sq,
        carve_decay=cfg.carve_decay,
    )
    return dense, dcfg


def extract_mesh_bricks(
    volume: BrickTSDFVolume,
    cfg: BrickTSDFConfig,
    min_weight: float = 1.0,
    max_slab_bytes: int = 256 << 20,
):
    """TSDF zero crossing -> triangle mesh from the brick volume, on the host.

    The allocated bricks' bounding box is cut into Z slabs (each at most
    ``max_slab_bytes``) with one brick plane of overlap, each slab runs the
    dense :func:`extract_mesh`, and vertices duplicated at slab boundaries
    are welded (both copies come from the same two corner values, so equal
    coordinates weld them).  -> (vertices, faces, vertex_gray).
    """
    n_used = int(volume.n_used)
    if n_used == 0:
        return _empty_mesh()
    zyx = _host(volume.brick_zyx)[:n_used]
    lo = zyx.min(axis=0)
    hi = zyx.max(axis=0) + 1
    bs = cfg.brick_size
    ny, nx = int(hi[1] - lo[1]), int(hi[2] - lo[2])
    bytes_per_zbrick = (ny * bs) * (nx * bs) * bs * 4 * 3
    zstep = max(1, int(max_slab_bytes // max(bytes_per_zbrick, 1)))

    all_v, all_f, all_g = [], [], []
    voffset = 0
    z0 = int(lo[0])
    while z0 < int(hi[0]):
        z1 = min(z0 + zstep, int(hi[0]))
        # One brick plane of overlap, so that cubes across the slab boundary
        # are emitted once (by the lower slab).
        z_hi = min(z1 + 1, int(hi[0]))
        dense, dcfg = dense_crop(
            volume, cfg, (z0, int(lo[1]), int(lo[2])), (z_hi, int(hi[1]), int(hi[2])))
        if z_hi < int(hi[0]):
            # Keep one voxel plane past the boundary: cubes based in the
            # overlap plane belong to the next slab.
            keep = (z1 - z0) * bs + 1
            dense = TSDFVolume(tsdf=dense.tsdf[:keep], weight=dense.weight[:keep],
                               gray=dense.gray[:keep])
            dcfg = dataclasses.replace(dcfg, dims=(keep, dcfg.dims[1], dcfg.dims[2]))
        verts, faces, vgray = extract_mesh(dense, dcfg, min_weight=min_weight)
        if len(verts):
            all_v.append(verts)
            all_f.append(faces + voffset)
            all_g.append(vgray)
            voffset += len(verts)
        z0 = z1
    if not all_v:
        return _empty_mesh()
    verts = np.concatenate(all_v)
    faces = np.concatenate(all_f)
    vgray = np.concatenate(all_g)
    # Weld slab-boundary duplicates by exact coordinates.
    key = np.round(verts / (cfg.voxel_size * 1e-6)).astype(np.int64)
    _, uniq_idx, inverse = np.unique(key, axis=0, return_index=True, return_inverse=True)
    return verts[uniq_idx], inverse[faces], vgray[uniq_idx]
