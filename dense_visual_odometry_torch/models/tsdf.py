"""TSDF volume fusion, raycasts and triangle-mesh extraction (mapping).

Counterpart of ``dense_visual_odometry_tpu/models/tsdf.py``:

- the volume is a fixed-shape ``(D, H, W)`` NamedTuple of tensors (tsdf,
  weight, gray) on one device; :func:`integrate` updates it in place, where
  the JAX package donates it to a jitted update: on the GPU one launch of
  ``ops/cuda/csrc/tsdf_fuse.cu``, on the CPU :func:`integrate_plain`;
- integration is gather-formulated: every voxel projects into the frame and
  samples depth and intensity at its nearest pixel (``torch.round``, half to
  even, as ``jnp.round``);
- :func:`raycast_view` renders a view by splatting near-surface voxels with
  two scatter-mins over a 2x2 footprint (an int32 key of depth bin, |tsdf|
  and gray, then the winner's depth) and valid-aware 3x3 fill passes;
  :func:`raycast_view_march` marches every ray in fixed steps with nearest
  sampling, a linear crossing and two trilinear sphere-tracing steps;
  :func:`raycast_view_march_volume` marches each ray's stretch inside the
  volume: on the GPU one launch of ``ops/cuda/csrc/raycast_volume.cu``, on
  the CPU :func:`raycast_view_march_volume_plain`;
- mesh extraction runs on the host in numpy: marching tetrahedra over the
  6-tet cube decomposition, winding made consistent against the SDF
  gradient.

Every function runs on the device of the volume it is given;
:func:`make_volume` puts a new one on the GPU unless told otherwise.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dense_visual_odometry_torch.models.robust import as_device_tensor, resolve_device
from dense_visual_odometry_torch.ops.cuda import tsdf as tsdf_kernel
from dense_visual_odometry_torch.utils.lie import se3


@dataclasses.dataclass(frozen=True)
class TSDFConfig:
    """Volume geometry and fusion parameters."""

    dims: Tuple[int, int, int] = (128, 128, 128)  # (D, H, W) = (z, y, x)
    voxel_size: float = 0.02  # meters per voxel
    origin: Tuple[float, float, float] = (-1.28, -1.28, 0.0)  # world (x, y, z)
    truncation: float = 0.08  # meters; SDF clamped to +-truncation
    max_weight: float = 64.0  # running-average observation cap
    min_depth: float = 0.05
    # Adaptive band tau(z) = truncation + truncation_scale_sq * z^2 (the
    # disparity noise of Kinect-class sensors grows with z^2); 0 = fixed.
    truncation_scale_sq: float = 0.0
    # Space carving: a free-space observation (sdf > tau) of a voxel the
    # field calls surface (tsdf < 0.25) decays its weight by this factor
    # before averaging; 0 = standard TSDF.
    carve_decay: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "dims", tuple(int(d) for d in self.dims))
        object.__setattr__(self, "origin", tuple(float(o) for o in self.origin))
        if self.truncation <= 0 or self.voxel_size <= 0:
            raise ValueError("voxel_size and truncation must be positive")
        if not 0.0 <= self.carve_decay <= 1.0:
            raise ValueError("carve_decay must be in [0, 1]")
        if self.truncation_scale_sq < 0:
            raise ValueError("truncation_scale_sq must be >= 0")

    @classmethod
    def around(cls, center, extent: float, resolution: int = 128, **kw):
        """Cube volume of side ``extent`` centred at ``center`` (world)."""
        half = extent / 2.0
        c = np.asarray(center, dtype=np.float64)
        return cls(
            dims=(resolution, resolution, resolution),
            voxel_size=extent / resolution,
            origin=tuple(float(x) for x in (c - half)),
            **kw,
        )


class TSDFVolume(NamedTuple):
    """Fusion state; ``tsdf`` in truncation units (+1 free space ... -1
    behind the surface), weight 0 = unobserved."""

    tsdf: torch.Tensor  # (D, H, W) f32
    weight: torch.Tensor  # (D, H, W) f32
    gray: torch.Tensor  # (D, H, W) f32 running-average intensity


def make_volume(cfg: TSDFConfig, device=None) -> TSDFVolume:
    """An empty volume on ``device`` (None = the GPU)."""
    dev = resolve_device(device)
    return TSDFVolume(
        tsdf=torch.ones(cfg.dims, dtype=torch.float32, device=dev),
        weight=torch.zeros(cfg.dims, dtype=torch.float32, device=dev),
        gray=torch.zeros(cfg.dims, dtype=torch.float32, device=dev),
    )


def volume_bytes(volume) -> int:
    """Bytes the volume's tensors hold."""
    return sum(t.numel() * t.element_size() for t in volume)


def _f32(x, device) -> torch.Tensor:
    return as_device_tensor(x, device).to(torch.float32)


def voxel_axes(cfg: TSDFConfig, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The voxel centres' world coordinates along x, y and z: (W,), (H,) and
    (D,) float32 on ``device``."""
    d, h, w = cfg.dims
    vs = cfg.voxel_size
    ox, oy, oz = cfg.origin
    xs = ox + (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * vs
    ys = oy + (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * vs
    zs = oz + (torch.arange(d, dtype=torch.float32, device=device) + 0.5) * vs
    return xs, ys, zs


def _voxel_camera_coords(cfg: TSDFConfig, world_to_cam: torch.Tensor):
    """Voxel centres in the camera frame: three (D, H, W) planes, built
    separably (JAX ``tsdf.py:110``)."""
    xs, ys, zs = voxel_axes(cfg, world_to_cam.device)
    r = world_to_cam[:3, :3]
    t = world_to_cam[:3, 3]

    def axis_comb(row):
        return (
            r[row, 0] * xs[None, None, :]
            + r[row, 1] * ys[None, :, None]
            + r[row, 2] * zs[:, None, None]
            + t[row]
        )

    return axis_comb(0), axis_comb(1), axis_comb(2)


def observe(cfg, xc, yc, zc, depth_m, gray, intrinsics):
    """The observation model shared by the dense and brick volumes: each
    voxel (camera coordinates ``xc``, ``yc``, ``zc``) samples the frame at
    its nearest pixel -> (valid, sdf, trunc, tsdf_obs, gray_s)."""
    h, w = depth_m.shape
    in_front = zc > cfg.min_depth
    z_safe = torch.where(in_front, zc, torch.ones_like(zc))
    u = intrinsics[0, 0] * xc / z_safe + intrinsics[0, 2]
    v = intrinsics[1, 1] * yc / z_safe + intrinsics[1, 2]
    ui = torch.round(u).to(torch.int32)
    vi = torch.round(v).to(torch.int32)
    in_view = in_front & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
    flat = (torch.clamp(vi, 0, h - 1) * w + torch.clamp(ui, 0, w - 1)).reshape(-1).long()
    depth_s = depth_m.reshape(-1)[flat].reshape(zc.shape)
    gray_s = gray.reshape(-1)[flat].reshape(zc.shape)
    sdf = depth_s - zc
    # The band widens with the OBSERVED depth (the measurement is the noise
    # source, not the voxel's position).
    trunc = cfg.truncation + cfg.truncation_scale_sq * depth_s * depth_s
    valid = in_view & (depth_s > 0.0) & (sdf > -trunc)
    tsdf_obs = torch.clamp(sdf / trunc, -1.0, 1.0)
    return valid, sdf, trunc, tsdf_obs, gray_s


def fuse(cfg, valid, sdf, trunc, tsdf_obs, gray_s, old_tsdf, old_w, old_gray):
    """Running weighted average of one observation -> (tsdf, weight, gray)."""
    if cfg.carve_decay > 0.0:
        conflict = valid & (sdf > trunc) & (old_tsdf < 0.25)
        old_w = torch.where(conflict, old_w * (1.0 - cfg.carve_decay), old_w)
    w_new = old_w + valid.to(torch.float32)
    w_safe = torch.clamp(w_new, min=1.0)
    tsdf_new = torch.where(valid, (old_tsdf * old_w + tsdf_obs) / w_safe, old_tsdf)
    gray_new = torch.where(valid, (old_gray * old_w + gray_s) / w_safe, old_gray)
    return tsdf_new, torch.clamp(w_new, max=cfg.max_weight), gray_new


def integrate_plain(volume: TSDFVolume, depth_m, gray, intrinsics, world_to_cam,
                    cfg: TSDFConfig) -> TSDFVolume:
    """:func:`integrate` in plain PyTorch, on any device, from float32
    tensors on the volume's device and the inverse pose ``world_to_cam``."""
    xc, yc, zc = _voxel_camera_coords(cfg, world_to_cam)
    obs = observe(cfg, xc, yc, zc, depth_m, gray, intrinsics)
    new = fuse(cfg, *obs, volume.tsdf, volume.weight, volume.gray)
    for field, value in zip(volume, new):
        field.copy_(value)
    return volume


def integrate(
    volume: TSDFVolume,
    depth_m,
    gray,
    intrinsics,
    pose,
    cfg: TSDFConfig,
) -> TSDFVolume:
    """Fuse one frame into ``volume`` in place; returns it.

    depth_m : (H, W) metric depth, 0 = invalid.
    gray : (H, W) intensity in [0, 255].
    pose : (4, 4) camera-to-world.

    A CPU volume takes :func:`integrate_plain`; any other goes to the
    kernel (``ops/cuda/tsdf.py``), which takes CUDA volumes (float32,
    contiguous) and raises on the rest.  The two agree bit for bit.
    """
    dev = volume.tsdf.device
    depth_m, gray = _f32(depth_m, dev), _f32(gray, dev)
    intrinsics, pose = _f32(intrinsics, dev), _f32(pose, dev)
    world_to_cam = se3.inverse(pose)
    if dev.type == "cpu":
        return integrate_plain(volume, depth_m, gray, intrinsics, world_to_cam, cfg)
    tsdf_kernel.integrate_volume(volume, depth_m, gray, intrinsics, world_to_cam,
                                 voxel_axes(cfg, dev), cfg)
    return volume


def integrate_frames(volume, frames, intrinsics, poses, cfg: TSDFConfig):
    """Fuse a sequence: ``frames`` an iterable of (depth_m, gray) with
    matching camera-to-world ``poses``; the volume stays on its device."""
    for (depth_m, gray), pose in zip(frames, poses):
        integrate(volume, depth_m, gray, intrinsics, pose, cfg)
    return volume


# ---------------------------------------------------------------------------
# Mesh extraction: vectorized marching tetrahedra (host numpy, one shot).
# ---------------------------------------------------------------------------

# Cube corners 0..7 as (dz, dy, dx); every tet contains the main diagonal
# 0-6, the 6-tet decomposition whose faces agree between neighbouring cubes.
_CORNER_OFFSETS = np.array(
    [
        (0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0),
        (1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0),
    ],
    dtype=np.int64,
)
_TETS = np.array(
    [
        (0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6),
        (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6),
    ],
    dtype=np.int64,
)
# The 6 edges of a tet as (corner, corner) local indices 0..3.
_TET_EDGES = np.array(
    [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)], dtype=np.int64
)
# Triangles (3 tet-edge indices each) by the 4-bit "inside" mask (bit i =
# vertex i has tsdf < 0): one vertex inside -> its 3 edges; two -> the quad
# of the 4 crossing edges as 2 triangles; three -> the triangle around the
# outside vertex.  Winding is fixed afterwards against the SDF gradient.
_TET_TRIS = {
    0b0001: [(0, 1, 2)],
    0b0010: [(0, 3, 4)],
    0b0100: [(1, 3, 5)],
    0b1000: [(2, 4, 5)],
    0b0011: [(1, 2, 3), (3, 2, 4)],
    0b0101: [(0, 2, 5), (0, 5, 3)],
    0b1001: [(0, 1, 4), (4, 1, 5)],
    0b0110: [(0, 1, 4), (4, 1, 5)],
    0b1010: [(0, 2, 5), (0, 5, 3)],
    0b1100: [(1, 2, 3), (3, 2, 4)],
    0b0111: [(2, 4, 5)],
    0b1011: [(1, 3, 5)],
    0b1101: [(0, 3, 4)],
    0b1110: [(0, 1, 2)],
}


def raycast_view(
    volume: TSDFVolume,
    intrinsics,
    pose,
    cfg: TSDFConfig,
    shape: Tuple[int, int],
    min_weight: float = 1.0,
    max_depth: float = 10.0,
    fill_passes: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render a virtual (depth, gray) view of the fused surface by splatting.

    Every near-surface voxel projects its SDF-corrected surface point into
    the view; a scatter-min of the int32 key (depth in voxel bins << 15 |
    |tsdf| in 7 bits << 8 | gray in 8 bits) over a 2x2 footprint resolves
    visibility (within a bin the voxel nearest the zero crossing wins), a
    second scatter-min recovers the winner's full-precision depth, and
    ``fill_passes`` valid-aware 3x3 min-dilations fill isolated holes.

    pose : (4, 4) camera-to-world of the virtual view.
    -> (depth_m (H, W) f32 with 0 = no surface, gray (H, W) f32).
    """
    h, w = shape
    dev = volume.tsdf.device
    intrinsics, pose = _f32(intrinsics, dev), _f32(pose, dev)
    xc, yc, zc = _voxel_camera_coords(cfg, se3.inverse(pose))
    tau = cfg.truncation + cfg.truncation_scale_sq * zc * zc
    z_surf = zc + volume.tsdf * tau
    near_surface = (
        (volume.weight >= min_weight)
        & (torch.abs(volume.tsdf) < 0.5)
        & (z_surf > cfg.min_depth)
        & (z_surf < max_depth)
    )
    one = torch.ones_like(zc)
    z_safe = torch.where(near_surface, z_surf, one)
    # The surface point lies on the ray through the voxel centre.
    scale_ray = z_surf / torch.where(zc > 1e-6, zc, one)
    u = intrinsics[0, 0] * xc * scale_ray / z_safe + intrinsics[0, 2]
    v = intrinsics[1, 1] * yc * scale_ray / z_safe + intrinsics[1, 2]

    # Truncation toward zero after the clip, as astype(int32).
    qbin = torch.clamp(z_surf / cfg.voxel_size, 0.0, 16383.0).to(torch.int32)
    qabs = torch.clamp(torch.abs(volume.tsdf) * 254.0, 0.0, 127.0).to(torch.int32)
    qg = torch.clamp(volume.gray, 0.0, 255.0).to(torch.int32)
    key = ((qbin << 15) | (qabs << 8) | qg).reshape(-1)
    init = 0x7FFFFFFF
    inf = float("inf")

    # 2x2 footprint: floor/ceil of (u, v) covers splat spacings up to 2 px,
    # so a back surface cannot show between front-surface splats.
    u0 = torch.floor(u).to(torch.int32)
    v0 = torch.floor(v).to(torch.int32)
    corners = []
    for dv in (0, 1):
        for du in (0, 1):
            ui = u0 + du
            vi = v0 + dv
            ok = near_surface & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
            idx = torch.where(ok, vi * w + ui, torch.full_like(ui, h * w))
            corners.append((ok.reshape(-1), idx.reshape(-1).long()))
    buf = torch.full((h * w + 1,), init, dtype=torch.int32, device=dev)
    init_t = torch.full_like(key, init)
    for ok, idx in corners:
        buf.scatter_reduce_(0, idx, torch.where(ok, key, init_t), "amin", include_self=True)

    # The winners' full-precision depth: a second scatter-min over exactly
    # the voxels whose key won their pixel.
    z_flat = z_surf.reshape(-1)
    inf_t = torch.full_like(z_flat, inf)
    zbuf = torch.full((h * w + 1,), inf, dtype=torch.float32, device=dev)
    for ok, idx in corners:
        winner = ok & (buf[idx] == key)
        zbuf.scatter_reduce_(0, idx, torch.where(winner, z_flat, inf_t), "amin",
                             include_self=True)
    img = buf[: h * w].reshape(h, w)
    zimg = zbuf[: h * w].reshape(h, w)

    for _ in range(fill_passes):
        # Holes take the valid neighbour with the least key (the nearest).
        padk = F.pad(img[None], (1, 1, 1, 1), value=init)[0]
        padz = F.pad(zimg[None], (1, 1, 1, 1), value=inf)[0]
        neigh, neighz = img, zimg
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                cand = padk[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
                take = cand < neigh
                neigh = torch.where(take, cand, neigh)
                neighz = torch.where(take, padz[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w], neighz)
        hole = img == init
        img = torch.where(hole, neigh, img)
        zimg = torch.where(hole, neighz, zimg)

    valid = (img != init) & torch.isfinite(zimg)
    zero = torch.zeros_like(zimg)
    depth = torch.where(valid, zimg, zero)
    gray = torch.where(valid, (img & 0xFF).to(torch.float32), zero)
    return depth, gray


class _Rays(NamedTuple):
    """World-frame rays of every pixel, scaled so that t is camera depth."""

    origin: torch.Tensor  # (3,)
    dwx: torch.Tensor  # (H, W)
    dwy: torch.Tensor
    dwz: torch.Tensor

    def point(self, t):
        return (self.origin[0] + self.dwx * t, self.origin[1] + self.dwy * t,
                self.origin[2] + self.dwz * t)


def pixel_directions(intrinsics: torch.Tensor, shape):
    """Camera-frame ray of every pixel as (dx, dy), its z being 1."""
    h, w = shape
    dev = intrinsics.device
    v_pix, u_pix = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev),
        torch.arange(w, dtype=torch.float32, device=dev), indexing="ij",
    )
    return ((u_pix - intrinsics[0, 2]) / intrinsics[0, 0],
            (v_pix - intrinsics[1, 2]) / intrinsics[1, 1])


def pixel_rays(intrinsics: torch.Tensor, pose: torch.Tensor, shape) -> _Rays:
    dx, dy = pixel_directions(intrinsics, shape)
    r = pose[:3, :3]
    return _Rays(
        origin=pose[:3, 3],
        dwx=r[0, 0] * dx + r[0, 1] * dy + r[0, 2],
        dwy=r[1, 0] * dx + r[1, 1] * dy + r[1, 2],
        dwz=r[2, 0] * dx + r[2, 1] * dy + r[2, 2],
    )


def trilinear_corners(cfg, rays: _Rays, t):
    """The 8 voxel corners around each ray's point at ``t``, clipped to the
    volume -> [(ix, iy, iz, weight)] (JAX ``tsdf.py:472-501``)."""
    d, hh, ww = cfg.dims
    vs = cfg.voxel_size
    ox, oy, oz = cfg.origin
    px, py, pz = rays.point(t)
    fx = (px - ox) / vs - 0.5
    fy = (py - oy) / vs - 0.5
    fz = (pz - oz) / vs - 0.5
    x0, y0, z0 = torch.floor(fx), torch.floor(fy), torch.floor(fz)
    wx1, wy1, wz1 = fx - x0, fy - y0, fz - z0
    x0, y0, z0 = x0.to(torch.int32), y0.to(torch.int32), z0.to(torch.int32)
    out = []
    for dz in (0, 1):
        for dyy in (0, 1):
            for dxx in (0, 1):
                wgt = ((wx1 if dxx else 1.0 - wx1) * (wy1 if dyy else 1.0 - wy1)
                       * (wz1 if dz else 1.0 - wz1))
                out.append((torch.clamp(x0 + dxx, 0, ww - 1), torch.clamp(y0 + dyy, 0, hh - 1),
                            torch.clamp(z0 + dz, 0, d - 1), wgt))
    return out


def trilinear_sample(cfg, rays: _Rays, field: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The flat volume ``field`` sampled trilinearly along each ray at ``t``
    (H, W)."""
    _, hh, ww = cfg.dims
    h, w = t.shape
    acc = torch.zeros((h, w), dtype=torch.float32, device=t.device)
    for ix, iy, iz, wgt in trilinear_corners(cfg, rays, t):
        flat = iz * (hh * ww) + iy * ww + ix
        acc = acc + wgt * field[flat.reshape(-1).long()].reshape(h, w)
    return acc


def refine_hits(cfg, valid, t_hit, sample_phi):
    """Two sphere-tracing steps on the trilinear field, t <- t + phi * tau
    (the march's sub-voxel refinement)."""
    for _ in range(2):
        tau_hit = cfg.truncation + cfg.truncation_scale_sq * t_hit * t_hit
        phi_t = sample_phi(t_hit)
        t_hit = torch.where(valid, t_hit + torch.clamp(phi_t, -0.5, 0.5) * tau_hit, t_hit)
    return t_hit


def raycast_view_march(
    volume: TSDFVolume,
    intrinsics,
    pose,
    cfg: TSDFConfig,
    shape: Tuple[int, int],
    min_weight: float = 1.0,
    max_depth: float = 10.0,
    n_steps: int = 96,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render a virtual (depth, gray) view by per-ray SDF marching.

    Each ray samples the field at its nearest voxel in ``n_steps`` fixed
    steps (t is camera depth), localizes the first positive-to-negative
    crossing by linear interpolation, then takes two sphere-tracing steps
    on the trilinear field; gray is sampled trilinearly at the hit.

    pose : (4, 4) camera-to-world.  -> (depth_m (H, W) f32 with 0 = no
    surface, gray (H, W) f32).
    """
    h, w = shape
    d, hh, ww = cfg.dims
    vs = cfg.voxel_size
    ox, oy, oz = cfg.origin
    dev = volume.tsdf.device
    intrinsics, pose = _f32(intrinsics, dev), _f32(pose, dev)

    # Unobserved or low-confidence voxels read as free space.
    phi_field = torch.where(volume.weight >= min_weight, volume.tsdf,
                            torch.ones_like(volume.tsdf)).reshape(-1)
    gray_field = volume.gray.reshape(-1)
    rays = pixel_rays(intrinsics, pose, shape)

    def sample_nearest(t):
        px, py, pz = rays.point(t)
        ix = torch.round((px - ox) / vs - 0.5).to(torch.int32)
        iy = torch.round((py - oy) / vs - 0.5).to(torch.int32)
        iz = torch.round((pz - oz) / vs - 0.5).to(torch.int32)
        inside = (ix >= 0) & (ix < ww) & (iy >= 0) & (iy < hh) & (iz >= 0) & (iz < d)
        flat = (torch.clamp(iz, 0, d - 1) * (hh * ww) + torch.clamp(iy, 0, hh - 1) * ww
                + torch.clamp(ix, 0, ww - 1))
        phi = phi_field[flat.reshape(-1).long()].reshape(h, w)
        return torch.where(inside, phi, torch.ones_like(phi))

    # dt is the float64 quotient rounded to float32, t = t0 + dt * (i + 1)
    # in float32 (JAX ``tsdf.py:458-463``).
    t0 = torch.tensor(cfg.min_depth, dtype=torch.float32, device=dev)
    dt = torch.tensor((max_depth - cfg.min_depth) / n_steps, dtype=torch.float32, device=dev)
    found = torch.zeros((h, w), dtype=torch.bool, device=dev)
    t_hit = torch.zeros((h, w), dtype=torch.float32, device=dev)
    phi_prev, t_prev = sample_nearest(t0), t0
    for i in range(n_steps):
        t = t0 + dt * float(i + 1)
        phi = sample_nearest(t)
        crossing = (~found) & (phi < 0.0) & (phi_prev >= 0.0)
        denom = torch.clamp(phi_prev - phi, min=1e-6)
        t_lin = t_prev + (t - t_prev) * phi_prev / denom
        t_hit = torch.where(crossing, t_lin, t_hit)
        found = found | crossing
        phi_prev, t_prev = phi, t
    return _surface(cfg, rays, phi_field, gray_field, found, t_hit)


def _surface(cfg, rays: _Rays, phi_field, gray_field, found, t_hit):
    """A march's crossings refined on the trilinear field, with their gray
    -> (depth_m with 0 = no surface, gray)."""
    # A ray whose first sample is already behind a surface is invalid.
    valid = found & (t_hit > cfg.min_depth)
    t_hit = refine_hits(cfg, valid, t_hit, lambda t: trilinear_sample(cfg, rays, phi_field, t))
    gray = trilinear_sample(cfg, rays, gray_field, t_hit)
    zero = torch.zeros_like(t_hit)
    return torch.where(valid, t_hit, zero), torch.where(valid, gray, zero)


# Steps the volume march samples as one batch: ~0.5 GB of temporaries at
# 640x480, and a tenth of the launches of one step at a time.
MARCH_CHUNK = 32
# The volume march's step in truncations: KinFu's raycast step, short
# enough that no ray steps over the negative band behind a surface.
VOLUME_MARCH_STEP = 0.8


def volume_box(cfg: TSDFConfig) -> Tuple[np.ndarray, np.ndarray]:
    """The volume's lowest and highest world corners, (x, y, z) float64."""
    lo = np.asarray(cfg.origin, np.float64)
    return lo, lo + np.asarray(cfg.dims[::-1], np.float64) * cfg.voxel_size


def volume_march_steps(cfg: TSDFConfig, pose, step: float, max_depth: float = 10.0) -> int:
    """Steps of :func:`raycast_view_march_volume` from ``pose`` ((4, 4)
    camera-to-world on the host): the camera depths the volume spans, from
    its nearest to its farthest corner within [min_depth, max_depth], over
    ``step``.  A ray's stretch inside the volume is never longer in camera
    depth, so every ray reaches its exit."""
    p = np.asarray(pose, np.float64)
    lo, hi = volume_box(cfg)
    corners = np.array([(x, y, z) for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                        for z in (lo[2], hi[2])])
    z = (corners - p[:3, 3]) @ p[:3, 2]
    near, far = max(float(z.min()), cfg.min_depth), min(float(z.max()), max_depth)
    return max(0, int(math.ceil((far - near) / step)))


def volume_ray_entry(cfg: TSDFConfig, rays: _Rays, max_depth: float) -> torch.Tensor:
    """Each ray's entry into the volume's box (camera depth, (H, W)), by
    the slab test, clipped to [min_depth, max_depth]."""
    lo, hi = volume_box(cfg)
    entry = torch.full_like(rays.dwx, cfg.min_depth)
    for a, d in enumerate((rays.dwx, rays.dwy, rays.dwz)):
        o = rays.origin[a]
        flat = d == 0.0
        safe = torch.where(flat, torch.ones_like(d), d)
        near = torch.minimum((float(lo[a]) - o) / safe, (float(hi[a]) - o) / safe)
        # A ray parallel to a slab enters it nowhere or everywhere.
        outside = (o < float(lo[a])) | (o > float(hi[a]))
        near = torch.where(flat, torch.where(outside, torch.full_like(d, math.inf),
                                             torch.full_like(d, -math.inf)), near)
        entry = torch.maximum(entry, near)
    return torch.clamp(entry, cfg.min_depth, max_depth)


def raycast_view_march_volume(
    volume: TSDFVolume,
    intrinsics,
    pose,
    cfg: TSDFConfig,
    shape: Tuple[int, int],
    n_steps: int,
    step: float,
    min_weight: float = 1.0,
    max_depth: float = 10.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render a virtual (depth, gray) view by marching each ray through the
    volume only, at a step tied to the truncation (KinectFusion's raycast).

    Each ray starts where it enters the volume's box (:func:`volume_ray_entry`)
    and samples the field at its nearest voxel every ``step`` meters of
    camera depth, ``n_steps`` times (:func:`volume_march_steps` from the
    same pose covers the volume's depth span); samples outside the volume
    read as free space.  The first positive-to-negative crossing, its
    linear localisation, the two sphere-tracing steps on the trilinear
    field and the trilinear gray are :func:`raycast_view_march`'s.

    A CPU volume takes :func:`raycast_view_march_volume_plain`; any other
    goes to the kernel (``ops/cuda/tsdf.py``), which takes CUDA volumes
    (float32, contiguous) and raises on the rest.  The two agree bit for bit.

    pose : (4, 4) camera-to-world.  -> (depth_m (H, W) f32 with 0 = no
    surface, gray (H, W) f32).
    """
    dev = volume.tsdf.device
    intrinsics, pose = _f32(intrinsics, dev), _f32(pose, dev)
    if dev.type == "cpu":
        return raycast_view_march_volume_plain(volume, intrinsics, pose, cfg, shape, n_steps,
                                               step, min_weight, max_depth)
    return tsdf_kernel.raycast_volume(volume, intrinsics, pose, cfg, shape, n_steps, step,
                                      min_weight, max_depth, volume_box(cfg))


def raycast_view_march_volume_plain(
    volume: TSDFVolume,
    intrinsics,
    pose,
    cfg: TSDFConfig,
    shape: Tuple[int, int],
    n_steps: int,
    step: float,
    min_weight: float = 1.0,
    max_depth: float = 10.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`raycast_view_march_volume` in plain PyTorch, on any device.
    The steps are taken :data:`MARCH_CHUNK` at a time as one batch of
    samples."""
    h, w = shape
    d, hh, ww = cfg.dims
    dev = volume.tsdf.device
    intrinsics, pose = _f32(intrinsics, dev), _f32(pose, dev)
    phi_field = torch.where(volume.weight >= min_weight, volume.tsdf,
                            torch.ones_like(volume.tsdf)).reshape(-1)
    rays = pixel_rays(intrinsics, pose, shape)
    t_in = volume_ray_entry(cfg, rays, max_depth).reshape(1, -1)

    # A sample's voxel coordinates, base + slope * t along each ray.
    vs = cfg.voxel_size
    base = ((rays.origin - _f32(cfg.origin, dev)) / vs - 0.5).reshape(1, 3, 1)
    slope = (torch.stack([rays.dwx, rays.dwy, rays.dwz]) / vs).reshape(1, 3, -1)
    top = torch.tensor([ww - 1, hh - 1, d - 1], dtype=torch.float32, device=dev).reshape(1, 3, 1)
    stride = torch.tensor([1, ww, hh * ww], dtype=torch.int64, device=dev).reshape(1, 3, 1)
    dt = torch.tensor(step, dtype=torch.float32, device=dev)

    found = torch.zeros(h * w, dtype=torch.bool, device=dev)
    t_hit = torch.zeros(h * w, dtype=torch.float32, device=dev)
    phi_prev = t_prev = None
    for a in range(0, n_steps + 1 if n_steps > 0 else 0, MARCH_CHUNK):
        i = torch.arange(a, min(a + MARCH_CHUNK, n_steps + 1), dtype=torch.float32, device=dev)
        t = t_in + dt * i[:, None]  # (S, rays)
        f = torch.round(base + slope * t[:, None, :])
        inside = ((f >= 0.0) & (f <= top)).all(1)
        flat = (torch.minimum(torch.clamp(f, min=0.0), top).long() * stride).sum(1)
        phi = torch.where(inside, phi_field[flat], torch.ones_like(t))
        if phi_prev is None:  # the entry sample has no predecessor
            before, t_before, phi, t = phi[:-1], t[:-1], phi[1:], t[1:]
        else:
            before = torch.cat([phi_prev[None], phi[:-1]])
            t_before = torch.cat([t_prev[None], t[:-1]])
        # The first positive-to-negative crossing of the chunk.
        crossing = (phi < 0.0) & (before >= 0.0)
        order = torch.arange(phi.shape[0], device=dev)[:, None]
        first = torch.where(crossing, order, phi.shape[0]).amin(0, keepdim=True)
        new = (first[0] < phi.shape[0]) & ~found
        first = torch.clamp(first, max=phi.shape[0] - 1)
        p0, p1 = before.gather(0, first)[0], phi.gather(0, first)[0]
        t0, t1 = t_before.gather(0, first)[0], t.gather(0, first)[0]
        denom = torch.clamp(p0 - p1, min=1e-6)
        t_hit = torch.where(new, t0 + (t1 - t0) * p0 / denom, t_hit)
        found = found | new
        phi_prev, t_prev = phi[-1], t[-1]
    return _surface(cfg, rays, phi_field, volume.gray.reshape(-1), found.reshape(h, w),
                    t_hit.reshape(h, w))


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _empty_mesh():
    return (np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64),
            np.zeros((0,), dtype=np.float32))


def extract_mesh(
    volume: TSDFVolume,
    cfg: TSDFConfig,
    min_weight: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """TSDF zero crossing -> triangle mesh, on the host.

    -> (vertices (V, 3) world-frame f64, faces (F, 3) int64,
    vertex_gray (V,) f32).  Vertices are shared between faces through their
    global edge id, so the mesh is watertight wherever the surface is.  An
    empty volume gives three empty arrays.
    """
    tsdf = _host(volume.tsdf).astype(np.float64)
    weight = _host(volume.weight).astype(np.float64)
    gray = _host(volume.gray).astype(np.float64)
    d, h, w = tsdf.shape

    observed = weight >= min_weight

    # Candidate cubes: all 8 corners observed and a sign change present.
    def corner_view(arr, dz, dy, dx):
        return arr[dz: d - 1 + dz, dy: h - 1 + dy, dx: w - 1 + dx]

    obs8 = np.ones((d - 1, h - 1, w - 1), dtype=bool)
    neg_any = np.zeros_like(obs8)
    pos_any = np.zeros_like(obs8)
    for dz, dy, dx in _CORNER_OFFSETS:
        cv = corner_view(tsdf, dz, dy, dx)
        obs8 &= corner_view(observed, dz, dy, dx)
        neg_any |= cv < 0
        pos_any |= cv >= 0
    cubes = np.argwhere(obs8 & neg_any & pos_any)  # (C, 3) of (z, y, x)
    if len(cubes) == 0:
        return _empty_mesh()

    corner_zyx = cubes[:, None, :] + _CORNER_OFFSETS[None, :, :]  # (C, 8, 3)
    gid = corner_zyx[..., 0] * (h * w) + corner_zyx[..., 1] * w + corner_zyx[..., 2]
    flat = tsdf.reshape(-1)
    vals = flat[gid]  # (C, 8)
    gflat = gray.reshape(-1)

    tri_edge_a = []  # global corner ids at each triangle vertex's edge ends
    tri_edge_b = []
    for tet in _TETS:
        tvals = vals[:, tet]  # (C, 4)
        tgid = gid[:, tet]
        inside = tvals < 0
        case = (
            inside[:, 0].astype(np.int64)
            | (inside[:, 1] << 1)
            | (inside[:, 2] << 2)
            | (inside[:, 3] << 3)
        )
        for code, tris in _TET_TRIS.items():
            sel = np.nonzero(case == code)[0]
            if len(sel) == 0:
                continue
            for tri in tris:
                ea = _TET_EDGES[list(tri)][:, 0]
                eb = _TET_EDGES[list(tri)][:, 1]
                tri_edge_a.append(tgid[sel][:, ea])  # (S, 3)
                tri_edge_b.append(tgid[sel][:, eb])

    if not tri_edge_a:
        return _empty_mesh()
    ea = np.concatenate(tri_edge_a)  # (T, 3) global corner ids
    eb = np.concatenate(tri_edge_b)

    # Shared vertices by undirected global edge key.
    lo = np.minimum(ea, eb).reshape(-1)
    hi = np.maximum(ea, eb).reshape(-1)
    key = lo * np.int64(d * h * w) + hi
    uniq, inverse = np.unique(key, return_inverse=True)
    faces = inverse.reshape(-1, 3)

    ulo = (uniq // (d * h * w)).astype(np.int64)
    uhi = (uniq % (d * h * w)).astype(np.int64)
    va, vb = flat[ulo], flat[uhi]
    t = va / (va - vb)  # zero crossing; va, vb have opposite signs
    t = np.clip(t, 0.0, 1.0)

    def gid_to_world(g):
        z = g // (h * w)
        y = (g % (h * w)) // w
        x = g % w
        p = np.stack([x, y, z], axis=-1).astype(np.float64) + 0.5
        return p * cfg.voxel_size + np.asarray(cfg.origin, dtype=np.float64)

    pa, pb = gid_to_world(ulo), gid_to_world(uhi)
    verts = pa + t[:, None] * (pb - pa)
    vert_gray = (gflat[ulo] + t * (gflat[uhi] - gflat[ulo])).astype(np.float32)

    # Drop degenerate faces (two vertices on the same global edge).
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[ok]

    # Consistent winding: flip faces whose normal opposes the SDF gradient
    # (which points from inside (-) to free space (+), the outward normal).
    gz, gy, gx = np.gradient(tsdf)
    centroids = verts[faces].mean(axis=1)
    ci = np.clip(
        np.round((centroids - np.asarray(cfg.origin)) / cfg.voxel_size - 0.5).astype(np.int64),
        0,
        np.array([w - 1, h - 1, d - 1]),
    )
    grad = np.stack(
        [
            gx[ci[:, 2], ci[:, 1], ci[:, 0]],
            gy[ci[:, 2], ci[:, 1], ci[:, 0]],
            gz[ci[:, 2], ci[:, 1], ci[:, 0]],
        ],
        axis=-1,
    )
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    n = np.cross(e1, e2)
    flip = np.einsum("ij,ij->i", n, grad) < 0
    faces[flip] = faces[flip][:, ::-1]

    return verts, faces, vert_gray


def save_mesh_ply(
    path,
    vertices: np.ndarray,
    faces: np.ndarray,
    vertex_gray: Optional[np.ndarray] = None,
) -> None:
    """ASCII PLY triangle-mesh writer (Open3D / MeshLab read it)."""
    path = Path(path)
    has_color = vertex_gray is not None and len(vertex_gray) == len(vertices)
    with path.open("w") as fp:
        fp.write("ply\nformat ascii 1.0\n")
        fp.write(f"element vertex {len(vertices)}\n")
        fp.write("property float x\nproperty float y\nproperty float z\n")
        if has_color:
            fp.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        fp.write(f"element face {len(faces)}\n")
        fp.write("property list uchar int vertex_indices\nend_header\n")
        if has_color:
            c = np.clip(vertex_gray, 0, 255).astype(np.int64)
            for (x, y, z), g in zip(vertices, c):
                fp.write(f"{x:.6f} {y:.6f} {z:.6f} {g} {g} {g}\n")
        else:
            for x, y, z in vertices:
                fp.write(f"{x:.6f} {y:.6f} {z:.6f}\n")
        for a, b, c3 in faces:
            fp.write(f"3 {a} {b} {c3}\n")


def save_mesh_obj(
    path,
    vertices: np.ndarray,
    faces: np.ndarray,
    vertex_gray: Optional[np.ndarray] = None,
) -> None:
    """Wavefront OBJ triangle-mesh writer (1-based faces); gray goes out as
    the ``v x y z r g b`` extension that MeshLab and Blender read."""
    path = Path(path)
    has_color = vertex_gray is not None and len(vertex_gray) == len(vertices)
    with path.open("w") as fp:
        fp.write("# dense-visual-odometry-tpu TSDF mesh\n")
        if has_color:
            c = np.clip(vertex_gray, 0, 255).astype(np.float64) / 255.0
            for (x, y, z), g in zip(vertices, c):
                fp.write(f"v {x:.6f} {y:.6f} {z:.6f} {g:.4f} {g:.4f} {g:.4f}\n")
        else:
            for x, y, z in vertices:
                fp.write(f"v {x:.6f} {y:.6f} {z:.6f}\n")
        for a, b, c3 in faces:
            fp.write(f"f {a + 1} {b + 1} {c3 + 1}\n")
