"""Plain reference of a KinectFusion step's mapping, in float64 PyTorch: the
tier-1 tests' copy of ``portbench/reference/kinfu.py``, which the
benchmark keeps frozen; the two say the same.

It imports nothing of the port.  It works from a copy of the volume's
three fields (tsdf in truncation units, weight, running gray) taken before
a step, the step's raw frame (RGB uint8, depth uint16), the camera, the
poses the step started from and returned, and the configuration's stated
geometry (``Geometry``):

- ``fuse``: every voxel centre projected into the frame, the depth and
  luma of its nearest pixel (ties to even), the signed distance along the
  optical axis truncated to +-1 (an observation only where the depth is
  valid and the voxel lies less than a truncation behind it), and a running
  weighted average of tsdf and gray whose weight is capped;
- ``march``: each ray of the view from its entry into the volume's box, a
  sample at its nearest voxel every ``step`` meters of camera depth for
  ``march_steps`` steps (unobserved voxels and samples outside the box read
  as free space), the first positive-to-negative crossing localised
  linearly, two sphere-tracing steps on the trilinear field
  (t <- t + clip(phi, -1/2, 1/2) x truncation), and the gray sampled
  trilinearly at the hit.

The motion is solved by ``reference/dvo.refine`` on the render as the
template.  Where this departs from KinectFusion (Newcombe et al., ISMAR
2011) and PCL's KinFu: photometric tracking with a brightness bias instead
of point-to-plane ICP; a running gray kept in the voxels; the synthetic
scene of ``scene/`` instead of a recorded room.

Everything is float64, which TF32 never touches.  ``rnd`` computes the
same in TF32 (``dvo.tf32``): each product's inputs rounded to a 10-bit
mantissa, sums in float32 (the control).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

Round = Optional[Callable[[torch.Tensor], torch.Tensor]]
INF = float("inf")


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


class Geometry(NamedTuple):
    """The volume and fusion settings a configuration states."""

    dims: Tuple[int, int, int]  # (D, H, W) = (z, y, x) voxels
    voxel: float  # meters
    origin: Tuple[float, float, float]  # world (x, y, z) of the volume's corner
    truncation: float  # meters
    max_weight: float
    min_depth: float = 0.05
    min_weight: float = 1.0  # the render's confidence gate
    max_depth: float = 10.0  # the render's far limit

    def corners(self) -> np.ndarray:
        lo = np.asarray(self.origin, np.float64)
        hi = lo + np.asarray(self.dims[::-1], np.float64) * self.voxel
        return np.array([(x, y, z) for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                         for z in (lo[2], hi[2])])


def _dtype(rnd: Round):
    return torch.float64 if rnd is None else torch.float32


def fuse(fields, depth_m: torch.Tensor, gray: torch.Tensor, k, pose, geo: Geometry,
         z0: int, z1: int, rnd: Round = None):
    """Voxel planes [z0, z1) of ``fields`` (tsdf, weight, gray: (D, H, W)
    tensors) after fusing one frame (``depth_m``, ``gray``: (h, w)) seen
    from ``pose`` ((4, 4) camera-to-world) -> (tsdf, weight, gray) of those
    planes, float64 (float32 with ``rnd``)."""
    q = rnd or _same
    dt = _dtype(rnd)
    dev = fields[0].device
    _, hh, ww = geo.dims
    h, w = depth_m.shape
    p = torch.as_tensor(np.asarray(pose, np.float64), device=dev)
    r_inv = p[:3, :3].T
    t_inv = -(r_inv @ p[:3, 3])
    r_inv, t_inv = q(r_inv.to(dt)), t_inv.to(dt)
    ox, oy, oz = geo.origin
    xs = q(ox + (torch.arange(ww, dtype=dt, device=dev) + 0.5) * geo.voxel)[None, None, :]
    ys = q(oy + (torch.arange(hh, dtype=dt, device=dev) + 0.5) * geo.voxel)[None, :, None]
    zs = q(oz + (torch.arange(z0, z1, dtype=dt, device=dev) + 0.5) * geo.voxel)[:, None, None]
    xc, yc, zc = (r_inv[i, 0] * xs + r_inv[i, 1] * ys + r_inv[i, 2] * zs + t_inv[i]
                  for i in range(3))
    kk = q(torch.as_tensor(np.asarray(k, np.float64), device=dev).to(dt))
    front = zc > geo.min_depth
    zsafe = torch.where(front, zc, torch.ones_like(zc))
    u = kk[0, 0] * q(xc / zsafe) + kk[0, 2]
    v = kk[1, 1] * q(yc / zsafe) + kk[1, 2]
    ui, vi = torch.round(u).long(), torch.round(v).long()
    seen = front & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
    pix = (vi.clamp(0, h - 1) * w + ui.clamp(0, w - 1)).reshape(-1)
    z_obs = depth_m.to(dt).reshape(-1)[pix].reshape(zc.shape)
    g_obs = gray.to(dt).reshape(-1)[pix].reshape(zc.shape)
    sdf = z_obs - zc
    valid = seen & (z_obs > 0) & (sdf > -geo.truncation)
    obs = torch.clamp(sdf / geo.truncation, -1.0, 1.0)
    old_t, old_w, old_g = (f[z0:z1].to(dt) for f in fields)
    w_new = old_w + valid.to(dt)
    div = torch.clamp(w_new, min=1.0)
    new_t = torch.where(valid, (q(old_t) * q(old_w) + obs) / div, old_t)
    new_g = torch.where(valid, (q(old_g) * q(old_w) + g_obs) / div, old_g)
    return new_t, torch.clamp(w_new, max=geo.max_weight), new_g


def march_steps(geo: Geometry, pose, step: float) -> int:
    """Steps a ray takes: the camera depths the volume spans from ``pose``
    (its nearest to its farthest corner, within [min_depth, max_depth]) over
    ``step``."""
    p = np.asarray(pose, np.float64)
    z = (geo.corners() - p[:3, 3]) @ p[:3, 2]
    near, far = max(float(z.min()), geo.min_depth), min(float(z.max()), geo.max_depth)
    return max(0, int(np.ceil((far - near) / step)))


def _rays(k, pose, shape, dev, rnd: Round):
    """The world origin and per-pixel directions (3, h, w) of the view's
    rays, scaled so that t is camera depth."""
    q = rnd or _same
    dt = _dtype(rnd)
    h, w = shape
    kk = torch.as_tensor(np.asarray(k, np.float64), device=dev).to(dt)
    p = torch.as_tensor(np.asarray(pose, np.float64), device=dev).to(dt)
    v, u = torch.meshgrid(torch.arange(h, dtype=dt, device=dev),
                          torch.arange(w, dtype=dt, device=dev), indexing="ij")
    cam = torch.stack([(u - kk[0, 2]) / kk[0, 0], (v - kk[1, 2]) / kk[1, 1], torch.ones_like(u)])
    r = q(p[:3, :3])
    dirs = sum(r[:, j, None, None] * q(cam[j])[None] for j in range(3))
    return p[:3, 3], dirs


def _entry(geo: Geometry, origin, dirs) -> torch.Tensor:
    """Each ray's entry into the volume's box by the slab test, clipped to
    [min_depth, max_depth]."""
    lo = np.asarray(geo.origin, np.float64)
    hi = lo + np.asarray(geo.dims[::-1], np.float64) * geo.voxel
    t_in = torch.full_like(dirs[0], geo.min_depth)
    for a in range(3):
        d, o = dirs[a], origin[a]
        flat = d == 0
        safe = torch.where(flat, torch.ones_like(d), d)
        near = torch.minimum((lo[a] - o) / safe, (hi[a] - o) / safe)
        outside = bool(o < lo[a]) or bool(o > hi[a])
        near = torch.where(flat, torch.full_like(d, INF if outside else -INF), near)
        t_in = torch.maximum(t_in, near)
    return torch.clamp(t_in, geo.min_depth, geo.max_depth)


def _voxel_coords(geo: Geometry, origin, dirs, t, q):
    o = torch.as_tensor(geo.origin, dtype=t.dtype, device=t.device)
    return [(origin[a] + q(dirs[a]) * q(t) - o[a]) / geo.voxel - 0.5 for a in range(3)]


def _nearest(phi, geo: Geometry, origin, dirs, t, q) -> torch.Tensor:
    d, hh, ww = geo.dims
    fx, fy, fz = _voxel_coords(geo, origin, dirs, t, q)
    ix, iy, iz = torch.round(fx).long(), torch.round(fy).long(), torch.round(fz).long()
    inside = (ix >= 0) & (ix < ww) & (iy >= 0) & (iy < hh) & (iz >= 0) & (iz < d)
    flat = iz.clamp(0, d - 1) * (hh * ww) + iy.clamp(0, hh - 1) * ww + ix.clamp(0, ww - 1)
    return torch.where(inside, phi[flat].to(t.dtype), torch.ones_like(t))


def _trilinear(field, geo: Geometry, origin, dirs, t, q) -> torch.Tensor:
    d, hh, ww = geo.dims
    f = _voxel_coords(geo, origin, dirs, t, q)
    lo = [torch.floor(c) for c in f]
    frac = [c - b for c, b in zip(f, lo)]
    lo = [b.long() for b in lo]
    out = torch.zeros_like(t)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                wgt = ((frac[0] if dx else 1 - frac[0]) * (frac[1] if dy else 1 - frac[1])
                       * (frac[2] if dz else 1 - frac[2]))
                flat = ((lo[2] + dz).clamp(0, d - 1) * (hh * ww)
                        + (lo[1] + dy).clamp(0, hh - 1) * ww + (lo[0] + dx).clamp(0, ww - 1))
                out = out + q(wgt) * q(field[flat].to(t.dtype))
    return out


def march(fields, k, pose, geo: Geometry, shape, step: float, n_steps: int,
          rnd: Round = None, start: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The view from ``pose`` of the volume ``fields`` (tsdf, weight, gray)
    -> (depth_m (h, w) with 0 = no surface, gray), float64 (float32 with
    ``rnd``).  Every ray starts at its entry into the volume's box, or at
    the camera depth ``start`` where given."""
    q = rnd or _same
    dev = fields[0].device
    tsdf, weight, gray = (f.reshape(-1) for f in fields)
    phi = torch.where(weight >= geo.min_weight, tsdf, torch.ones_like(tsdf))
    origin, dirs = _rays(k, pose, shape, dev, rnd)
    t_in = _entry(geo, origin, dirs) if start is None else torch.full_like(dirs[0], start)
    dt = torch.tensor(step, dtype=t_in.dtype, device=dev)
    found = torch.zeros_like(t_in, dtype=torch.bool)
    t_hit = torch.zeros_like(t_in)
    t_prev = t_in
    phi_prev = _nearest(phi, geo, origin, dirs, t_prev, q)
    for i in range(1, n_steps + 1):
        t = t_in + dt * i
        phi_t = _nearest(phi, geo, origin, dirs, t, q)
        crossing = ~found & (phi_t < 0) & (phi_prev >= 0)
        denom = torch.clamp(phi_prev - phi_t, min=1e-6)
        t_hit = torch.where(crossing, t_prev + (t - t_prev) * phi_prev / denom, t_hit)
        found = found | crossing
        phi_prev, t_prev = phi_t, t
    valid = found & (t_hit > geo.min_depth)
    for _ in range(2):
        step_t = torch.clamp(_trilinear(phi, geo, origin, dirs, t_hit, q), -0.5, 0.5)
        t_hit = torch.where(valid, t_hit + step_t * geo.truncation, t_hit)
    g = _trilinear(gray, geo, origin, dirs, t_hit, q)
    zero = torch.zeros_like(t_hit)
    return torch.where(valid, t_hit, zero), torch.where(valid, g, zero)


def render_gaps(depth, depth_ref) -> Tuple[Optional[torch.Tensor], float]:
    """Depth gaps (mm) on the pixels both renders hit, and the share of the
    pixels either hit that only one hit, in %."""
    a, b = depth > 0, depth_ref > 0
    both = a & b
    either = int((a | b).sum())
    only = 100.0 * int((a ^ b).sum()) / max(either, 1)
    gaps = (depth.double() - depth_ref.double()).abs()[both] * 1e3
    return (gaps if gaps.numel() else None), only
