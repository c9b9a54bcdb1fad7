"""The benchmark's frames, made on the card from a seed.

``render_view`` is ``synthetic.render_view`` in PyTorch: the same two-stage
forward splat (a z-tested bilinear splat, then a ring splat into the holes),
with the geometry in float64 and the accumulations in float32 as the numpy
version has them; duplicates that numpy's fancy assignment resolves by the
last write are resolved the same way, by the largest position.
``degrade_gray`` and ``degrade_depth`` are the numpy versions' Kinect
models with the per-pixel noise drawn from a ``torch.Generator`` on the
device.  ``make_pool`` renders a pool of frames along a trajectory and
stores them as a sensor delivers them: RGB uint8 and depth uint16.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


def render_view(gray: torch.Tensor, depth_m: torch.Tensor, intrinsics, transform,
                splat_radius: int = 1):
    """The source frame (``gray``, ``depth_m``: (H, W) float32 on one
    device) seen from ``transform`` (src-cam -> target-cam, (4, 4)) ->
    (gray', depth_m') float32 with 0-depth holes."""
    dev = gray.device
    h, w = depth_m.shape
    k = torch.as_tensor(np.asarray(intrinsics, np.float32), device=dev)
    fx, fy = k[0, 0].double(), k[1, 1].double()
    cx, cy = k[0, 2].double(), k[1, 2].double()
    tr = torch.as_tensor(np.asarray(transform, np.float64), device=dev)

    v, u = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                          indexing="ij")
    z = depth_m.reshape(-1)
    valid = z > 0
    zd = z.double()
    x = ((u.reshape(-1) - cx) / fx * zd)[valid]
    y = ((v.reshape(-1) - cy) / fy * zd)[valid]
    zz = zd[valid]
    g = gray.reshape(-1)[valid]

    pts = torch.stack([x, y, zz], dim=-1) @ tr[:3, :3].T + tr[:3, 3]
    zt = pts[:, 2]
    front = zt > 1e-6
    pts, g, zt = pts[front], g[front], zt[front]
    uf = pts[:, 0] / zt * fx + cx
    vf = pts[:, 1] / zt * fy + cy

    # Stage 1: z-tested bilinear splat.
    x0 = torch.floor(uf).long()
    y0 = torch.floor(vf).long()
    zt32 = zt.float()
    zmin = torch.full((h * w,), math.inf, dtype=torch.float32, device=dev)
    corners = []
    for dy in (0, 1):
        for dx in (0, 1):
            uu, vv = x0 + dx, y0 + dy
            wgt = (1.0 - torch.abs(uf - uu)) * (1.0 - torch.abs(vf - vv))
            ok = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h) & (wgt > 1e-6)
            flat = vv[ok] * w + uu[ok]
            corners.append((flat, wgt[ok], ok))
            zmin.scatter_reduce_(0, flat, zt32[ok], reduce="amin")
    wsum = torch.zeros(h * w, dtype=torch.float32, device=dev)
    wg = torch.zeros_like(wsum)
    wz = torch.zeros_like(wsum)
    for flat, wgt, ok in corners:
        near = zt[ok] <= (zmin[flat] * 1.02)
        flat, wgt = flat[near], wgt[near]
        wsum.index_add_(0, flat, wgt.float())
        wg.index_add_(0, flat, (wgt * g[ok][near]).float())
        wz.index_add_(0, flat, (wgt * zt[ok][near]).float())
    covered = wsum > 0.05
    safe = torch.where(covered, wsum, torch.ones_like(wsum))
    out_gray = torch.where(covered, wg / safe, torch.zeros_like(wg))
    out_depth = torch.where(covered, wz / safe, torch.zeros_like(wz))

    # Stage 2: ring splat, nearest point first, into the holes.
    ut = torch.round(uf).long()
    vt = torch.round(vf).long()
    inside = (ut >= 0) & (ut < w) & (vt >= 0) & (vt < h)
    ut, vt, g, zt = ut[inside], vt[inside], g[inside], zt[inside]
    order = torch.argsort(-zt, stable=True)
    zo, go = zt[order], g[order]
    ring_gray = torch.zeros(h * w, dtype=torch.float32, device=dev)
    ring_depth = torch.zeros_like(ring_gray)
    zbuf = torch.full((h * w,), math.inf, dtype=torch.float32, device=dev)
    offsets = sorted(
        ((dy, dx) for dy in range(-splat_radius, splat_radius + 1)
         for dx in range(-splat_radius, splat_radius + 1)),
        key=lambda o: abs(o[0]) + abs(o[1]),
    )
    position = torch.arange(zo.numel(), device=dev)
    for dy, dx in offsets:
        uu = torch.clamp(ut[order] + dx, 0, w - 1)
        vv = torch.clamp(vt[order] + dy, 0, h - 1)
        flat = vv * w + uu
        nearer = zo < zbuf[flat].double()
        flat, pos = flat[nearer], position[nearer]
        # numpy's assignment keeps the last write of each pixel.
        last = torch.full((h * w,), -1, dtype=torch.long, device=dev)
        last.scatter_reduce_(0, flat, pos, reduce="amax")
        hit = last >= 0
        idx = last[hit]
        zbuf[hit] = zo[idx].float()
        ring_gray[hit] = go[idx]
        ring_depth[hit] = zo[idx].float()
    holes = ~covered & torch.isfinite(zbuf)
    out_gray = torch.where(holes, ring_gray, out_gray)
    out_depth = torch.where(holes, ring_depth, out_depth)
    return out_gray.reshape(h, w), out_depth.reshape(h, w)


def exposure_walk(n: int, rng: np.random.Generator):
    """``synthetic.degrade_gray``'s auto-exposure wander over ``n`` frames
    -> (gains, biases) lists."""
    g, b, gains, biases = 1.0, 0.0, [], []
    for _ in range(n):
        g = float(np.clip(0.98 * g + 0.02 + 0.004 * rng.standard_normal(), 0.95, 1.05))
        b = float(np.clip(0.95 * b + 0.5 * rng.standard_normal(), -4.0, 4.0))
        gains.append(g)
        biases.append(b)
    return gains, biases


def degrade_gray(gray: torch.Tensor, gain: float, bias: float, gen: torch.Generator):
    """Exposure gain and bias plus Gaussian sensor noise (sigma 2 DN)."""
    noise = torch.randn(gray.shape, generator=gen, device=gray.device)
    return torch.clamp(gain * gray + bias + 2.0 * noise, 0.0, 255.0)


def degrade_depth(depth_m: torch.Tensor, gen: torch.Generator, fb: float = 43.5,
                  disp_step: float = 0.125) -> torch.Tensor:
    """Disparity quantisation, edge dropout and speckle, as
    ``synthetic.degrade_depth``."""
    z = depth_m
    valid = z > 0
    disp = torch.where(valid, fb / torch.where(valid, z, torch.ones_like(z)), torch.zeros_like(z))
    disp_q = torch.round(disp / disp_step) * disp_step
    ok = valid & (disp_q > 0)
    z_q = torch.where(ok, fb / torch.where(ok, disp_q, torch.ones_like(disp_q)),
                      torch.zeros_like(z))
    # 3x3 max and min with the pixels outside the image left out.
    zmax = F.max_pool2d(z[None, None], 3, stride=1, padding=1)[0, 0]
    zmin_raw = torch.where(valid, z, torch.full_like(z, math.inf))
    zmin = -F.max_pool2d(-zmin_raw[None, None], 3, stride=1, padding=1)[0, 0]
    edge = valid & torch.isfinite(zmin) & (zmin > 0)
    rel_jump = torch.where(edge, (zmax - zmin) / torch.where(edge, zmin, torch.ones_like(zmin)),
                           torch.zeros_like(z))
    drop_edge = edge & (rel_jump > 0.05) & (torch.rand(z.shape, generator=gen, device=z.device) < 0.5)
    speckle = valid & (torch.rand(z.shape, generator=gen, device=z.device) < 0.003)
    return torch.where(drop_edge | speckle, torch.zeros_like(z_q), z_q)


def chroma_rgb(gray: torch.Tensor, chroma: torch.Tensor) -> torch.Tensor:
    """RGB uint8 whose BT.601 luma is ``gray`` before rounding: red and
    green carry a chroma field that cancels in the luma."""
    r = gray + chroma
    g = gray - (0.299 / 0.587) * chroma
    rgb = torch.stack([r, g, gray], dim=-1)
    return torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)


def make_pool(scene_gray: np.ndarray, scene_depth: np.ndarray, intrinsics: np.ndarray,
              poses: np.ndarray, seed: int, depth_factor: float, chroma: np.ndarray,
              device) -> Dict[str, torch.Tensor]:
    """Render ``poses`` (N, 4, 4 camera-to-world) of the source frame on
    ``device`` and degrade them with noise drawn from ``seed`` ->
    {"rgb": (N, H, W, 3) uint8, "depth": (N, H, W) uint16 held as the bits of
    int16 (``.view(torch.uint16)``; the values stay below 2^15), which every
    device's gather and stack kernels take}."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    gains, biases = exposure_walk(len(poses), np.random.default_rng(seed))
    g_src = torch.as_tensor(scene_gray, device=device)
    d_src = torch.as_tensor(scene_depth, device=device)
    chroma_t = torch.as_tensor(chroma, dtype=torch.float32, device=device)
    rgbs, depths = [], []
    for pose, gain, bias in zip(poses, gains, biases):
        g, d = render_view(g_src, d_src, intrinsics, np.linalg.inv(pose))
        rgbs.append(chroma_rgb(degrade_gray(g, gain, bias, gen), chroma_t))
        dn = torch.round(degrade_depth(d, gen) * depth_factor)
        depths.append(dn.to(torch.int16))
    return {"rgb": torch.stack(rgbs), "depth": torch.stack(depths)}
