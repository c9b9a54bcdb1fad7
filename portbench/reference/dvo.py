"""Plain reference of what a tracking step computes, in float64 PyTorch.

It imports nothing of the port and takes nothing that the port made: it
works from the raw frames (RGB uint8, depth uint16) that the benchmark
rendered, the camera, and the tier's stated settings.

- ``pyramid``: BT.601 luma, depth in metres with points beyond the
  maximum distance dropped, and the 3x3 median (replicated borders) with
  decimation, level by level.
- ``refine``: the robust photometric solve of one pyramid level: the
  template's points on the tier's grid stride, warped by a rigid motion,
  the current image sampled bilinearly, t-distribution IRLS weights (5
  degrees of freedom, the scale's fixed point on every fourth grid point),
  an optional additive brightness bias, and Gauss-Newton steps on the left
  until they vanish.  Started from the true motion, it lands on the optimum
  that the tracker is meant to find.
- ``compose``: a stream's next pose, the previous pose times the inverse
  of the step's motion (the session's pose composition).

The control computes the same in TF32 (``tf32``): each product's two
inputs rounded to TF32's 10-bit mantissa (the luma, the depth scale, the
warp, the Jacobian, the normal equations, the pose compositions), sums in
float32.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

DOF = 5.0
SCALE_SUBSAMPLE = 4
BT601 = (0.299, 0.587, 0.114)
Round = Optional[Callable[[torch.Tensor], torch.Tensor]]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 rounded to TF32's 10-bit mantissa (to nearest,
    ties to even), as a tensor core reads a TF32 product's inputs."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & -0x2000
    return bits.view(torch.float32)


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def luma(rgb: torch.Tensor, rnd: Round = None) -> torch.Tensor:
    if rnd is None:
        x = rgb.double()
        return BT601[0] * x[..., 0] + BT601[1] * x[..., 1] + BT601[2] * x[..., 2]
    x = rnd(rgb.float())
    w = rnd(torch.tensor(BT601, dtype=torch.float32, device=rgb.device))
    return w[0] * x[..., 0] + w[1] * x[..., 1] + w[2] * x[..., 2]


def metres(depth_raw: torch.Tensor, depth_factor: float, max_distance: float,
           rnd: Round = None) -> torch.Tensor:
    raw = depth_raw.to(torch.int32)
    if rnd is None:
        z = raw.double() / depth_factor
    else:
        scale = torch.tensor(1.0 / depth_factor, dtype=torch.float32, device=raw.device)
        z = rnd(raw.float()) * rnd(scale)
    return torch.where(z > max_distance, torch.zeros_like(z), z)


def median3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 median of (P, H, W) with replicated borders."""
    p = F.pad(x[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    h, w = x.shape[-2:]
    stack = torch.stack([p[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)])
    return torch.median(stack, dim=0).values


def pyramid(x: torch.Tensor, levels: int) -> list:
    out = [x]
    for _ in range(1, levels):
        out.append(median3x3(out[-1])[:, ::2, ::2])
    return out


def sobel(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel gradients (Sobel / 8), the edge pixel repeated."""
    p = F.pad(img[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    h, w = img.shape[-2:]

    def win(dy, dx):
        return p[:, dy:dy + h, dx:dx + w]

    gx = (win(0, 2) + 2 * win(1, 2) + win(2, 2)) - (win(0, 0) + 2 * win(1, 0) + win(2, 0))
    gy = (win(2, 0) + 2 * win(2, 1) + win(2, 2)) - (win(0, 0) + 2 * win(0, 1) + win(0, 2))
    return gx / 8.0, gy / 8.0


def bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(P, H, W) sampled at (P, N) coordinates known to be in bounds."""
    h, w = img.shape[-2:]
    x0, y0 = torch.floor(u), torch.floor(v)
    fx, fy = u - x0, v - y0
    x0 = x0.long().clamp(0, w - 2)
    y0 = y0.long().clamp(0, h - 2)
    flat = img.reshape(img.shape[0], -1)

    def at(yy, xx):
        return torch.gather(flat, 1, yy * w + xx)

    top = at(y0, x0) * (1 - fx) + at(y0, x0 + 1) * fx
    bot = at(y0 + 1, x0) * (1 - fx) + at(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(P, 6) [v, w] -> (P, 4, 4)."""
    v, w = xi[:, :3], xi[:, 3:]
    th = torch.linalg.norm(w, dim=1)[:, None, None]
    zero = torch.zeros_like(w[:, 0])
    wx = torch.stack([torch.stack([zero, -w[:, 2], w[:, 1]], -1),
                      torch.stack([w[:, 2], zero, -w[:, 0]], -1),
                      torch.stack([-w[:, 1], w[:, 0], zero], -1)], 1)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand_as(wx)
    small = th < 1e-8
    th_s = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1 - th**2 / 6, torch.sin(th_s) / th_s)
    b = torch.where(small, 0.5 - th**2 / 24, (1 - torch.cos(th_s)) / th_s**2)
    c = torch.where(small, 1 / 6 - th**2 / 120, (th_s - torch.sin(th_s)) / th_s**3)
    wx2 = wx @ wx
    r = eye + a * wx + b * wx2
    vv = (eye + b * wx + c * wx2) @ v[:, :, None]
    out = torch.zeros((xi.shape[0], 4, 4), dtype=xi.dtype, device=xi.device)
    out[:, :3, :3], out[:, :3, 3:], out[:, 3, 3] = r, vv, 1.0
    return out


def t_weights(r: torch.Tensor, valid: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
    """t-distribution IRLS weights; the scale's fixed point on every
    SCALE_SUBSAMPLE-th grid row and column, iterated to convergence."""
    p = r.shape[0]
    r2 = r * r
    vf = valid.to(r.dtype)
    sub = (slice(None), slice(None, None, SCALE_SUBSAMPLE), slice(None, None, SCALE_SUBSAMPLE))
    r_est = r2.reshape(p, *grid)[sub].reshape(p, -1)
    v_est = vf.reshape(p, *grid)[sub].reshape(p, -1)
    count = v_est.sum(1).clamp(min=1.0)
    lam = torch.full((p,), 1.0 / 25.0, dtype=r.dtype, device=r.device)
    tol = 1e-9 if r.dtype == torch.float64 else 1e-6
    for _ in range(100):
        sig2 = (v_est * r_est * (DOF + 1) / (DOF + r_est * lam[:, None])).sum(1) / count
        new = 1.0 / sig2.clamp(min=1e-20)
        done = bool(((new - lam).abs() <= tol * new).all())
        lam = new
        if done:
            break
    return vf * (DOF + 1) / (DOF + r2 * lam[:, None])


def refine(gray_prev, depth_prev, gray_curr, k, transform, stride: int, bias: bool,
           iterations: int = 30, template_jacobian: bool = False, rnd: Round = None) -> torch.Tensor:
    """The level's robust photometric optimum near ``transform``.

    gray_prev, depth_prev, gray_curr: (P, H, W) float64 of one level (float32
    with ``rnd``, which rounds each product's inputs); k: (3, 3) that level's
    intrinsics; transform (P, 4, 4), previous camera -> current camera.
    -> (P, 4, 4)."""
    q = rnd or _same
    dt = torch.float64 if rnd is None else torch.float32
    gray_prev, depth_prev, gray_curr = (a.to(dt) for a in (gray_prev, depth_prev, gray_curr))
    k = k.to(dt)
    p, h, w = gray_curr.shape
    g0 = gray_prev[:, ::stride, ::stride]
    z = depth_prev[:, ::stride, ::stride]
    grid = tuple(z.shape[-2:])
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    uu = torch.arange(grid[1], dtype=dt, device=z.device) * stride
    vv = torch.arange(grid[0], dtype=dt, device=z.device) * stride
    x = q((uu[None, None, :] - cx) / fx) * q(z)
    y = q((vv[None, :, None] - cy) / fy) * q(z)
    x, y = x.reshape(p, -1), y.reshape(p, -1)
    zz = z.reshape(p, -1)
    g0 = g0.reshape(p, -1)
    gx_img, gy_img = sobel(gray_curr)
    tgx, tgy = (q(g[:, ::stride, ::stride].reshape(p, -1)) * q(f)
                for g, f in zip(sobel(gray_prev), (k[0, 0], k[1, 1])))
    t = transform.to(dt).clone()
    beta = torch.zeros(p, dtype=dt, device=z.device)
    qx, qy, qz = q(x), q(y), q(zz)
    for _ in range(iterations):
        r_, tr = q(t[:, :3, :3]), t[:, :3, 3]
        xc = r_[:, 0, 0, None] * qx + r_[:, 0, 1, None] * qy + r_[:, 0, 2, None] * qz + tr[:, 0, None]
        yc = r_[:, 1, 0, None] * qx + r_[:, 1, 1, None] * qy + r_[:, 1, 2, None] * qz + tr[:, 1, None]
        zc = r_[:, 2, 0, None] * qx + r_[:, 2, 1, None] * qy + r_[:, 2, 2, None] * qz + tr[:, 2, None]
        front = (zz > 0) & (zc > 1e-6)
        zs = torch.where(front, zc, torch.ones_like(zc))
        u = q(fx) * q(xc / zs) + cx
        v = q(fy) * q(yc / zs) + cy
        valid = (front & (torch.floor(u) >= 0) & (torch.floor(v) >= 0)
                 & (torch.floor(u) + 1 <= w - 1) & (torch.floor(v) + 1 <= h - 1))
        uc = torch.where(valid, u, torch.zeros_like(u))
        vc = torch.where(valid, v, torch.zeros_like(v))
        res = bilinear(gray_curr, uc, vc) + beta[:, None] - g0
        res = torch.where(valid, res, torch.zeros_like(res))
        if template_jacobian:
            gx, gy, px, py, pz = tgx, tgy, x, y, torch.where(zz > 0, zz, torch.ones_like(zz))
        else:
            gx, gy, px, py, pz = (q(bilinear(gx_img, uc, vc)) * q(fx),
                                  q(bilinear(gy_img, uc, vc)) * q(fy), xc, yc, zs)
        gx, gy, px, py, iz = q(gx), q(gy), q(px), q(py), q(1.0 / pz)
        pxz, pyz = q(px * iz), q(py * iz)
        cols = [gx * iz, gy * iz, -q(gx * pxz + gy * pyz) * iz,
                -gx * q(pxz * pyz) - gy * (1 + q(pyz * pyz)),
                gx * (1 + q(pxz * pxz)) + gy * q(pxz * pyz),
                -gx * pyz + gy * pxz]
        if bias:
            cols.append(torch.ones_like(gx))
        jac = torch.stack(cols, -1) * valid[..., None]
        wts = t_weights(res, valid, grid)
        jw = q(jac * wts[..., None])
        hess = jw.transpose(1, 2) @ q(jac)
        rhs = -(jw.transpose(1, 2) @ q(res)[..., None])[..., 0]
        step = torch.linalg.solve(hess, rhs)
        inc = q(se3_exp(step[:, :6]))
        t = q(t) @ inc if template_jacobian else inc @ q(t)
        if bias:
            beta = beta + step[:, 6]
        if float(step[:, :6].abs().max()) < 1e-12:
            break
    return t


def compose(pose: torch.Tensor, motion: torch.Tensor, rnd: Round = None) -> torch.Tensor:
    """The next pose, ``pose @ inv(motion)``, (P, 4, 4)."""
    if rnd is None:
        return pose.double() @ torch.linalg.inv(motion.double())
    inv = torch.linalg.inv(motion.float())
    return rnd(pose.float()) @ rnd(inv)


def motion_gap(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per pair: translation (mm) and rotation (deg) of inv(a) @ b."""
    d = torch.linalg.inv(a) @ b
    tr = torch.linalg.norm(d[:, :3, 3], dim=1) * 1e3
    # atan2 of the skew part and the trace: exact at small angles, where
    # the trace of a float32 rotation alone rounds to no angle at all.
    skew = torch.stack([d[:, 2, 1] - d[:, 1, 2], d[:, 0, 2] - d[:, 2, 0],
                        d[:, 1, 0] - d[:, 0, 1]], 1)
    sin = torch.linalg.norm(skew, dim=1) / 2
    cos = (d[:, 0, 0] + d[:, 1, 1] + d[:, 2, 2] - 1) / 2
    return tr, torch.rad2deg(torch.atan2(sin, cos))
