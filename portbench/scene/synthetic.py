"""Frozen numpy copy of the scene pieces of the port's ``io/synthetic.py``.

``textured_scene``, ``render_view``, ``handheld_trajectory``,
``degrade_gray``, ``degrade_depth`` and the TUM fr1 intrinsics, copied so
that a later change to the program cannot change what the benchmark
renders.  ``handheld_trajectory`` takes its two difficulty spans as
parameters (``rpy_span``, ``fast_span``; None leaves a span out); with the
defaults it is the original.  ``render.py`` renders the same views with
PyTorch on the card; the tests hold it against ``render_view`` here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# TUM RGB-D fr1 pinhole at 640x480.
TUM_FR1_INTRINSICS = np.array(
    [[517.3, 0.0, 318.6], [0.0, 516.5, 255.3], [0.0, 0.0, 1.0]], np.float32
)


def _smooth_noise(rng: np.random.Generator, height: int, width: int, cell: int) -> np.ndarray:
    """Bilinearly upsampled white noise on a grid of ``cell``-pixel cells."""
    gh, gw = height // cell + 2, width // cell + 2
    grid = rng.standard_normal((gh, gw))
    y = np.arange(height) / cell
    x = np.arange(width) / cell
    y0 = np.floor(y).astype(int)
    x0 = np.floor(x).astype(int)
    fy = (y - y0)[:, None]
    fx = (x - x0)[None, :]
    a = grid[y0][:, x0]
    b = grid[y0][:, x0 + 1]
    c = grid[y0 + 1][:, x0]
    d = grid[y0 + 1][:, x0 + 1]
    return (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy


def textured_scene(
    height: int = 480, width: int = 640, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (gray (H, W) float32 in [0, 255], depth (H, W) float32 meters,
    intrinsics (3, 3) float32): the TUM fr1 pinhole scaled to the size."""
    rng = np.random.default_rng(seed)
    scale = min(height, width) / 480.0
    tex = sum(
        amp * _smooth_noise(rng, height, width, max(2, int(round(cell * scale))))
        for cell, amp in ((6, 30.0), (14, 30.0), (40, 25.0))
    )
    gray = np.clip(128.0 + tex, 0.0, 255.0).astype(np.float32)
    bumps = _smooth_noise(rng, height, width, max(4, int(round(60 * scale))))
    ramp = np.linspace(0.0, 0.6, width)[None, :]
    depth = (1.4 + ramp + 0.25 * bumps).astype(np.float32)
    k = TUM_FR1_INTRINSICS.copy()
    k[0] *= width / 640.0
    k[1] *= height / 480.0
    return gray, depth, k


def render_view(
    gray: np.ndarray,
    depth_m: np.ndarray,
    intrinsics: np.ndarray,
    transform: np.ndarray,
    splat_radius: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Render the source frame as seen from ``transform`` (src-cam ->
    target-cam).  -> (gray', depth_m') with 0-depth holes.

    Two-stage forward splat: (1) a z-tested BILINEAR splat — each point
    distributes intensity/depth into its four neighbouring target pixels
    with tent weights, accumulated only within a relative depth band of
    the per-pixel nearest surface — so the rendered image is free of the
    ~half-pixel rounding noise a nearest-pixel splat bakes in (that
    rounding bias made photometric optima systematically offset from the
    ground truth); (2) pixels no bilinear footprint reached (forward
    magnification pinholes) fall back to the ring splat at
    ``splat_radius``."""
    h, w = depth_m.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]

    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    z = depth_m.reshape(-1)
    valid = z > 0
    x = ((u.reshape(-1) - cx) / fx * z)[valid]
    y = ((v.reshape(-1) - cy) / fy * z)[valid]
    zz = z[valid]
    g = gray.reshape(-1)[valid]

    pts = np.stack([x, y, zz], axis=-1) @ transform[:3, :3].T + transform[:3, 3]
    zt = pts[:, 2]
    front = zt > 1e-6
    pts, g, zt = pts[front], g[front], zt[front]

    uf = pts[:, 0] / zt * fx + cx
    vf = pts[:, 1] / zt * fy + cy

    # --- stage 1: z-tested bilinear splat ------------------------------
    x0 = np.floor(uf).astype(int)
    y0 = np.floor(vf).astype(int)
    zmin = np.full((h, w), np.inf, np.float32)
    corners = []
    for dy in (0, 1):
        for dx in (0, 1):
            uu, vv = x0 + dx, y0 + dy
            wgt = (1.0 - np.abs(uf - uu)) * (1.0 - np.abs(vf - vv))
            ok = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h) & (wgt > 1e-6)
            corners.append((uu[ok], vv[ok], wgt[ok], ok))
            np.minimum.at(zmin, (vv[ok], uu[ok]), zt[ok].astype(np.float32))
    wsum = np.zeros((h, w), np.float32)
    wg = np.zeros((h, w), np.float32)
    wz = np.zeros((h, w), np.float32)
    for uu, vv, wgt, ok in corners:
        # Accumulate only the nearest surface: points within 2% depth of
        # the per-pixel minimum; occluded points are excluded.
        near = zt[ok] <= zmin[vv, uu] * 1.02
        uu, vv, wgt = uu[near], vv[near], wgt[near]
        np.add.at(wsum, (vv, uu), wgt.astype(np.float32))
        np.add.at(wg, (vv, uu), (wgt * g[ok][near]).astype(np.float32))
        np.add.at(wz, (vv, uu), (wgt * zt[ok][near]).astype(np.float32))
    covered = wsum > 0.05
    out_gray = np.zeros((h, w), np.float32)
    out_depth = np.zeros((h, w), np.float32)
    out_gray[covered] = wg[covered] / wsum[covered]
    out_depth[covered] = wz[covered] / wsum[covered]

    # --- stage 2: ring-splat fallback for uncovered pixels -------------
    ut = np.round(uf).astype(int)
    vt = np.round(vf).astype(int)
    inside = (ut >= 0) & (ut < w) & (vt >= 0) & (vt < h)
    ut, vt, g, zt = ut[inside], vt[inside], g[inside], zt[inside]

    # Z-buffer ring splat: nearest point wins; fills pinholes the
    # bilinear footprint missed.  Writes only where stage 1 left holes.
    ring_gray = np.zeros((h, w), np.float32)
    ring_depth = np.zeros((h, w), np.float32)
    zbuf = np.full((h, w), np.inf, np.float32)
    order = np.argsort(-zt)  # far first, near overwrites within a pass
    zo, go = zt[order], g[order]
    # Center pass first, then growing splat rings; every pass only writes
    # where it is strictly nearer than the z-buffer so a far point's offset
    # splat in a later pass can never overwrite a near point's earlier
    # center write (cross-pass occlusion).
    offsets = sorted(
        (
            (dy, dx)
            for dy in range(-splat_radius, splat_radius + 1)
            for dx in range(-splat_radius, splat_radius + 1)
        ),
        key=lambda o: abs(o[0]) + abs(o[1]),
    )
    for dy, dx in offsets:
        uu = np.clip(ut[order] + dx, 0, w - 1)
        vv = np.clip(vt[order] + dy, 0, h - 1)
        nearer = zo < zbuf[vv, uu]
        uu, vv = uu[nearer], vv[nearer]
        # Later (nearer) writes win within this pass.
        zbuf[vv, uu] = zo[nearer]
        ring_gray[vv, uu] = go[nearer]
        ring_depth[vv, uu] = zo[nearer]
    holes = ~covered & (zbuf < np.inf)
    out_gray[holes] = ring_gray[holes]
    out_depth[holes] = ring_depth[holes]
    return out_gray, out_depth


# handheld_trajectory's difficulty spans: (start share, end share,
# translation gain, rotation gain).
RPY_SPAN = (0.40, 0.55, 0.3, 2.5)
FAST_SPAN = (0.70, 0.78, 1.8, 1.8)


def handheld_trajectory(
    n: int,
    seed: int = 0,
    t_step: float = 0.014,
    r_step: float = 0.008,
    excursion_t: float = 0.20,
    excursion_r: float = 0.22,
    rpy_span: Optional[Tuple[float, float, float, float]] = RPY_SPAN,
    fast_span: Optional[Tuple[float, float, float, float]] = FAST_SPAN,
) -> np.ndarray:
    """(N, 4, 4) camera-to-world poses with TUM-fr1-difficulty motion.

    Hand-held 6-DoF jitter as a smoothed (OU-filtered) random-walk
    velocity with a soft spring toward the origin, so per-frame motion
    matches fr1 statistics (fr1/desk averages ~0.413 m/s translational
    and ~23 deg/s rotational at 30 Hz => ~13.8 mm and ~0.77 deg per
    frame) while the total excursion stays inside the single-source-frame
    renderer's coverage envelope.  Three difficulty spans are embedded:

    - frames [0.40N, 0.55N): ROTATION-DOMINANT (rotation x2.5,
      translation x0.3 — the fr1/rpy regime, the classic dense-VO
      failure mode);
    - frames [0.70N, 0.78N): fast span (both x1.8 — approach/peak
      fr1 speeds);
    - elsewhere: nominal hand-held jitter.

    Each span is (start share, end share, translation gain, rotation
    gain); the first that holds a frame sets its gains.

    Defaults: mean per-frame translation ~ ``t_step`` (12 mm ~ fr1/desk),
    mean per-frame rotation ~ ``r_step`` rad (0.8 deg).
    """
    rng = np.random.default_rng(seed)
    # OU velocity: v <- a*v + noise; a sets smoothness (hand-held sweeps
    # persist over ~10 frames).
    a = 0.9
    noise_t = t_step * np.sqrt(1 - a * a)
    noise_r = r_step * np.sqrt(1 - a * a)
    v_t = np.zeros(3)
    v_r = np.zeros(3)
    pos = np.zeros(3)
    rvec = np.zeros(3)  # so3 log of camera-to-world rotation
    poses = []
    for t in range(n):
        gain_t, gain_r = 1.0, 1.0
        for span in (rpy_span, fast_span):
            if span is not None and int(span[0] * n) <= t < int(span[1] * n):
                gain_t, gain_r = span[2], span[3]
                break
        v_t = a * v_t + noise_t * rng.standard_normal(3)
        v_r = a * v_r + noise_r * rng.standard_normal(3)
        # Quadratic spring keeps the walk inside the renderable envelope
        # (the single-source-frame renderer loses coverage beyond
        # ~25 cm / ~17 deg): negligible near the origin, dominant at the
        # bound.
        pos = (pos + gain_t * v_t) * (
            1.0 - 0.2 * min((np.linalg.norm(pos) / excursion_t) ** 2, 1.5)
        )
        rvec = (rvec + gain_r * v_r) * (
            1.0 - 0.2 * min((np.linalg.norm(rvec) / excursion_r) ** 2, 1.5)
        )
        # Depth axis moves less (hand-held scanning keeps the subject
        # framed); fr1 z-motion is ~half the lateral motion.
        p = np.eye(4)
        p[:3, 3] = pos * np.array([1.0, 1.0, 0.5])
        theta = np.linalg.norm(rvec)
        if theta > 1e-12:
            k = rvec / theta
            kx = np.array(
                [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]]
            )
            p[:3, :3] = (
                np.eye(3)
                + np.sin(theta) * kx
                + (1 - np.cos(theta)) * (kx @ kx)
            )
        poses.append(p)
    return np.stack(poses)


def _window3x3(image: np.ndarray, op, fill: float) -> np.ndarray:
    """``op`` (np.maximum or np.minimum) over each pixel's 3x3 neighbourhood,
    pixels outside the image left out: cv2.dilate / cv2.erode with a 3x3
    kernel and their default border."""
    h, w = image.shape
    padded = np.full((h + 2, w + 2), fill, image.dtype)
    padded[1:-1, 1:-1] = image
    out = padded[0:h, 0:w]
    for dy in range(3):
        for dx in range(3):
            if dy or dx:
                out = op(out, padded[dy:dy + h, dx:dx + w])
    return out


def degrade_gray(
    gray: np.ndarray, frame_idx: int, rng: np.random.Generator,
    exposure_state: dict,
) -> np.ndarray:
    """Kinect-RGB-style photometric degradation: slowly-wandering
    auto-exposure (gain +-5%, bias +-4 DN — violating the solver's
    brightness-constancy assumption like TUM's auto-exposure does) plus
    per-pixel Gaussian sensor noise (sigma 2 DN)."""
    g = exposure_state.setdefault("gain", 1.0)
    b = exposure_state.setdefault("bias", 0.0)
    # AR(1) wander, clamped.
    g = float(np.clip(0.98 * g + 0.02 + 0.004 * rng.standard_normal(), 0.95, 1.05))
    b = float(np.clip(0.95 * b + 0.5 * rng.standard_normal(), -4.0, 4.0))
    exposure_state["gain"], exposure_state["bias"] = g, b
    noisy = g * gray + b + 2.0 * rng.standard_normal(gray.shape)
    return np.clip(noisy, 0.0, 255.0).astype(np.float32)


def degrade_depth(
    depth_m: np.ndarray, rng: np.random.Generator,
    fb: float = 43.5, disp_step: float = 0.125,
) -> np.ndarray:
    """Kinect-style depth degradation.

    1. Disparity quantization: the sensor measures disparity d = fb/z in
       1/8-px steps (f~580 px, baseline 7.5 cm => fb ~ 43.5 m*px), so
       depth resolution degrades quadratically: ~2.9 mm at 1 m, ~11.5 mm
       at 2 m — the dominant error on TUM depth.
    2. Edge dropout: pixels whose 3x3 depth neighbourhood spans a large
       relative jump lose their return with high probability (structured
       light fails on oblique/discontinuous surfaces).
    3. Random speckle dropout (~0.3%).
    """
    z = depth_m.copy()
    valid = z > 0
    disp = np.zeros_like(z)
    disp[valid] = fb / z[valid]
    disp_q = np.round(disp / disp_step) * disp_step
    z_q = np.zeros_like(z)
    ok = disp_q > 0
    z_q[valid & ok] = fb / disp_q[valid & ok]

    # Edge dropout: relative depth range over a 3x3 window.
    zmax = _window3x3(z, np.maximum, -np.inf)
    zmin_raw = z.copy()
    zmin_raw[~valid] = np.inf
    zmin = _window3x3(zmin_raw, np.minimum, np.inf)
    rel_jump = np.zeros_like(z)
    edge = valid & np.isfinite(zmin) & (zmin > 0)
    rel_jump[edge] = (zmax[edge] - zmin[edge]) / zmin[edge]
    drop_edge = edge & (rel_jump > 0.05) & (rng.random(z.shape) < 0.5)
    speckle = valid & (rng.random(z.shape) < 0.003)
    z_q[drop_edge | speckle] = 0.0
    return z_q


