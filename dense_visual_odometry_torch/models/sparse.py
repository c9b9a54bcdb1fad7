"""Sparse feature-based visual odometry.

Counterpart of ``dense_visual_odometry_tpu/models/sparse.py``: match 2-D
features between frames, deproject the matches through depth, fit a rigid
motion robustly (weighted Procrustes inside RANSAC), gate it, and polish it
by a motion-only reprojection refinement.  Every shape is fixed (masks
instead of compaction), and a pair is one device program up to the session's
one host read of ``success``:

- :func:`harris_corners`: the top-``k`` Harris scores after an 8x8
  cell-max spread;
- :func:`match_patches`: ZNCC of each corner's patch against a search
  window in the next frame, with a parabola subpixel peak;
- :func:`fit_from_matches`: the depth-edge gate, deprojection, RANSAC, the
  success gates and :func:`refine_reprojection`;
- :func:`track_sparse` and :class:`SparseVO`, the frame-to-frame session
  (with ``matcher="learned"`` the LoFTR-lite matcher of
  :mod:`dense_visual_odometry_torch.models.matcher`).

Rankings keep the lower index first among equal values, as ``jax.lax.top_k``
does (``ransac.first_top_k``).  RANSAC's minimal samples come from a
``sampler`` callable or a ``torch.Generator`` (``utils/ransac.py``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dense_visual_odometry_torch.camera import CameraModel
from dense_visual_odometry_torch.ops.gradients import sobel
from dense_visual_odometry_torch.utils.lie import se3
from dense_visual_odometry_torch.utils.ransac import first_top_k, ransac_rigid

# A sampler draws RANSAC's minimal samples: (sample_mask (N,) bool,
# hypotheses, sample_size) -> (hypotheses, sample_size) row indices.
Sampler = Callable[[torch.Tensor, int, int], torch.Tensor]


class Matches(NamedTuple):
    """Corresponded pixel coordinates + confidence, fixed-size with validity."""

    uv_prev: torch.Tensor  # (K, 2) float32 (u, v) in the previous frame
    uv_curr: torch.Tensor  # (K, 2) float32 in the current frame
    confidence: torch.Tensor  # (K,) float32 in [0, 1]
    valid: torch.Tensor  # (K,) bool


class SparseResult(NamedTuple):
    transform: torch.Tensor  # (4, 4) prev-cam -> curr-cam
    success: torch.Tensor  # bool
    rmse: torch.Tensor  # float32 final fit RMSE (meters)
    inlier_count: torch.Tensor  # int32


def box5(x: torch.Tensor) -> torch.Tensor:
    """5x5 box sum with zero borders, as two passes of shifted-plane sums
    added in the JAX package's order (rows first, each from the top)."""
    h, w = x.shape[-2:]
    p = F.pad(x, (2, 2, 2, 2))
    vert = p[0:h, 2:2 + w]
    for i in range(1, 5):
        vert = vert + p[i:i + h, 2:2 + w]
    p2 = F.pad(vert, (2, 2))
    out = p2[:, 0:w]
    for i in range(1, 5):
        out = out + p2[:, i:i + w]
    return out


def harris_scores(gray: torch.Tensor, border: int = 8, kappa: float = 0.04) -> torch.Tensor:
    """(H, W) Harris scores after the 8x8 cell-max spread: -inf outside a
    ``border`` margin, off each cell's maxima and in the rows and columns
    past the last whole cell."""
    h, w = gray.shape[-2:]
    gx, gy = sobel(gray)
    gx, gy = gx / 8.0, gy / 8.0
    ixx, iyy, ixy = box5(gx * gx), box5(gy * gy), box5(gx * gy)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    score = det - kappa * tr * tr

    dev = gray.device
    v_idx = torch.arange(h, device=dev)[:, None]
    u_idx = torch.arange(w, device=dev)[None, :]
    inside = ((v_idx >= border) & (v_idx < h - border)
              & (u_idx >= border) & (u_idx < w - border))
    score = score.masked_fill(~inside, float("-inf"))

    ch, cw = h // 8, w // 8
    cells = score[: ch * 8, : cw * 8].reshape(ch, 8, cw, 8)
    cell_max = cells.amax(dim=(1, 3), keepdim=True)
    is_cell_max = (cells == cell_max) & (cells > float("-inf"))
    spread = cells.masked_fill(~is_cell_max, float("-inf")).reshape(ch * 8, cw * 8)
    return F.pad(spread, (0, w - cw * 8, 0, h - ch * 8), value=float("-inf"))


def harris_corners(
    gray: torch.Tensor, k: int = 256, border: int = 8, kappa: float = 0.04
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` Harris corners of an (H, W) image -> ((k, 2) float (u, v),
    (k,) scores).  The output size is fixed: weak images return low-score
    corners, and callers threshold the scores."""
    w = gray.shape[-1]
    flat = harris_scores(gray, border, kappa).reshape(-1)
    top_idx = first_top_k(flat, k)
    top_scores = flat[top_idx]
    vs = torch.div(top_idx, w, rounding_mode="floor").to(torch.float32)
    us = (top_idx % w).to(torch.float32)
    return torch.stack([us, vs], dim=-1), top_scores


def _offsets(radius: int, device) -> torch.Tensor:
    """((2r+1)^2, 2) int32 (du, dv) offsets, rows of v outermost."""
    r = torch.arange(-radius, radius + 1, dtype=torch.int32, device=device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1)


def _take(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixels of ``img`` at integer (u, v), clamped to the image."""
    h, w = img.shape[-2:]
    u = uv[..., 0].clamp(0, w - 1)
    v = uv[..., 1].clamp(0, h - 1)
    return img.reshape(-1)[v * w + u]


def match_patches(
    gray_prev: torch.Tensor,
    gray_curr: torch.Tensor,
    corners_prev: torch.Tensor,
    *,
    patch: int = 7,
    search: int = 12,
    min_zncc: float = 0.6,
    centers_curr: Optional[torch.Tensor] = None,
) -> Matches:
    """ZNCC template matching of ``patch`` x ``patch`` windows around each
    previous-frame corner against a (2*search+1)^2 window in the current
    frame: one (K, P^2) x (K, S^2, P^2) correlation, the first maximum, and
    a 1-D parabola through its neighbours along each axis.

    ``centers_curr`` recentres each search window at a predicted
    current-frame location (the fine stage of a coarse-to-fine matcher).
    """
    half = patch // 2
    k = corners_prev.shape[0]
    h, w = gray_prev.shape[-2:]
    dev = gray_prev.device
    patch_off = _offsets(half, dev)  # (P^2, 2)
    search_off = _offsets(search, dev)  # (S^2, 2)

    # int32 pixel indices, as the JAX package's: the (K, S^2, P^2) candidate
    # indices are the largest tensor of the pair (1,024 x 625 x 49).
    c = torch.round(corners_prev).to(torch.int32)
    cc = c if centers_curr is None else torch.round(centers_curr).to(torch.int32)

    tpl = _take(gray_prev, c[:, None, :] + patch_off[None])  # (K, P^2)
    tpl = tpl - tpl.mean(-1, keepdim=True)
    tpl_norm = torch.sqrt((tpl * tpl).sum(-1) + 1e-6)

    cand_uv = cc[:, None, None, :] + search_off[None, :, None, :] + patch_off[None, None]
    cand = _take(gray_curr, cand_uv)  # (K, S^2, P^2)
    cand = cand - cand.mean(-1, keepdim=True)
    cand_norm = torch.sqrt((cand * cand).sum(-1) + 1e-6)

    zncc = torch.einsum("kp,ksp->ks", tpl, cand) / (tpl_norm[:, None] * cand_norm)
    best = torch.argmax(zncc, dim=-1)
    best_score = zncc.gather(1, best[:, None])[:, 0]

    s_dim = 2 * search + 1
    zgrid = zncc.reshape(k, s_dim, s_dim)
    by = torch.div(best, s_dim, rounding_mode="floor")
    bx = best % s_dim
    rows = torch.arange(k, device=dev)

    def neighbor(dy_, dx_):
        return zgrid[rows, (by + dy_).clamp(0, s_dim - 1), (bx + dx_).clamp(0, s_dim - 1)]

    def parabola(zm, zp, interior):
        denom = zm - 2.0 * best_score + zp
        off = torch.where(denom.abs() > 1e-9, 0.5 * (zm - zp) / denom,
                          torch.zeros_like(denom))
        return torch.where(interior, off.clamp(-0.5, 0.5), torch.zeros_like(off))

    sub_dx = parabola(neighbor(0, -1), neighbor(0, 1), (bx > 0) & (bx < s_dim - 1))
    sub_dy = parabola(neighbor(-1, 0), neighbor(1, 0), (by > 0) & (by < s_dim - 1))
    subpixel = torch.stack([sub_dx, sub_dy], dim=-1)

    uv_curr = cc.to(torch.float32) + search_off[best].to(torch.float32) + subpixel
    in_bounds = ((uv_curr[:, 0] >= half) & (uv_curr[:, 0] < w - half)
                 & (uv_curr[:, 1] >= half) & (uv_curr[:, 1] < h - half))
    return Matches(
        uv_prev=corners_prev.to(torch.float32),
        uv_curr=uv_curr,
        confidence=best_score,
        valid=(best_score >= min_zncc) & in_bounds,
    )


def refine_reprojection(
    transform0: torch.Tensor,
    pts_prev: torch.Tensor,
    uv_curr: torch.Tensor,
    weights: torch.Tensor,
    intrinsics: torch.Tensor,
    iterations: int = 8,
    huber_px: float = 2.0,
) -> torch.Tensor:
    """Motion-only reprojection refinement (sparse Gauss-Newton PnP): a
    fixed ``iterations`` steps on ``pi(T X_prev) - uv_curr`` with Huber
    weights in pixels, each solving the damped 6x6 normal equations; a
    non-finite step is dropped.  Nothing is read back to the host.

    pts_prev : (K, 3) previous-camera points; uv_curr (K, 2) matched pixels;
    weights (K,) (0 disables a row).  Returns the refined (4, 4).
    """
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    eye6 = torch.eye(6, dtype=torch.float32, device=pts_prev.device)
    t = transform0
    for _ in range(iterations):
        pts = pts_prev @ t[:3, :3].T + t[:3, 3]
        z = pts[:, 2]
        ok = (z > 1e-6) & (weights > 0.0)
        z_safe = torch.where(ok, z, torch.ones_like(z))
        u = fx * pts[:, 0] / z_safe + cx
        v = fy * pts[:, 1] / z_safe + cy
        r = torch.stack([u - uv_curr[:, 0], v - uv_curr[:, 1]], dim=-1)
        r = torch.where(ok[:, None], r, torch.zeros_like(r))
        rn = torch.linalg.vector_norm(r, dim=-1)
        w_h = torch.where(rn <= huber_px, torch.ones_like(rn),
                          huber_px / torch.clamp(rn, min=1e-9))
        wt = weights * w_h * ok.to(torch.float32)
        inv_z = 1.0 / z_safe
        x, y = pts[:, 0], pts[:, 1]
        zeros = torch.zeros_like(z)
        ju = fx * torch.stack([inv_z, zeros, -x * inv_z * inv_z, -x * y * inv_z * inv_z,
                               1.0 + x * x * inv_z * inv_z, -y * inv_z], dim=-1)
        jv = fy * torch.stack([zeros, inv_z, -y * inv_z * inv_z,
                               -(1.0 + y * y * inv_z * inv_z), x * y * inv_z * inv_z,
                               x * inv_z], dim=-1)
        hess = (torch.einsum("k,ki,kj->ij", wt, ju, ju)
                + torch.einsum("k,ki,kj->ij", wt, jv, jv))
        rhs = -(torch.einsum("k,ki->i", wt * r[:, 0], ju)
                + torch.einsum("k,ki->i", wt * r[:, 1], jv))
        damp = 1e-8 * (1.0 + torch.trace(hess))
        # solve_ex: no error check, so no host read; a singular system
        # gives a non-finite step, which the guard drops.
        delta = torch.linalg.solve_ex(hess + damp * eye6, rhs)[0]
        delta = torch.where(torch.isfinite(delta).all(), delta, torch.zeros_like(delta))
        t = se3.exp(delta) @ t
    return t


def _deproject(uv, depth, fx, fy, cx, cy, depth_edge_tol):
    """(K, 2) pixels -> ((K, 3) points, (K,) ok): the depth at the rounded
    pixel, valid where positive and where its 3x3 neighbourhood's positive
    depths span at most ``depth_edge_tol * max(z, 0.5)``."""
    h, w = depth.shape[-2:]
    ui = torch.round(uv[:, 0]).to(torch.int64).clamp(0, w - 1)
    vi = torch.round(uv[:, 1]).to(torch.int64).clamp(0, h - 1)
    flat = depth.reshape(-1)
    z = flat[vi * w + ui]
    zmin = torch.full_like(z, float("inf"))
    zmax = torch.zeros_like(z)
    for dv_ in (-1, 0, 1):
        for du_ in (-1, 0, 1):
            zn = flat[(vi + dv_).clamp(0, h - 1) * w + (ui + du_).clamp(0, w - 1)]
            pos = zn > 0.0
            zmin = torch.where(pos, torch.minimum(zmin, zn), zmin)
            zmax = torch.where(pos, torch.maximum(zmax, zn), zmax)
    flat_depth = (zmax - zmin) <= depth_edge_tol * torch.clamp(z, min=0.5)
    x = (uv[:, 0] - cx) / fx * z
    y = (uv[:, 1] - cy) / fy * z
    return torch.stack([x, y, z], dim=-1), (z > 0.0) & flat_depth


def ransac_inputs(matches: Matches, depth_prev_m, depth_curr_m, intrinsics,
                  depth_edge_tol: float = 0.05):
    """The RANSAC problem of ``matches`` -> (src, dst, valid, pts_prev): both
    ends deprojected and depth-gated, the rows valid where the match and
    both gates are, and invalid rows on a +-1e6 sentinel that is never an
    inlier; ``pts_prev`` keeps every row's previous-frame point."""
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    pts_prev, ok_prev = _deproject(matches.uv_prev, depth_prev_m, fx, fy, cx, cy,
                                   depth_edge_tol)
    pts_curr, ok_curr = _deproject(matches.uv_curr, depth_curr_m, fx, fy, cx, cy,
                                   depth_edge_tol)
    valid = matches.valid & ok_prev & ok_curr
    src = pts_prev.masked_fill(~valid[:, None], 1e6)
    dst = pts_curr.masked_fill(~valid[:, None], -1e6)
    return src, dst, valid, pts_prev


def fit_from_matches(
    matches: Matches,
    depth_prev_m: torch.Tensor,
    depth_curr_m: torch.Tensor,
    intrinsics: torch.Tensor,
    *,
    sampler: Optional[Sampler] = None,
    generator: Optional[torch.Generator] = None,
    min_matches: int = 12,
    ransac_threshold: float = 0.05,
    max_rmse: float = 0.10,
    num_hypotheses: int = 64,
    depth_edge_tol: float = 0.05,
    refine_iterations: int = 8,
    refine_huber_px: float = 2.0,
) -> SparseResult:
    """Matches -> robust SE(3): the depth gate and deprojection
    (:func:`ransac_inputs`), RANSAC over every row (invalid rows are never
    sampled), the success gates (a valid fit, at least ``min_matches`` valid
    rows, RMSE at most ``max_rmse``, at least ``min_matches // 2`` inliers)
    and the reprojection refinement on the inliers.  The minimal samples
    come from ``sampler`` (given the valid rows) or else from
    ``generator``."""
    src, dst, valid, pts_prev = ransac_inputs(matches, depth_prev_m, depth_curr_m,
                                              intrinsics, depth_edge_tol)
    n_valid = valid.to(torch.int32).sum()
    sample_size = 4
    result = ransac_rigid(
        src, dst,
        sample_indices=None if sampler is None else sampler(valid, num_hypotheses, sample_size),
        generator=generator, threshold=ransac_threshold, sample_size=sample_size,
        num_hypotheses=num_hypotheses, weights=matches.confidence * valid.to(torch.float32),
        sample_mask=valid,
    )
    success = (result.fit.valid & (n_valid >= min_matches)
               & (result.fit.rmse <= max_rmse)
               & (result.inlier_count >= min_matches // 2))
    w_refine = matches.confidence * (valid & result.inliers).to(torch.float32)
    refined = refine_reprojection(result.fit.transform, pts_prev, matches.uv_curr, w_refine,
                                  intrinsics, iterations=refine_iterations,
                                  huber_px=refine_huber_px)
    transform = torch.where(torch.isfinite(refined).all(), refined, result.fit.transform)
    return SparseResult(transform=transform, success=success, rmse=result.fit.rmse,
                        inlier_count=result.inlier_count)


def track_sparse(
    gray_prev: torch.Tensor,
    depth_prev_m: torch.Tensor,
    gray_curr: torch.Tensor,
    depth_curr_m: torch.Tensor,
    intrinsics: torch.Tensor,
    *,
    sampler: Optional[Sampler] = None,
    generator: Optional[torch.Generator] = None,
    num_corners: int = 256,
    min_corner_score: float = 1.0,
    cycle_tolerance: Optional[float] = 1.5,
    **fit_kwargs,
) -> SparseResult:
    """Sparse alignment of one frame pair: Harris corners, ZNCC matches
    (kept where the corner scores at least ``min_corner_score``), the
    forward-backward check (each match matched back into the previous frame
    must land within ``cycle_tolerance`` pixels of its corner; None turns it
    off) and :func:`fit_from_matches`."""
    corners, scores = harris_corners(gray_prev, k=num_corners)
    matches = match_patches(gray_prev, gray_curr, corners)
    matches = matches._replace(valid=matches.valid & (scores >= min_corner_score))
    if cycle_tolerance is not None:
        back = match_patches(gray_curr, gray_prev, matches.uv_curr)
        cycle_err = torch.linalg.vector_norm(back.uv_curr - matches.uv_prev, dim=-1)
        matches = matches._replace(
            valid=matches.valid & back.valid & (cycle_err <= cycle_tolerance))
    return fit_from_matches(matches, depth_prev_m, depth_curr_m, intrinsics,
                            sampler=sampler, generator=generator, **fit_kwargs)


class SparseVO:
    """Frame-to-frame sparse odometry session.

    Defaults are the JAX package's: 1024 corners (Harris + ZNCC) or the
    LoFTR-lite matcher (``matcher="learned"``: the committed weights, or
    ``matcher_weights``, loaded once onto the device), and a depth-edge
    tolerance of 0.03.  RANSAC's samples come from ``sampler(step,
    sample_mask, hypotheses, sample_size)`` where given (``step`` counts the
    tracked pairs from 0), else from a CPU ``torch.Generator`` seeded with
    ``seed``.  A step reads one value back to the host, ``success``; a
    failed pair keeps the pose and the previous frame.  It runs on the GPU
    unless ``device`` says otherwise; frames go up through pinned memory.
    """

    def __init__(self, camera: CameraModel, seed: int = 0, matcher: str = "zncc",
                 matcher_weights=None, sampler=None, device=None, **kwargs):
        from dense_visual_odometry_torch.models.robust import resolve_device

        self.camera = camera
        self.device = resolve_device(device)
        self.generator = torch.Generator().manual_seed(seed)
        self.sampler = sampler
        self.steps = 0
        self._prev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._pose = torch.eye(4, dtype=torch.float32, device=self.device)
        self._k = camera.intrinsics.to(self.device)
        self.last_result: Optional[SparseResult] = None
        if matcher == "learned":
            from dense_visual_odometry_torch.models import matcher as matcher_mod

            self.model = matcher_mod.load_matcher(
                matcher_mod.DEFAULT_WEIGHTS if matcher_weights is None else matcher_weights,
                self.device)
            self._kwargs = {"depth_edge_tol": 0.03, **kwargs}
            self._track = lambda *a, **kw: matcher_mod.track_sparse_learned(
                self.model, *a, **kw)
        elif matcher == "zncc":
            self.model = None
            self._kwargs = {"num_corners": 1024, "depth_edge_tol": 0.03, **kwargs}
            self._track = track_sparse
        else:
            raise ValueError(f"unknown matcher {matcher!r}: 'zncc' or 'learned'")

    def _upload(self, x) -> torch.Tensor:
        """A frame on the session's device; from the host through pinned
        memory, so that the copy does not wait for the card."""
        from dense_visual_odometry_torch.models.robust import as_device_tensor

        if isinstance(x, torch.Tensor) or self.device.type != "cuda":
            return as_device_tensor(x, self.device)
        x = np.asarray(x)
        if x.dtype in (np.uint16, np.uint32):
            x = x.astype(np.int64)
        return torch.from_numpy(np.ascontiguousarray(x)).pin_memory().to(
            self.device, non_blocking=True)

    def _frame(self, gray, depth_raw):
        from dense_visual_odometry_torch.ops.pyramid import preprocess_depth

        gray = self._upload(gray).to(torch.float32)
        depth_m = preprocess_depth(self._upload(depth_raw), self.camera.depth_scale)
        return gray, depth_m

    def step(self, gray, depth_raw) -> torch.Tensor:
        """Track one frame -> the (4, 4) camera-to-world pose on the device."""
        gray, depth_m = self._frame(gray, depth_raw)
        if self._prev is None:
            self._prev = (gray, depth_m)
            return self._pose
        if self.sampler is not None:
            step, sampler = self.steps, self.sampler
            kw = {"sampler": lambda mask, h, s: sampler(step, mask, h, s)}
        else:
            kw = {"generator": self.generator}
        result = self._track(self._prev[0], self._prev[1], gray, depth_m, self._k,
                             **kw, **self._kwargs)
        self.steps += 1
        self.last_result = result
        if bool(result.success):
            self._pose = self._pose @ se3.inverse(result.transform)
            self._prev = (gray, depth_m)
        return self._pose
