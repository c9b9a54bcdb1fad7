"""Trajectory accuracy metrics: ATE, RPE, per-frame errors (numpy, float64).

A copy of ``dense_visual_odometry_tpu/metrics.py``: the same arithmetic, so
equal inputs give equal results bit for bit.  The reference computed only
per-frame translational error ``||t_est - t_gt||`` and rotational error
``||log(R_est) - log(R_gt)||`` and left ATE to TUM's tools; here ATE-RMSE
(with the Horn/Umeyama SE(3) alignment) and RPE are computed in the package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _rotmat_log(rot: np.ndarray) -> np.ndarray:
    """Axis-angle vector of a rotation matrix (batched, numpy, float64)."""
    tr = np.clip((np.trace(rot, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(tr)
    w = np.stack(
        [
            rot[..., 2, 1] - rot[..., 1, 2],
            rot[..., 0, 2] - rot[..., 2, 0],
            rot[..., 1, 0] - rot[..., 0, 1],
        ],
        axis=-1,
    )
    sin_theta = np.sin(theta)
    scale = np.where(
        np.abs(sin_theta) < 1e-7, 0.5, theta / np.maximum(2.0 * sin_theta, 1e-12)
    )
    return scale[..., None] * w


def per_frame_errors(
    est_poses: np.ndarray, gt_poses: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference-compatible per-frame errors (test_dvo.py:313-314).

    -> (translational (N,) meters, rotational (N,) radians-ish: the norm of
    the difference of the two axis-angle vectors, as in the reference).
    """
    est = np.asarray(est_poses, dtype=np.float64)
    gt = np.asarray(gt_poses, dtype=np.float64)
    trans = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=-1)
    rot = np.linalg.norm(
        _rotmat_log(est[:, :3, :3]) - _rotmat_log(gt[:, :3, :3]), axis=-1
    )
    return trans, rot


def align_umeyama(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares SE(3) alignment (no scale): R, t minimizing
    ``||R @ src + t - dst||``.  -> 4x4 matrix.  Horn's method via SVD."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(src)
    u, _, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1.0
    rot = u @ s @ vt
    t = mu_d - rot @ mu_s
    out = np.eye(4)
    out[:3, :3] = rot
    out[:3, 3] = t
    return out


def ate_rmse(
    est_poses: np.ndarray, gt_poses: np.ndarray, align: bool = True
) -> Tuple[float, np.ndarray]:
    """Absolute trajectory error RMSE over translations (TUM definition).

    -> (rmse meters, per-frame translation errors (N,)).
    """
    est = np.asarray(est_poses, dtype=np.float64)[:, :3, 3]
    gt = np.asarray(gt_poses, dtype=np.float64)[:, :3, 3]
    if align and len(est) >= 3:
        t = align_umeyama(est, gt)
        est = est @ t[:3, :3].T + t[:3, 3]
    err = np.linalg.norm(est - gt, axis=-1)
    return float(np.sqrt(np.mean(err**2))), err


def rpe(
    est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1
) -> Tuple[float, float]:
    """Relative pose error over frame gaps of ``delta``.

    -> (translational RMSE meters, rotational RMSE radians).
    """
    est = np.asarray(est_poses, dtype=np.float64)
    gt = np.asarray(gt_poses, dtype=np.float64)
    n = len(est) - delta
    if n < 1:
        return 0.0, 0.0
    t_errs, r_errs = [], []
    for i in range(n):
        rel_est = np.linalg.inv(est[i]) @ est[i + delta]
        rel_gt = np.linalg.inv(gt[i]) @ gt[i + delta]
        err = np.linalg.inv(rel_gt) @ rel_est
        t_errs.append(np.linalg.norm(err[:3, 3]))
        r_errs.append(np.linalg.norm(_rotmat_log(err[:3, :3])))
    return float(np.sqrt(np.mean(np.square(t_errs)))), float(
        np.sqrt(np.mean(np.square(r_errs)))
    )
