"""Trajectory and point-cloud visualizer.

Counterpart of ``dense_visual_odometry_tpu/apps/visualize.py``: replay a
run's report JSON (or a TUM trajectory file) as 3-D geometry, headless:

- a matplotlib 3-D figure (estimated against ground-truth trajectory, camera
  axes every few frames) written to PNG;
- a PLY point cloud of every ``--stride``-th frame deprojected into the world
  by its estimated pose (any external viewer reads it);
- an animated replay GIF (``--animate``): each frame's decimated cloud with
  the camera frustum and trail walking along.

Usage::

    python -m dense_visual_odometry_torch.apps.visualize report out/report.json -o out/traj.png
    python -m dense_visual_odometry_torch.apps.visualize report out/report.json --ply out/cloud.ply

The depth deprojection runs on the GPU; ``--platform cpu`` runs it on the
CPU.  The frames are read from the directory the report names (a bundled
set or a TUM directory, with the camera YAML the report records for a TUM
one).  matplotlib draws the figure and the GIF (the Agg backend), imported
only when they are drawn.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path

import numpy as np

logger = logging.getLogger("dvo.visualize")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Visualize a DVO run")
    p.add_argument("mode", choices=["report", "trajectory"])
    p.add_argument("path", type=str, help="report.json or trajectory.txt")
    p.add_argument("-o", "--output", type=str, default=None, help="PNG path")
    p.add_argument("--ply", type=str, default=None, help="write PLY point cloud here")
    p.add_argument("--benchmark", type=str, default=None,
                   help="dataset type for PLY depth lookup (test / tum dir)")
    p.add_argument("--stride", type=int, default=3, help="keyframe stride for PLY")
    p.add_argument("--max-points", type=int, default=200_000)
    p.add_argument("--animate", type=str, default=None,
                   help="write an animated replay (GIF) here: per-frame point cloud "
                   "+ camera frustum walk")
    p.add_argument("--animate-stride", type=int, default=1,
                   help="use every Nth frame in the animation")
    p.add_argument("--animate-fps", type=float, default=5.0)
    p.add_argument("--platform", type=str, default=None, choices=["cuda", "cpu"],
                   help="the deprojection's device (default: the GPU)")
    return p.parse_args(argv)


def _pyplot():
    """matplotlib's pyplot on the Agg backend; a clear error without it."""
    try:
        import matplotlib
    except ImportError as exc:
        raise RuntimeError("the figure and the animated replay need matplotlib, "
                           "which does not import here") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def load_poses(mode: str, path: Path):
    """-> (est_poses (N,4,4), gt_poses or None, sequence_info dict)."""
    if mode == "report":
        data = json.loads(path.read_text())
        est = np.asarray(data["estimated_poses"], dtype=np.float64)
        gt = (np.asarray(data["ground_truth_poses"], dtype=np.float64)
              if "ground_truth_poses" in data else None)
        return est, gt, data.get("sequence", {})
    from dense_visual_odometry_torch.io import trajectory

    _, est = trajectory.load_tum_trajectory(path)
    return est, None, {}


def plot_trajectories(est, gt, out_path: Path) -> Path:
    plt = _pyplot()
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(projection="3d")
    t = est[:, :3, 3]
    ax.plot(t[:, 0], t[:, 1], t[:, 2], "-o", ms=2, label="estimated")
    if gt is not None:
        # Ground truth relative to its first pose, as the benchmark scores it.
        gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
        g = gt_rel[:, :3, 3]
        ax.plot(g[:, 0], g[:, 1], g[:, 2], "-^", ms=2, label="ground truth")
    for pose in est[:: max(1, len(est) // 10)]:
        o = pose[:3, 3]
        for axis, color in zip(pose[:3, :3].T, "rgb"):
            seg = np.stack([o, o + 0.05 * axis])
            ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], color=color, lw=1)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    plt.close(fig)
    return out_path


def write_ply(path: Path, points: np.ndarray, colors: np.ndarray) -> Path:
    """ASCII PLY of an (N,3) float cloud with (N,3) uint8 colors."""
    header = "\n".join([
        "ply",
        "format ascii 1.0",
        f"element vertex {len(points)}",
        "property float x",
        "property float y",
        "property float z",
        "property uchar red",
        "property uchar green",
        "property uchar blue",
        "end_header",
    ])
    body = "\n".join(
        f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c[0]} {c[1]} {c[2]}"
        for p, c in zip(points, colors)
    )
    path.write_text(header + "\n" + body + "\n")
    return path


def deproject(camera, depth: np.ndarray, device):
    """Dense deprojection of a raw depth image (DN, 0 = invalid) on
    ``device`` -> (points (H*W, 3) float32 camera-frame metres, valid (H*W,)
    bool), on the host."""
    import torch

    from dense_visual_odometry_torch.models.robust import as_device_tensor
    from dense_visual_odometry_torch.ops.residuals import deproject_grid

    raw = as_device_tensor(depth, device)
    z = raw.to(torch.float32) * camera.depth_scale
    pts = deproject_grid(z, camera.intrinsics.to(device))
    return pts.reshape(-1, 3).cpu().numpy(), (raw != 0).reshape(-1).cpu().numpy()


def build_cloud(est, seq, stride: int, max_points: int, device):
    """Deproject every ``stride``-th frame into the world frame."""
    points, colors = [], []
    for idx in range(0, len(seq), stride):
        if idx >= len(est):
            break
        rgb, depth = seq.frame(idx)
        pts, valid = deproject(seq.camera, depth, device)
        cols = rgb.reshape(-1, 3)
        pose = est[idx]
        points.append(pts[valid] @ pose[:3, :3].T + pose[:3, 3])
        colors.append(cols[valid])
    pts = np.concatenate(points)
    cols = np.concatenate(colors)
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points, replace=False)
        pts, cols = pts[sel], cols[sel]
    return pts, cols.astype(np.uint8)


def _frustum_segments(pose: np.ndarray, scale: float = 0.08) -> np.ndarray:
    """Camera frustum wireframe at ``pose`` -> (n_seg, 2, 3) segments."""
    c = np.zeros(3)
    corners = np.array(
        [[-1, -0.75, 1.5], [1, -0.75, 1.5], [1, 0.75, 1.5], [-1, 0.75, 1.5]]
    ) * scale
    pts = np.concatenate([[c], corners]) @ pose[:3, :3].T + pose[:3, 3]
    segs = []
    for i in range(1, 5):
        segs.append([pts[0], pts[i]])  # apex -> corner
        segs.append([pts[i], pts[1 + (i % 4)]])  # image-plane rectangle
    return np.asarray(segs)


def animate_replay(est: np.ndarray, seq, out_path: Path, stride: int = 1, fps: float = 5.0,
                   max_points: int = 12_000, device="cpu") -> Path:
    """Animated replay GIF: each frame's decimated point cloud placed in the
    world by its estimated pose, with the camera frustum and trail."""
    plt = _pyplot()
    import matplotlib.animation as manim

    idxs = list(range(0, min(len(est), len(seq)), max(1, stride)))
    clouds = []
    for idx in idxs:
        rgb, depth = seq.frame(idx)
        pts, valid = deproject(seq.camera, depth, device)
        cols = rgb.reshape(-1, 3).astype(np.float32) / 255.0
        pts, cols = pts[valid], cols[valid]
        if len(pts) > max_points:
            sel = np.random.default_rng(idx).choice(len(pts), max_points, replace=False)
            pts, cols = pts[sel], cols[sel]
        clouds.append((pts @ est[idx][:3, :3].T + est[idx][:3, 3], cols))

    allpts = np.concatenate([c[0] for c in clouds])
    # Robust bounds: stray far returns would dwarf the scene and shrink the
    # frustum; the camera path (in front of which the cloud sits) is inside.
    lo = np.percentile(allpts, 2, axis=0)
    hi = np.percentile(allpts, 98, axis=0)
    cams = est[: (idxs[-1] + 1), :3, 3]
    lo = np.minimum(lo, cams.min(axis=0))
    hi = np.maximum(hi, cams.max(axis=0))
    mid, span = (lo + hi) / 2, float((hi - lo).max()) / 2
    frustum_scale = max(0.12 * span, 0.05)

    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")

    def draw(i):
        ax.clear()
        world, cols = clouds[i]
        ax.scatter(world[:, 0], world[:, 1], world[:, 2], c=cols, s=0.6, alpha=0.7)
        trail = est[: idxs[i] + 1, :3, 3]
        # zorder beats mplot3d's depth sort: the wireframe stays in front of
        # the denser cloud.
        ax.plot(trail[:, 0], trail[:, 1], trail[:, 2], "r-", lw=1.5, zorder=10)
        for seg in _frustum_segments(est[idxs[i]], scale=frustum_scale):
            ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], "r-", lw=1.5, zorder=10)
        ax.set_xlim(mid[0] - span, mid[0] + span)
        ax.set_ylim(mid[1] - span, mid[1] + span)
        ax.set_zlim(mid[2] - span, mid[2] + span)
        ax.set_title(f"frame {idxs[i]}")
        ax.view_init(elev=-60, azim=-90)  # camera-ish: x right, y down

    anim = manim.FuncAnimation(fig, draw, frames=len(clouds))
    anim.save(str(out_path), writer=manim.PillowWriter(fps=fps))
    plt.close(fig)
    return out_path


def load_sequence(bench: str, info: dict):
    """The frames a report names: a bundled set or a TUM directory (its
    camera YAML as the report records it), else ``bench``'s."""
    from dense_visual_odometry_torch.io import load_bundled_sequence, load_tum_sequence

    if bench in ("test", "TUM") and info.get("data_dir"):
        if info.get("type") == "TUM":
            return load_tum_sequence(info["data_dir"], camera_yaml=info.get("camera_intrinsics"))
        return load_bundled_sequence(info.get("data_dir"))
    if bench == "test":
        return load_bundled_sequence()
    return load_tum_sequence(bench)


def main(argv=None):
    from dense_visual_odometry_torch.models.robust import resolve_device

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)
    path = Path(args.path)
    if not path.exists():
        raise FileNotFoundError(path)
    est, gt, info = load_poses(args.mode, path)
    logger.info("loaded %d poses", len(est))

    out = Path(args.output) if args.output else path.with_suffix(".png")
    plot_trajectories(est, gt, out)
    logger.info("trajectory figure -> %s", out)

    if args.ply or args.animate:
        device = resolve_device(args.platform)
        seq = load_sequence(args.benchmark or info.get("type", "test"), info)
        if args.ply:
            pts, cols = build_cloud(est, seq, args.stride, args.max_points, device)
            write_ply(Path(args.ply), pts, cols)
            logger.info("point cloud (%d pts) -> %s", len(pts), args.ply)
        if args.animate:
            animate_replay(est, seq, Path(args.animate), stride=args.animate_stride,
                           fps=args.animate_fps, device=device)
            logger.info("animated replay -> %s", args.animate)
    return out


if __name__ == "__main__":
    main()
