"""3-D reconstruction CLI: track (or load) a trajectory, fuse the frames into
a TSDF volume, export a triangle mesh.

Counterpart of ``dense_visual_odometry_tpu/apps/reconstruct.py``::

    python -m dense_visual_odometry_torch.apps.reconstruct tum -d DIR \\
        --camera cam.yaml -c configs/tpu_fast.json -o out/mesh.ply
    python -m dense_visual_odometry_torch.apps.reconstruct tum -d DIR \\
        --camera cam.yaml --trajectory out/run/report.json -o out/mesh.obj --brick
    python -m dense_visual_odometry_torch.apps.reconstruct tum -d DIR \\
        --camera cam.yaml -m track-model --track-kinfu -o out/mesh.ply

It runs on the GPU; ``--platform cpu`` runs on the CPU, and without a GPU
nothing else does.  ``-m`` tracks with the frame-to-frame session
(``robust-dvo``), keyframe SLAM (``slam``) or frame-to-model tracking
against a live volume (``track-model``; ``--track-kinfu`` renders the model
every frame, ``--track-brick`` tracks against a brick volume);
``--trajectory`` reads the poses from a report JSON or a TUM file instead.
The volume's bounds are fitted to the observed geometry (depth percentiles
deprojected through the trajectory).  Fusion runs on the device, mesh
extraction on the host (marching tetrahedra).  The last line of standard
output is a JSON summary: the stages' times, the mesh's size, the volume's
bytes and, for a brick volume, the bricks used and dropped.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

logger = logging.getLogger("dvo.reconstruct")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="TSDF reconstruction")
    p.add_argument("benchmark", choices=["test", "tum-fr1", "tum"])
    p.add_argument("-d", "--data-dir", type=str, default=None)
    p.add_argument("-c", "--config", type=str, default=None)
    p.add_argument("--camera", type=str, default=None, help="camera YAML (tum)")
    p.add_argument("-o", "--output", type=str, required=True,
                   help="mesh path (.ply, or .obj for Wavefront OBJ)")
    p.add_argument("-m", "--method", choices=["robust-dvo", "slam", "track-model"],
                   default="robust-dvo",
                   help="track-model = frame-to-model tracking against the live TSDF "
                        "(raycast virtual keyframes)")
    p.add_argument("--track-volume-extent", type=float, default=8.0,
                   help="track-model: tracking-volume cube side (m), centred on the "
                        "first frame's observed surface")
    p.add_argument("--track-resolution", type=int, default=192,
                   help="track-model: tracking-volume voxels per axis")
    p.add_argument("--track-kinfu", action="store_true",
                   help="track-model: render the model prediction every frame "
                        "(KinectFusion loop, marching raycast) instead of keyframe-held "
                        "renders")
    p.add_argument("--track-brick", action="store_true",
                   help="track-model: brick-grid sparse tracking volume (surface-band "
                        "bricks only); --track-resolution becomes the virtual resolution")
    p.add_argument("--track-pool", type=int, default=16384,
                   help="--track-brick: brick pool capacity")
    p.add_argument("--brick", action="store_true",
                   help="fuse and export with the brick-grid sparse volume "
                        "(models/brick_tsdf.py) instead of the dense one")
    p.add_argument("--pool", type=int, default=32768, help="--brick: brick pool capacity")
    p.add_argument("--trajectory", type=str, default=None,
                   help="report JSON or TUM txt with poses (skips tracking)")
    p.add_argument("--size", type=int, default=None, help="frame limit")
    p.add_argument("--every", type=int, default=1, help="fuse every Nth frame")
    p.add_argument("--resolution", type=int, default=192,
                   help="voxels along the longest volume axis")
    p.add_argument("--voxel", type=float, default=None,
                   help="voxel size in meters (overrides --resolution)")
    p.add_argument("--truncation", type=float, default=None,
                   help="TSDF truncation in meters (default 4 voxels)")
    p.add_argument("--min-weight", type=float, default=1.0)
    p.add_argument("--adaptive-truncation", type=float, default=0.0,
                   help="widen the band with depth: tau(z) = truncation + A*z^2 "
                        "(Kinect disparity-noise model)")
    p.add_argument("--carve", type=float, default=0.0,
                   help="space-carving weight decay in [0,1] for voxels where free-space "
                        "views conflict with a stored surface (dynamic-object removal)")
    p.add_argument("--platform", type=str, default=None, choices=["cuda", "cpu"],
                   help="device to run on (default: the GPU)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p.parse_args(argv)


class Reconstruction(NamedTuple):
    """What :func:`run` made: ``summary`` is JSON-serializable; the rest is
    what a caller needs to fuse the same frames again."""

    summary: dict
    poses: np.ndarray  # (N, 4, 4) camera-to-world of every frame
    frames: list  # [(depth_m (H, W), gray (H, W))] of the fused frames
    fused_poses: np.ndarray  # their poses
    intrinsics: np.ndarray  # (3, 3) float32
    volume_config: object  # TSDFConfig or BrickTSDFConfig
    volume: tuple  # TSDFVolume or BrickTSDFVolume, on the run's device


def _load_trajectory_poses(path: Path, n_frames: int) -> np.ndarray:
    """Report JSON or TUM text -> (N, 4, 4) camera-to-world poses.  A report
    holds them under ``estimated_poses`` (``apps.benchmark``'s) or
    ``poses`` (the only key the JAX package's reader takes)."""
    from dense_visual_odometry_torch.io import trajectory

    if path.suffix == ".json":
        report = json.loads(path.read_text())
        poses = np.asarray(report.get("poses", report.get("estimated_poses")), dtype=np.float64)
    else:
        _, poses = trajectory.load_tum_trajectory(path)
        poses = np.asarray(poses, dtype=np.float64)
    if len(poses) < n_frames:
        raise ValueError(f"trajectory has {len(poses)} poses for {n_frames} frames")
    return poses[:n_frames]


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _track_poses(seq, cfg, method: str, args, device):
    """-> ((N, 4, 4) poses, a dict of the run's counts: ``step_ms`` for
    every frame, and for track-model its renders, failures and volume)."""
    info = {"step_ms": []}

    def timed(steps):
        for rgb, depth in seq.prefetched():
            t0 = time.perf_counter()
            yield steps(rgb, depth)
            info["step_ms"].append((time.perf_counter() - t0) * 1e3)

    if method == "track-model":
        from dense_visual_odometry_torch.models.frame_to_model import (
            FrameToModelTracker,
            ModelTrackerPolicy,
        )
        from dense_visual_odometry_torch.models.tsdf import TSDFConfig, volume_bytes

        # The tracking volume is centred on the first frame's median
        # observed depth; the map grows into it as the camera moves.
        _, depth0 = seq.frame(0)
        d0 = np.asarray(depth0, np.float64) * seq.camera.depth_scale
        z_med = float(np.median(d0[d0 > 0])) if np.any(d0 > 0) else 2.0
        extent, res = args.track_volume_extent, args.track_resolution
        center = (0.0, 0.0, z_med)
        if args.track_brick:
            from dense_visual_odometry_torch.models.brick_tsdf import BrickTSDFConfig

            res -= res % 8  # virtual resolution: a multiple of the brick
            tcfg = BrickTSDFConfig.around(center, extent, resolution=res,
                                          truncation=4.0 * extent / res,
                                          pool_size=int(args.track_pool))
        else:
            tcfg = TSDFConfig.around(center, extent, resolution=res,
                                     truncation=4.0 * extent / res)
        policy = ModelTrackerPolicy(render_every_frame=args.track_kinfu,
                                    raycast="march" if args.track_kinfu else "splat")
        tracker = FrameToModelTracker(seq.camera, cfg, tcfg, policy=policy, device=device)
        for _ in timed(tracker.step):
            pass
        info.update(renders=tracker.renders, failures=tracker.failures,
                    tracking_volume_bytes=volume_bytes(tracker.volume))
        logger.info("track-model: %d virtual-keyframe renders, %d failed solves",
                    tracker.renders, tracker.failures)
        if args.track_brick:
            info.update(tracking_bricks_used=int(tracker.volume.n_used),
                        tracking_bricks_dropped=int(tracker.volume.n_dropped))
            logger.info("tracking brick volume: %d / %d bricks used, %d dropped",
                        info["tracking_bricks_used"], tcfg.pool_size,
                        info["tracking_bricks_dropped"])
        return tracker.trajectory(), info

    if method == "slam":
        from dense_visual_odometry_torch.models.slam import SlamSession

        session = SlamSession(seq.camera, cfg, device=device)
        for _ in timed(session.step):
            pass
        return np.asarray(session.optimized_trajectory(), dtype=np.float64), info

    from dense_visual_odometry_torch.models.session import OdometrySession

    session = OdometrySession(seq.camera, cfg, device=device)
    poses = list(timed(lambda rgb, depth: session.step(rgb, depth).matrix.cpu().numpy()))
    return np.stack(poses).astype(np.float64), info


def _fit_bounds(frames, intrinsics, poses, pad: float):
    """World-space box of the observed surface (depth percentiles of a pixel
    subsample deprojected through the trajectory)."""
    k_inv = np.linalg.inv(intrinsics)
    lo = np.full(3, np.inf)
    hi = np.full(3, -np.inf)
    for (depth_m, _), pose in zip(frames, poses):
        d = depth_m[::8, ::8]
        vs, us = np.nonzero(d > 0)
        if len(vs) == 0:
            continue
        z = d[vs, us]
        # Trim far outliers so that one bad pixel cannot blow the volume up.
        keep = z <= np.percentile(z, 98.0)
        vs, us, z = vs[keep], us[keep], z[keep]
        pix = np.stack([us * 8, vs * 8, np.ones_like(us)], axis=0)
        rays = k_inv @ pix
        pts = (rays * z).T @ pose[:3, :3].T + pose[:3, 3]
        lo = np.minimum(lo, pts.min(axis=0))
        hi = np.maximum(hi, pts.max(axis=0))
    if not np.all(np.isfinite(lo)):
        raise ValueError("no valid depth in the sequence")
    return lo - pad, hi + pad


def _host_frames(seq, cfg) -> list:
    """Every frame's (metric depth, gray) on the host, by the session's own
    preprocessing ops."""
    import torch

    from dense_visual_odometry_torch.models.robust import as_device_tensor
    from dense_visual_odometry_torch.ops.pyramid import preprocess_depth, rgb_to_gray

    cpu = torch.device("cpu")
    frames = []
    for rgb, depth in seq.prefetched():
        gray = rgb_to_gray(torch.from_numpy(np.asarray(rgb))).numpy() if rgb.ndim == 3 else rgb
        depth_m = preprocess_depth(as_device_tensor(depth, cpu), seq.camera.depth_scale,
                                   cfg.max_distance).numpy()
        frames.append((depth_m, np.asarray(gray, dtype=np.float32)))
    return frames


def run(args) -> Reconstruction:
    from dense_visual_odometry_torch.apps.benchmark import backend_name
    from dense_visual_odometry_torch.config import RobustDVOConfig
    from dense_visual_odometry_torch.io import load_bundled_sequence, load_tum_sequence
    from dense_visual_odometry_torch.models import brick_tsdf, tsdf
    from dense_visual_odometry_torch.models.robust import resolve_device

    device = resolve_device(args.platform)
    if args.benchmark == "test":
        seq = load_bundled_sequence(args.data_dir, size=args.size)
    else:
        seq = load_tum_sequence(args.data_dir, camera_yaml=args.camera, size=args.size)
    cfg = (RobustDVOConfig.from_json(args.config) if args.config
           else RobustDVOConfig(levels=4, use_weighter=True))
    summary = {"frames": len(seq), "method": args.method, "backend": backend_name(device)}

    if args.trajectory:
        poses = _load_trajectory_poses(Path(args.trajectory), len(seq))
        summary["method"] = "trajectory"
        logger.info("loaded %d poses from %s", len(poses), args.trajectory)
    else:
        t0 = time.perf_counter()
        poses, info = _track_poses(seq, cfg, args.method, args, device)
        summary.update(track_s=time.perf_counter() - t0, **info)
        logger.info("tracked %d frames with %s in %.1f s", len(poses), args.method,
                    summary["track_s"])

    frames = _host_frames(seq, cfg)[:: args.every]
    poses_f = poses[:: args.every]
    k = np.asarray(seq.camera.intrinsics, dtype=np.float32)[:3, :3]
    lo, hi = _fit_bounds(frames, k, poses_f, pad=0.05)
    extent = hi - lo
    voxel = args.voxel if args.voxel is not None else float(extent.max()) / args.resolution
    cap = 1024 if args.brick else 512  # the sparse pool lifts the axis cap
    dims = tuple(int(min(max(np.ceil(e / voxel), 8), cap)) for e in extent[::-1])  # (z, y, x)
    trunc = args.truncation if args.truncation is not None else 4.0 * voxel
    common = dict(voxel_size=voxel, origin=tuple(lo), truncation=trunc,
                  truncation_scale_sq=args.adaptive_truncation, carve_decay=args.carve)
    if args.brick:
        vcfg = brick_tsdf.BrickTSDFConfig(brick_grid=tuple(-(-d // 8) for d in dims),
                                          brick_size=8, pool_size=int(args.pool), **common)
        logger.info("brick volume %s (virtual) voxel %.4f m bounds %s -> %s "
                    "(pool %d bricks = %.0f MVox cap)", vcfg.dims, voxel, np.round(lo, 3),
                    np.round(hi, 3), args.pool, args.pool * 512 / 1e6)
        vol = brick_tsdf.make_brick_volume(vcfg, device)
        fuse, extract = brick_tsdf.integrate_brick, brick_tsdf.extract_mesh_bricks
    else:
        vcfg = tsdf.TSDFConfig(dims=dims, **common)
        logger.info("volume %s voxel %.4f m bounds %s -> %s (%.0f MVox)", dims, voxel,
                    np.round(lo, 3), np.round(hi, 3), np.prod(dims) / 1e6)
        vol = tsdf.make_volume(vcfg, device)
        fuse, extract = tsdf.integrate, tsdf.extract_mesh

    t0 = time.perf_counter()
    for (depth_m, gray), pose in zip(frames, poses_f):
        fuse(vol, depth_m, gray, k, pose, vcfg)
    _sync(device)
    t_fuse = time.perf_counter() - t0
    summary.update(fused_frames=len(frames), fuse_s=t_fuse,
                   fuse_ms_per_frame=t_fuse / max(len(frames), 1) * 1e3,
                   volume_dims=list(vcfg.dims), voxel_m=voxel,
                   volume_bytes=tsdf.volume_bytes(vol))
    if args.brick:
        summary.update(bricks_used=int(vol.n_used), bricks_dropped=int(vol.n_dropped),
                       pool=int(args.pool))
        logger.info("fused %d frames in %.2f s (%.1f ms/frame); %d/%d bricks, %d dropped",
                    len(frames), t_fuse, summary["fuse_ms_per_frame"],
                    summary["bricks_used"], args.pool, summary["bricks_dropped"])
    else:
        logger.info("fused %d frames in %.2f s (%.1f ms/frame)", len(frames), t_fuse,
                    summary["fuse_ms_per_frame"])

    t0 = time.perf_counter()
    verts, faces, gray_v = extract(vol, vcfg, min_weight=args.min_weight)
    summary.update(mesh_s=time.perf_counter() - t0, vertices=len(verts), faces=len(faces))
    logger.info("extracted %d vertices / %d faces in %.2f s", len(verts), len(faces),
                summary["mesh_s"])
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    save = tsdf.save_mesh_obj if out.suffix.lower() == ".obj" else tsdf.save_mesh_ply
    save(out, verts, faces, gray_v)
    summary["output"] = str(out)
    logger.info("mesh -> %s", out)
    return Reconstruction(summary=summary, poses=poses, frames=frames, fused_poses=poses_f,
                          intrinsics=k, volume_config=vcfg, volume=vol)


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)
    print(json.dumps(run(args).summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
