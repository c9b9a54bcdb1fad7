"""Render a synthetic RGB-D sequence into a TUM-format dataset directory.

Counterpart of ``dense_visual_odometry_tpu/apps/make_dataset.py``, writing
the same files: a trajectory with exact ground truth rendered from one
source frame, in the TUM RGB-D on-disk layout

    <out>/rgb/<ts>.png          8-bit PNG (gray replicated to RGB)
    <out>/depth/<ts>.png        16-bit PNG, TUM 5000 DN/m convention
    <out>/rgb.txt, depth.txt    "timestamp filename" association tables
    <out>/groundtruth.txt       "ts tx ty tz qx qy qz qw" (camera-to-world)

so that the TUM ingestion path (nearest-timestamp association, 16-bit depth
decoding, quaternion parsing, ground-truth matching) runs end to end:

    python -m dense_visual_odometry_torch.apps.make_dataset -o out/tum_synth \\
        --frames 120 --motion handheld-fr1 --source synthetic
    python -m dense_visual_odometry_torch.apps.benchmark tum -d out/tum_synth \\
        --camera cam.yaml -c configs/tpu_fast.json -o out/run

The source frame is frame ``--source-frame`` of the bundled set (the
default, as in the JAX package; it raises while the set is absent), or with
``--source synthetic`` ``io.synthetic.textured_scene`` at 640x480 under the
TUM fr1 pinhole.  Depth timestamps are offset from rgb ones (+5 ms) so that
the association does real work.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

# TUM RGB-D depth convention: 5000 DN per metre (depth_scale = 2e-4).
TUM_DN_PER_M = 5000.0
# The synthetic source frame's size (TUM RGB-D's).
SOURCE_HEIGHT, SOURCE_WIDTH = 480, 640

_MOTIONS = {
    # (orbit radius m, wobble angle rad, forward advance m/frame)
    "bundled": (0.002, 0.002, 0.001),  # ~the bundled set's magnitude
    "medium": (0.01, 0.01, 0.004),
    "hard": (0.03, 0.04, 0.01),
}


def _quat_wxyz(rot: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (w, x, y, z) quaternion (Shepperd pivoting)."""
    m = rot
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array(
            [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 0.0)) * 2
    q = np.empty(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def bundled_source(source_frame: int = 0):
    """-> (gray (H, W) float32, depth (H, W) metres, K (3, 3)) of frame
    ``source_frame`` of the bundled set.  The gray frame is OpenCV's
    ``cvtColor``, as the JAX package makes it, where ``cv2`` imports; else
    ``host_gray_u8``'s fixed-point BT.601, which parts from it by 1 DN on
    ~0.1% of pixels."""
    from dense_visual_odometry_torch.io.datasets import host_gray_u8, load_bundled_sequence

    seq = load_bundled_sequence()
    rgb, depth_dn = seq.frame(source_frame)
    try:
        import cv2
    except ImportError:
        gray = host_gray_u8(rgb).astype(np.float32)
    else:
        gray = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY).astype(np.float32)
    depth_m = depth_dn.astype(np.float32) * seq.camera.depth_scale
    return gray, depth_m, seq.camera.intrinsics.numpy()[:3, :3]


def write_tum_dataset(
    out_dir,
    n_frames: int = 60,
    motion: str = "medium",
    source_frame: int = 0,
    fps: float = 30.0,
    seed_t0: float = 1000.0,
    seed: int = 0,
    source=None,
) -> Path:
    """Render and write the dataset; returns the output directory.

    ``source``: (gray (H, W), depth (H, W) metres, K (3, 3)) to render from;
    default frame ``source_frame`` of the bundled set.

    ``motion="handheld-fr1"`` renders the fr1-difficulty stand-in: a
    hand-held 6-DoF random-walk trajectory with fr1/desk per-frame motion
    statistics (with a rotation-dominant span and a fast span,
    ``io/synthetic.handheld_trajectory``) and a Kinect sensor model:
    disparity-quantised depth with edge and speckle dropout, auto-exposure
    gain and bias wander and sensor noise on intensity
    (``degrade_depth`` / ``degrade_gray``); then +-2 ms timestamp jitter and
    ~1% dropped depth frames, so that the nearest-timestamp association does
    real work.
    """
    from dense_visual_odometry_torch.io import png
    from dense_visual_odometry_torch.io.synthetic import (
        degrade_depth,
        degrade_gray,
        handheld_trajectory,
        orbit_trajectory,
        render_sequence,
    )

    out = Path(out_dir)
    (out / "rgb").mkdir(parents=True, exist_ok=True)
    (out / "depth").mkdir(parents=True, exist_ok=True)

    gray, depth_m, k = source if source is not None else bundled_source(source_frame)
    gray = np.asarray(gray, np.float32)
    depth_m = np.asarray(depth_m, np.float32)
    k = np.asarray(k)[:3, :3]

    handheld = motion == "handheld-fr1"
    if handheld:
        poses = handheld_trajectory(n_frames, seed=seed)
    else:
        radius, angle, advance = _MOTIONS[motion]
        poses = orbit_trajectory(
            n_frames, radius=radius, angle=angle, advance=advance
        )
    grays, depths = render_sequence(gray, depth_m, k, poses)

    rng = np.random.default_rng(seed + 1)
    exposure_state: dict = {}

    rgb_lines = ["# color images", "# timestamp filename"]
    depth_lines = ["# depth maps", "# timestamp filename"]
    gt_lines = ["# ground truth trajectory", "# ts tx ty tz qx qy qz qw"]
    for i, (g, d, pose) in enumerate(zip(grays, depths, poses)):
        if handheld:
            g = degrade_gray(g, i, rng, exposure_state)
            d = degrade_depth(d, rng)
        ts_rgb = seed_t0 + i / fps
        # Depth timestamps offset (TUM's sensors are not synchronised); the
        # handheld set adds per-frame jitter on top.
        ts_depth = ts_rgb + 0.005
        if handheld:
            ts_rgb += float(rng.uniform(-0.002, 0.002))
            ts_depth += float(rng.uniform(-0.002, 0.002))
        rgb_name = f"rgb/{ts_rgb:.6f}.png"
        depth_name = f"depth/{ts_depth:.6f}.png"
        g8 = np.clip(np.round(g), 0, 255).astype(np.uint8)
        png.write(out / rgb_name, np.stack([g8] * 3, axis=-1))
        rgb_lines.append(f"{ts_rgb:.6f} {rgb_name}")
        # ~1% of depth frames never arrive (Kinect frame drops): the
        # association then pairs the rgb frame with a neighbouring one.
        if not (handheld and i > 0 and rng.random() < 0.01):
            d16 = np.clip(np.round(d * TUM_DN_PER_M), 0, 65535).astype(np.uint16)
            png.write(out / depth_name, d16)
            depth_lines.append(f"{ts_depth:.6f} {depth_name}")
        q = _quat_wxyz(pose[:3, :3])
        t = pose[:3, 3]
        gt_lines.append(
            f"{ts_rgb:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
            f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}"
        )
    (out / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (out / "depth.txt").write_text("\n".join(depth_lines) + "\n")
    (out / "groundtruth.txt").write_text("\n".join(gt_lines) + "\n")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-o", "--out", required=True, help="output directory")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument(
        "--motion", choices=sorted(_MOTIONS) + ["handheld-fr1"],
        default="medium",
        help="per-frame motion magnitude (handheld-fr1 = fr1-difficulty "
        "trajectory + Kinect sensor model)",
    )
    ap.add_argument("--source", choices=["bundled", "synthetic"], default="bundled",
                    help="source frame: the bundled set's (--source-frame) or a seeded "
                    "640x480 textured scene under the TUM fr1 pinhole")
    ap.add_argument("--source-frame", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    source = None
    if args.source == "synthetic":
        from dense_visual_odometry_torch.io.synthetic import textured_scene

        source = textured_scene(SOURCE_HEIGHT, SOURCE_WIDTH, seed=args.seed)
    out = write_tum_dataset(
        args.out, n_frames=args.frames, motion=args.motion,
        source_frame=args.source_frame, seed=args.seed, source=source,
    )
    print(f"wrote {args.frames} frames to {out}")


if __name__ == "__main__":
    main()
