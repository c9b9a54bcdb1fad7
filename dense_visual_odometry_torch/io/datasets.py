"""RGB-D sequence loaders: TUM RGB-D directories and the bundled 10-frame set.

Counterpart of ``dense_visual_odometry_tpu/io/datasets.py``, with the same
association rules: ``rgb.txt`` / ``depth.txt`` / ``groundtruth.txt``
parsing, each rgb frame paired with the nearest depth frame (one rgb frame
per depth frame), the ground-truth pose nearest to the pair's mean
timestamp, TUM's xyzw quaternions; and the bundled set's
``ground_truth.json``.

Frames are read on demand on the host (numpy); PNGs by the first route that
works on the machine (``io/png.py``: OpenCV, the native libpng loader, or
the package's own codec).  :meth:`RGBDSequence.prefetched` streams them
through the native prefetching loader where it builds.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from dense_visual_odometry_torch.camera import CameraModel
from dense_visual_odometry_torch.io import png
from dense_visual_odometry_torch.ops.pyramid import median3x3

# The bundled set's directory, ``tests/test_data`` of the checkout (also where
# a TUM directory's camera YAML is looked for by default).  The set comes from
# the original project's tests and is not committed yet: while it is absent,
# loading it raises FileNotFoundError.
BUNDLED_DATA_DIR = Path(__file__).resolve().parents[2] / "tests" / "test_data"


def host_gray_u8(rgb: np.ndarray) -> np.ndarray:
    """BT.601 luma as uint8 on the host, with cv2.cvtColor's fixed-point
    rounding: a gray frame is 0.6x the bytes of RGB + depth to upload."""
    if rgb.ndim == 2:
        return rgb
    r = rgb[..., 0].astype(np.uint32)
    g = rgb[..., 1].astype(np.uint32)
    b = rgb[..., 2].astype(np.uint32)
    return ((4899 * r + 9617 * g + 1868 * b + 8192) >> 14).astype(np.uint8)


def _tum_pose(tx, ty, tz, qx, qy, qz, qw) -> np.ndarray:
    """TUM translation + xyzw quaternion -> 4x4 camera-to-world matrix."""
    q = np.array([qw, qx, qy, qz], dtype=np.float64)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    rot = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    out = np.eye(4)
    out[:3, :3] = rot
    out[:3, 3] = [tx, ty, tz]
    return out


def frame_route() -> str:
    """How :meth:`RGBDSequence.prefetched` reads frames here: "native
    prefetch" where the native loader builds, else :func:`png.route`'s."""
    from dense_visual_odometry_torch.io import native_loader

    try:
        native_loader.load_library()
        return "native prefetch"
    except native_loader.NativeLoaderUnavailable:
        return png.route()


@dataclass
class RGBDSequence:
    """A loaded RGB-D sequence: paths + ground truth, images read on demand."""

    name: str
    camera: CameraModel
    rgb_paths: List[Path]
    depth_paths: List[Path]
    timestamps: np.ndarray  # (N,) float64
    gt_poses: Optional[np.ndarray]  # (N, 4, 4) camera-to-world, or None
    extra: dict = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.rgb_paths)

    def frame(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """-> (rgb (H,W,3) uint8, depth (H,W) uint16) for frame ``i``."""
        return png.read_rgb(self.rgb_paths[i]), png.read_depth(self.depth_paths[i])

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for i in range(len(self)):
            yield self.frame(i)

    def prefetched(
        self, prefetch: int = 4, workers: int = 2
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Iterate frames through the native prefetching loader (libpng on
        a worker pool, decoding ahead of the consumer) where it builds, else
        through :meth:`frame` (:func:`frame_route` says which)."""
        from dense_visual_odometry_torch.io.native_loader import (
            NativeLoaderUnavailable,
            NativeSequenceLoader,
        )

        try:
            loader = NativeSequenceLoader(
                self.rgb_paths, self.depth_paths, prefetch=prefetch, workers=workers
            )
        except NativeLoaderUnavailable:
            yield from self
            return
        try:
            yield from loader
        finally:
            loader.close()

    def subset(self, size: int) -> "RGBDSequence":
        if size >= len(self):
            return self
        return RGBDSequence(
            name=self.name,
            camera=self.camera,
            rgb_paths=self.rgb_paths[:size],
            depth_paths=self.depth_paths[:size],
            timestamps=self.timestamps[:size],
            gt_poses=None if self.gt_poses is None else self.gt_poses[:size],
            extra=self.extra,
        )


def _median_down(image: np.ndarray) -> np.ndarray:
    """3x3 median (replicated borders, cv2.medianBlur's) then every other
    row and column, on the host with the pyramid's median; (H, W) or
    (H, W, C), any integer type exact in float32."""
    t = torch.from_numpy(np.ascontiguousarray(image).astype(np.float32))
    if t.ndim == 3:
        out = median3x3(t.permute(2, 0, 1)).permute(1, 2, 0)
    else:
        out = median3x3(t)
    return np.ascontiguousarray(out.numpy()[::2, ::2]).astype(image.dtype)


class _PyrDownView(RGBDSequence):
    """Half-resolution view of a sequence: median blur + decimation, with
    the intrinsics of pyramid level 1."""

    def frame(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        rgb, depth = super().frame(i)
        return _median_down(rgb), _median_down(depth)

    def prefetched(self, prefetch: int = 4, workers: int = 2):
        for rgb, depth in super().prefetched(prefetch, workers):
            yield _median_down(rgb), _median_down(depth)


def pyr_down_sequence(seq: RGBDSequence) -> RGBDSequence:
    """Half-resolution view of ``seq`` with correctly rescaled intrinsics."""
    half_k = CameraModel.create(seq.camera.at(1).cpu().numpy(), seq.camera.depth_scale)
    return _PyrDownView(
        name=seq.name + "-half",
        camera=half_k,
        rgb_paths=seq.rgb_paths,
        depth_paths=seq.depth_paths,
        timestamps=seq.timestamps,
        gt_poses=seq.gt_poses,
        extra={**seq.extra, "pyr_down": True},
    )


def load_bundled_sequence(
    data_dir=None, size: Optional[int] = None
) -> RGBDSequence:
    """The 10-frame TUM-style test set (``ground_truth.json`` of 4x4 poses,
    ``camera_intrinsics.yaml``).  Raises FileNotFoundError where it is
    absent."""
    data_dir = Path(data_dir) if data_dir is not None else BUNDLED_DATA_DIR
    gt_file = data_dir / "ground_truth.json"
    if not gt_file.exists():
        raise FileNotFoundError(f"bundled dataset not found at {data_dir}")
    gt = json.loads(gt_file.read_text())
    camera = CameraModel.from_yaml(data_dir / "camera_intrinsics.yaml")

    keys = sorted(gt.keys(), key=int)
    rgb_paths = [data_dir / gt[k]["rgb"] for k in keys]
    depth_paths = [data_dir / gt[k]["depth"] for k in keys]
    poses = np.stack([np.array(gt[k]["transformation"], dtype=np.float64) for k in keys])
    seq = RGBDSequence(
        name="test",
        camera=camera,
        rgb_paths=rgb_paths,
        depth_paths=depth_paths,
        timestamps=np.arange(len(keys), dtype=np.float64),
        gt_poses=poses,
        extra={"type": "test", "data_dir": str(data_dir)},
    )
    return seq if size is None else seq.subset(size)


def _parse_tum_file(path: Path):
    """-> (timestamps (N,), fields: list of remaining-column lists)."""
    timestamps, fields = [], []
    with path.open("r") as fp:
        for line in fp:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            timestamps.append(float(parts[0]))
            fields.append(parts[1:])
    return np.asarray(timestamps, dtype=np.float64), fields


def load_tum_sequence(
    data_dir,
    camera_yaml=None,
    size: Optional[int] = None,
    require_groundtruth: bool = True,
) -> RGBDSequence:
    """A TUM RGB-D sequence directory (rgb.txt / depth.txt / groundtruth.txt).

    Each rgb timestamp takes the nearest depth timestamp (one rgb frame per
    depth frame), then the ground-truth pose nearest to the two timestamps'
    mean.  ``camera_yaml`` defaults to the bundled set's.
    """
    data_dir = Path(data_dir).resolve()
    if not data_dir.is_dir():
        raise FileNotFoundError(f"TUM dataset dir not found: {data_dir}")

    rgb_ts, rgb_rows = _parse_tum_file(data_dir / "rgb.txt")
    depth_ts, depth_rows = _parse_tum_file(data_dir / "depth.txt")

    # rgb -> nearest depth; keep one rgb per depth frame.
    dist = np.abs(rgb_ts[:, None] - depth_ts[None, :])
    nearest_depth = dist.argmin(axis=1)
    depth_ids, rgb_ids = np.unique(nearest_depth, return_index=True)

    rgb_paths = [data_dir / rgb_rows[i][0] for i in rgb_ids]
    depth_paths = [data_dir / depth_rows[j][0] for j in depth_ids]
    frame_ts = (rgb_ts[rgb_ids] + depth_ts[depth_ids]) / 2.0

    gt_poses = None
    gt_file = data_dir / "groundtruth.txt"
    if gt_file.exists():
        gt_ts, gt_rows = _parse_tum_file(gt_file)
        nearest_gt = np.abs(frame_ts[:, None] - gt_ts[None, :]).argmin(axis=1)
        gt_poses = np.stack(
            [_tum_pose(*map(float, gt_rows[j])) for j in nearest_gt]
        )
    elif require_groundtruth:
        raise FileNotFoundError(f"groundtruth.txt not found in {data_dir}")

    camera_yaml = Path(camera_yaml) if camera_yaml else BUNDLED_DATA_DIR / "camera_intrinsics.yaml"
    camera = CameraModel.from_yaml(camera_yaml)

    seq = RGBDSequence(
        name=data_dir.name,
        camera=camera,
        rgb_paths=rgb_paths,
        depth_paths=depth_paths,
        timestamps=frame_ts,
        gt_poses=gt_poses,
        extra={"type": "TUM", "data_dir": str(data_dir), "camera_intrinsics": str(camera_yaml)},
    )
    return seq if size is None else seq.subset(size)
