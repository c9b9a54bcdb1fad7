"""Dense TSDF fusion and the volume march: one launch each.

No Pallas counterpart: ``dense_visual_odometry_tpu/models/tsdf.py``
integrates and renders in plain jnp.

- :func:`integrate_volume` updates the volume's three fields in place as
  :func:`~dense_visual_odometry_torch.models.tsdf.integrate_plain` does, by
  launching ``csrc/tsdf_fuse.cu`` (a thread per four consecutive x-voxels);
- :func:`raycast_volume` renders a view as
  :func:`~dense_visual_odometry_torch.models.tsdf.raycast_view_march_volume_plain`
  does, by launching ``csrc/raycast_volume.cu`` (a thread per ray).

Each kernel does the plain version's float32 operations in its order, so
the two agree bit for bit.  They take CUDA volumes only; the callers in
``models/tsdf.py`` send CPU ones to the plain versions.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dense_visual_odometry_torch.ops.cuda import build


def _check_volume(what: str, volume, others) -> None:
    """The checks both kernels make: three float32 (D, H, W) fields,
    contiguous and 32-bit indexable, and ``others`` float32 on the
    volume's device."""
    fields = tuple(volume)
    shape = fields[0].shape
    if len(shape) != 3 or any(f.shape != shape for f in fields):
        raise ValueError(f"the volume's fields must share one (D, H, W) shape, got "
                         f"{[tuple(f.shape) for f in fields]}")
    if any(t.dtype != torch.float32 for t in fields + others):
        raise TypeError(f"{what}: the volume and its inputs must be float32, got "
                        f"{sorted({str(t.dtype) for t in fields + others})}")
    if not all(f.is_contiguous() for f in fields):
        raise ValueError(f"{what}: the volume's fields must be contiguous")
    if any(t.device != fields[0].device for t in others):
        raise ValueError(f"{what}: the inputs must be on the volume's device")
    # The kernels index voxels and pixels in 32 bits.
    if fields[0].numel() >= 2**31:
        raise ValueError(f"{what}: a {tuple(shape)} volume exceeds the kernel's "
                         f"32-bit indexing")


def _check_inputs(volume, depth_m, gray, intrinsics, world_to_cam, axes) -> None:
    _check_volume("integrate_volume", volume, (depth_m, gray, intrinsics, world_to_cam, *axes))
    if depth_m.dim() != 2 or gray.shape != depth_m.shape:
        raise ValueError(f"depth and gray must be one (H, W) shape, got "
                         f"{tuple(depth_m.shape)} and {tuple(gray.shape)}")
    if tuple(intrinsics.shape) != (3, 3) or tuple(world_to_cam.shape) != (4, 4):
        raise ValueError("intrinsics must be 3x3 and world_to_cam 4x4")
    d, h, w = volume.tsdf.shape
    if tuple(a.numel() for a in axes) != (w, h, d):
        raise ValueError(f"the axes must hold W, H and D = {(w, h, d)} centres")


def _launch(volume, depth_m, gray, intrinsics, world_to_cam, axes, cfg) -> None:
    lib = build.load("tsdf_fuse")
    fn = lib.dvo_tsdf_fuse
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float] * 5
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    depth_m, gray, intrinsics, world_to_cam = (
        t.contiguous() for t in (depth_m, gray, intrinsics, world_to_cam))
    xs, ys, zs = (a.contiguous() for a in axes)
    d, h, w = volume.tsdf.shape
    vec = w % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (*volume, xs))
    stream = torch.cuda.current_stream(volume.tsdf.device).cuda_stream
    status = fn(volume.tsdf.data_ptr(), volume.weight.data_ptr(), volume.gray.data_ptr(),
                depth_m.data_ptr(), gray.data_ptr(), intrinsics.data_ptr(),
                world_to_cam.data_ptr(), xs.data_ptr(), ys.data_ptr(), zs.data_ptr(),
                d, h, w, depth_m.shape[0], depth_m.shape[1],
                # Python floats as PyTorch hands them to a float32 kernel:
                # rounded to nearest.
                cfg.truncation, cfg.truncation_scale_sq, cfg.min_depth, cfg.max_weight,
                1.0 - cfg.carve_decay, int(cfg.carve_decay > 0.0), int(vec), stream)
    build.check(status, "tsdf_fuse")
    integrate_volume.launches += 1


def integrate_volume(volume, depth_m, gray, intrinsics, world_to_cam, axes, cfg) -> None:
    """Fuse one frame into a CUDA ``volume`` (three float32 (D, H, W)
    fields, contiguous) in place: ``depth_m`` and ``gray`` (H, W),
    ``intrinsics`` 3x3, ``world_to_cam`` the 4x4 inverse pose, ``axes`` the
    voxel centres' world coordinates along x, y and z
    (:func:`~dense_visual_odometry_torch.models.tsdf.voxel_axes`), all
    float32 on the volume's device; ``cfg`` a ``TSDFConfig``.  Raises on
    what the kernel does not take, and on any device but CUDA."""
    _check_inputs(volume, depth_m, gray, intrinsics, world_to_cam, axes)
    if volume.tsdf.device.type != "cuda":
        raise RuntimeError(f"integrate_volume: no kernel for device {volume.tsdf.device}")
    _launch(volume, depth_m, gray, intrinsics, world_to_cam, axes, cfg)


integrate_volume.launches = 0


def _launch_raycast(volume, intrinsics, pose, cfg, shape, n_steps, step, min_weight, max_depth,
                    box):
    lib = build.load("raycast_volume")
    fn = lib.dvo_raycast_volume
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float] * 13
                   + [ctypes.c_void_p])
    intrinsics, pose = intrinsics.contiguous(), pose.contiguous()
    d, h, w = volume.tsdf.shape
    img_h, img_w = shape
    depth = torch.empty((img_h, img_w), dtype=torch.float32, device=volume.tsdf.device)
    gray = torch.empty_like(depth)
    # Python floats as PyTorch hands them to a float32 kernel: rounded to
    # nearest, and a division by one a multiplication by its float32
    # reciprocal.
    inv_voxel = float(np.float32(1.0) / np.float32(cfg.voxel_size))
    lo, hi = box
    stream = torch.cuda.current_stream(volume.tsdf.device).cuda_stream
    status = fn(volume.tsdf.data_ptr(), volume.weight.data_ptr(), volume.gray.data_ptr(),
                intrinsics.data_ptr(), pose.data_ptr(), depth.data_ptr(), gray.data_ptr(),
                d, h, w, img_h, img_w, n_steps, step, inv_voxel, *map(float, lo),
                *map(float, hi), min_weight, cfg.min_depth, max_depth, cfg.truncation,
                cfg.truncation_scale_sq, stream)
    build.check(status, "raycast_volume")
    raycast_volume.launches += 1
    return depth, gray


def raycast_volume(volume, intrinsics, pose, cfg, shape, n_steps: int, step: float,
                   min_weight: float, max_depth: float, box):
    """Render a CUDA ``volume`` (three float32 (D, H, W) fields, contiguous)
    by the volume march -> (depth_m, gray), (H, W) float32 on its device:
    ``intrinsics`` 3x3 and ``pose`` the 4x4 camera-to-world, float32 on the
    volume's device; ``shape`` (H, W); ``n_steps`` and ``step`` the march's
    (``tsdf.volume_march_steps``); ``box`` the volume's lowest and highest
    world corners (``tsdf.volume_box``); ``cfg`` a ``TSDFConfig``.  Raises on
    what the kernel does not take, and on any device but CUDA."""
    _check_volume("raycast_volume", volume, (intrinsics, pose))
    if tuple(intrinsics.shape) != (3, 3) or tuple(pose.shape) != (4, 4):
        raise ValueError("intrinsics must be 3x3 and pose 4x4")
    if len(shape) != 2 or min(shape) < 1 or shape[0] * shape[1] >= 2**31:
        raise ValueError(f"raycast_volume: shape must be a positive (H, W), got {shape}")
    if volume.tsdf.device.type != "cuda":
        raise RuntimeError(f"raycast_volume: no kernel for device {volume.tsdf.device}")
    return _launch_raycast(volume, intrinsics, pose, cfg, tuple(int(n) for n in shape),
                           int(n_steps), step, min_weight, max_depth, box)


raycast_volume.launches = 0
