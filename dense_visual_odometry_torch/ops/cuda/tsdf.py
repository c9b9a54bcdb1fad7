"""Dense TSDF fusion: one frame into a whole volume, one launch.

No Pallas counterpart: ``dense_visual_odometry_tpu/models/tsdf.py``
integrates in plain jnp.  :func:`integrate_volume` updates the volume's
three fields in place as
:func:`~dense_visual_odometry_torch.models.tsdf.integrate_plain` does, by
launching ``csrc/tsdf_fuse.cu`` (a thread per four consecutive x-voxels,
the plain version's float32 operations in its order, so the two agree bit
for bit).  It takes CUDA volumes only;
:func:`~dense_visual_odometry_torch.models.tsdf.integrate` sends CPU ones
to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from dense_visual_odometry_torch.ops.cuda import build


def _check_inputs(volume, depth_m, gray, intrinsics, world_to_cam, axes) -> None:
    fields = tuple(volume)
    shape = fields[0].shape
    if len(shape) != 3 or any(f.shape != shape for f in fields):
        raise ValueError(f"the volume's fields must share one (D, H, W) shape, got "
                         f"{[tuple(f.shape) for f in fields]}")
    frame = (depth_m, gray, intrinsics, world_to_cam, *axes)
    if any(t.dtype != torch.float32 for t in fields + frame):
        raise TypeError(f"integrate_volume: the volume and the frame must be float32, got "
                        f"{sorted({str(t.dtype) for t in fields + frame})}")
    if not all(f.is_contiguous() for f in fields):
        raise ValueError("integrate_volume: the volume's fields must be contiguous")
    if any(t.device != fields[0].device for t in frame):
        raise ValueError("integrate_volume: the frame must be on the volume's device")
    # The kernel indexes voxels and pixels in 32 bits.
    if fields[0].numel() >= 2**31:
        raise ValueError(f"integrate_volume: a {tuple(shape)} volume exceeds the kernel's "
                         f"32-bit indexing")
    if depth_m.dim() != 2 or gray.shape != depth_m.shape:
        raise ValueError(f"depth and gray must be one (H, W) shape, got "
                         f"{tuple(depth_m.shape)} and {tuple(gray.shape)}")
    if tuple(intrinsics.shape) != (3, 3) or tuple(world_to_cam.shape) != (4, 4):
        raise ValueError("intrinsics must be 3x3 and world_to_cam 4x4")
    d, h, w = shape
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
