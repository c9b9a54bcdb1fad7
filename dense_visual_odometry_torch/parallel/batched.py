"""Batched multi-pair tracking, on one GPU or sharded over ranks.

Counterpart of ``dense_visual_odometry_tpu/parallel/batched.py``: B
independent frame pairs ride the batch dimension of every tensor of one
solve.  With a device mesh the batch is split over ranks, one process per
device (``torchrun``, or ``torch.multiprocessing``): the JAX package's 1-D
``Mesh`` becomes a 1-D ``torch.distributed`` ``DeviceMesh`` whose one
dimension is named :data:`BATCH_AXIS`.  Every rank takes the whole batch,
tracks its contiguous slice with the batch-global decisions taken over the
group (``models/robust.py`` lists them), and all-gathers the results, so
each rank returns what :func:`batched_track_pair` returns for the whole
batch on one device.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from dense_visual_odometry_torch.camera import CameraModel
from dense_visual_odometry_torch.config import RobustDVOConfig
from dense_visual_odometry_torch.models.robust import (
    FrameData,
    LevelDiagnostics,
    TrackResult,
    resolve_device,
    track_pair,
)
from dense_visual_odometry_torch.parallel.collectives import (
    BATCH_AXIS,
    all_gather_batch,
    mesh_rank,
)


def make_mesh(devices=None, axis_name: str = BATCH_AXIS) -> DeviceMesh:
    """A 1-D ``DeviceMesh`` over every rank of the initialised default
    group.  ``devices``: the ranks' device type, ``"cuda"`` (the default;
    raises without a GPU) unless ``"cpu"`` is asked for.  Raises if no
    group is initialised (see ``parallel.distributed.init_distributed``)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised default process group: call "
            "init_distributed (or torch.distributed.init_process_group) first"
        )
    device_type = resolve_device(devices).type
    return DeviceMesh(
        device_type, list(range(dist.get_world_size())), mesh_dim_names=(axis_name,)
    )


def _tree_map(fn, tree):
    """``fn`` on every tensor of nested tuples, lists and NamedTuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def _rank_slice(n: int, rank: int, world: int) -> slice:
    if n % world:
        raise ValueError(
            f"the batch ({n}) must divide the ranks ({world}): pad it with "
            "pad_batch_to_devices"
        )
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def shard_batch(tree, mesh: DeviceMesh, axis_name: str = BATCH_AXIS):
    """This rank's contiguous slice of the leading axis of every tensor of
    ``tree``; raises unless that axis divides the ranks."""
    rank, world, _ = mesh_rank(mesh, axis_name)
    sizes = set()
    _tree_map(lambda x: sizes.add(x.shape[0]), tree)
    if len(sizes) != 1:
        raise ValueError(f"leaves have different leading axes: {sorted(sizes)}")
    sl = _rank_slice(sizes.pop(), rank, world)
    return _tree_map(lambda x: x[sl], tree)


def stack_frame_data(frames: Sequence[FrameData]) -> FrameData:
    """Stack per-pair (H, W)-level ``FrameData`` into one (B, H, W) batch."""
    levels = len(frames[0].gray)
    return FrameData(
        gray=tuple(torch.stack([f.gray[lv] for f in frames]) for lv in range(levels)),
        depth_m=tuple(
            torch.stack([f.depth_m[lv] for f in frames]) for lv in range(levels)
        ),
    )


def batched_track_pair(
    prev: FrameData,
    curr: FrameData,
    intrinsics: torch.Tensor,
    cfg: RobustDVOConfig,
    init_guess: Optional[torch.Tensor] = None,
    last_transform: Optional[torch.Tensor] = None,
    group=None,
) -> TrackResult:
    """Track B pairs at once on the device of the pyramids.

    prev / curr: ``FrameData`` with (B, H, W) levels; intrinsics (3, 3)
    shared or (B, 3, 3); init_guess / last_transform optional (B, 4, 4);
    ``group``: as ``track_pair``'s (this rank's slice of a sharded batch).
    """
    camera = CameraModel(
        intrinsics=torch.as_tensor(intrinsics, dtype=torch.float32).to(
            prev.gray[0].device
        ),
        depth_scale=1.0,
    )
    return track_pair(
        prev, curr, camera, cfg,
        init_guess=init_guess, last_transform=last_transform, group=group,
    )


def make_batched_tracker(
    cfg: RobustDVOConfig, mesh: Optional[DeviceMesh] = None, axis_name: str = BATCH_AXIS
) -> Callable[..., TrackResult]:
    """-> ``run(prev, curr, intrinsics, **kw)``: :func:`batched_track_pair`
    under ``cfg``.

    With a mesh every rank passes the whole batch (the JAX tracker's global
    arrays) and gets the whole ``TrackResult``: it tracks its slice of the
    pairs, with per-pair intrinsics, ``init_guess`` and ``last_transform``
    sliced alike, and all-gathers the transforms, success flags, Hessians
    and per-level diagnostics.  Every rank must call ``run`` together."""
    if mesh is None:
        def run(prev, curr, intrinsics, **kw):
            return batched_track_pair(prev, curr, intrinsics, cfg, **kw)

        return run

    rank, world, group = mesh_rank(mesh, axis_name)

    def run(prev, curr, intrinsics, **kw):
        sl = _rank_slice(prev.gray[0].shape[0], rank, world)

        def per_pair(x):  # a (B, ...) per-pair input, or one shared by all
            if x is None or not isinstance(x, torch.Tensor) or x.ndim < 3:
                return x
            return x[sl]

        res = batched_track_pair(
            *shard_batch((prev, curr), mesh, axis_name), per_pair(intrinsics), cfg,
            group=group, **{k: per_pair(v) for k, v in kw.items()},
        )
        d = res.diagnostics
        return TrackResult(
            transform=all_gather_batch(res.transform, group),
            success=all_gather_batch(res.success, group),
            diagnostics=LevelDiagnostics(
                iterations=d.iterations,  # already the maximum over ranks
                error=all_gather_batch(d.error, group, dim=1),
                count=all_gather_batch(d.count, group, dim=1),
                scale=all_gather_batch(d.scale, group, dim=1),
            ),
            hessian=all_gather_batch(res.hessian, group),
        )

    return run


def pad_batch_to_devices(frames, n_devices: int) -> Tuple[list, int]:
    """Pad a list of per-pair items so the batch divides ``n_devices``:
    -> (padded list, original length).  Padding repeats the last pair;
    callers slice results back to the original length."""
    orig = len(frames)
    if orig == 0:
        raise ValueError("empty batch")
    rem = (-orig) % n_devices
    return list(frames) + [frames[-1]] * rem, orig
