"""The collectives of the multi-device back end, on a 1-D ``DeviceMesh``.

One process per device; the mesh's one dimension is :data:`BATCH_AXIS`
(the JAX package's mesh axis).  Kept apart from the models so that they
can import it without a cycle.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

BATCH_AXIS = "data"


def mesh_rank(mesh: DeviceMesh, axis_name: str = BATCH_AXIS) -> Tuple[int, int, object]:
    """-> (this rank's coordinate along ``axis_name``, the axis' size, its
    process group)."""
    group = mesh.get_group(axis_name)
    return mesh.get_local_rank(axis_name), dist.get_world_size(group), group


def all_gather_batch(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((dist.get_world_size(group) * moved.shape[0],) + moved.shape[1:],
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def all_reduce_system(chi2, hess, rhs, group):
    """(chi2, H, b) summed over ``group`` in one ``all_reduce`` of a packed
    float32 buffer of 1 + H.numel() + b.numel() floats."""
    flat = torch.cat([chi2.reshape(1), hess.reshape(-1), rhs.reshape(-1)])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    n_h = hess.numel()
    return (flat[0], flat[1:1 + n_h].reshape(hess.shape),
            flat[1 + n_h:].reshape(rhs.shape))
