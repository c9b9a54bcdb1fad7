"""Distributed windowed bundle adjustment over ranks, and their bring-up.

Counterpart of ``dense_visual_odometry_tpu/parallel/distributed.py`` on
``torch.distributed``, one process per device.  The pose-graph normal
system is additive over edges (``posegraph.build_normal_system``), so each
rank linearizes its contiguous share of the edges, and one ``all_reduce``
(SUM) a Gauss-Newton iteration of (chi2, H (K, K, 6, 6), b (K, 6)), packed
into one flat float32 buffer, gives every rank the global system.  The
(6K, 6K) solve then runs redundantly on every rank, so the poses stay
replicated and identical bit for bit across ranks.  Zero-information
self-edges (:func:`pad_edges`) make any edge count divide the ranks.

Backends: NCCL between GPUs, gloo on the CPU (and for several ranks that
share one GPU, where NCCL refuses).
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from dense_visual_odometry_torch.models.posegraph import (
    PoseGraphEdges,
    PoseGraphResult,
    build_normal_system,
    gauss_newton,
)
from dense_visual_odometry_torch.models.robust import resolve_device
from dense_visual_odometry_torch.parallel.collectives import (
    BATCH_AXIS,
    all_reduce_system,
    mesh_rank,
)


def pad_edges(edges: PoseGraphEdges, multiple: int) -> PoseGraphEdges:
    """Pad the edge set with zero-information self-edges (no-ops) so that
    the edge count divides ``multiple``."""
    rem = (-edges.i.shape[0]) % multiple
    if rem == 0:
        return edges
    dev = edges.measurement.device
    zero_idx = torch.zeros((rem,), dtype=edges.i.dtype, device=dev)
    return PoseGraphEdges(
        i=torch.cat([edges.i, zero_idx]),
        j=torch.cat([edges.j, zero_idx]),
        measurement=torch.cat(
            [edges.measurement, torch.eye(4, device=dev).expand(rem, 4, 4)]),
        information=torch.cat(
            [edges.information, torch.zeros((rem, 6, 6), device=dev)]),
    )


def optimize_pose_graph_sharded(
    mesh: DeviceMesh,
    poses: torch.Tensor,
    edges: PoseGraphEdges,
    max_iterations: int = 10,
    tolerance: float = 1e-9,
    gauge_weight: float = 1e6,
    damping: float = 1e-6,
    axis_name: str = BATCH_AXIS,
) -> PoseGraphResult:
    """``optimize_pose_graph`` with the edges sharded over ``mesh``: every
    rank passes the whole graph, linearizes its contiguous 1/world of the
    padded edges, and returns the replicated result.  Every rank of the
    mesh must call this together."""
    rank, world, group = mesh_rank(mesh, axis_name)
    edges = pad_edges(edges, world)
    per = edges.i.shape[0] // world
    mine = PoseGraphEdges(*(x[rank * per:(rank + 1) * per] for x in edges))
    k = poses.shape[0]

    def system(ps):
        return all_reduce_system(*build_normal_system(ps, mine, k), group)

    return gauss_newton(poses, system, max_iterations, tolerance, gauge_weight, damping)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> Tuple[int, int]:
    """Initialise the default process group -> (rank, world size).

    Here one process drives one device (``torchrun --nproc_per_node=N``
    starts them), where the JAX package's one process drove every local
    device.  With ``coordinator_address`` ("host:port") the group meets
    over ``tcp://`` with ``num_processes`` and ``process_id`` given;
    without it, torchrun's environment (``MASTER_ADDR``, ``RANK``,
    ``WORLD_SIZE``) is read where it is set, and otherwise nothing is
    initialised and a single process is (0, 1).  ``device``: None is the
    GPU (raises without one), whose backend is NCCL, and each process then
    selects ``cuda:LOCAL_RANK`` (else its rank modulo the GPUs; a device
    with an index is taken as given); ``"cpu"`` takes gloo.  ``backend``
    overrides the choice (gloo for several ranks on one GPU).
    """
    device = resolve_device(device)
    backend = backend or default_backend(device)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and process_id")
        init_method = f"tcp://{coordinator_address}"
        rank, world = process_id, num_processes
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        init_method = "env://"
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        return 0, 1
    if device.type == "cuda":
        local = os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())
        torch.cuda.set_device(device.index if device.index is not None else int(local))
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return dist.get_rank(), dist.get_world_size()


def default_backend(device) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _rank_main(rank, world, backend, root, target, args):
    """One spawned rank: join the group over ``root``'s file store, run
    ``target(rank, world, *args)`` and save what it returns (or its
    traceback) under ``root``."""
    root = Path(root)
    try:
        dist.init_process_group(backend, init_method=f"file://{root / 'store'}",
                                rank=rank, world_size=world)
        torch.save(target(rank, world, *args), root / f"rank{rank}.pt")
    except BaseException:
        (root / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(
    target: Callable,
    world: int,
    args: Sequence = (),
    backend: str = "gloo",
    timeout_s: float = 180.0,
    root: Optional[Path] = None,
) -> List:
    """Run ``target(rank, world, *args)`` in ``world`` spawned processes,
    each the rank of a default group of ``backend`` that meets over a file
    store (no TCP port) -> each rank's return value.  ``target`` must be
    importable by name (a module-level function); tensors in ``args`` and
    in the results travel on the CPU.  Raises ``RuntimeError`` with each
    failed rank's traceback, or naming the ranks still running after
    ``timeout_s`` or after another rank failed (they are killed, as they
    would wait for it in their next collective): a rank that fails or hangs
    fails the call instead of holding it."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=root) as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main, args=(r, world, backend, tmp, target, tuple(args)))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while (time.monotonic() < deadline and any(p.is_alive() for p in procs)
               and not any(p.exitcode for p in procs)):
            time.sleep(0.1)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = [(Path(tmp) / f"rank{r}.err").read_text()
                  for r in range(world) if (Path(tmp) / f"rank{r}.err").exists()]
        if hung or errors or any(p.exitcode != 0 for p in procs):
            raise RuntimeError(
                f"ranks failed: exit codes {[p.exitcode for p in procs]}; killed while "
                f"still running: {hung}\n" + "\n".join(errors))
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
