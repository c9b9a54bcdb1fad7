"""The multi-device dry run: every sharded path held against one device.

Counterpart of ``__graft_entry__.py``'s ``dryrun_multichip``, which runs on
the JAX package's device mesh (1) sharded batched tracking, (2) the same on
the tile level-kernel path, (3) the edge-sharded pose graph over the
tracked chain and (4) the owner-sharded dense BA, each against its
single-device run.  Here the calling rank runs them over a ``DeviceMesh``
(every rank of it calls :func:`dryrun_multichip` together), at the sizes
and under the configurations the caller gives: the tests small on the CPU,
``chip_smoke.py`` at 640x480 on the GPU.
"""

from __future__ import annotations

import time
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from dense_visual_odometry_torch.config import RobustDVOConfig
from dense_visual_odometry_torch.models.dense_ba import (
    DenseBAConfig,
    DenseBAData,
    optimize_dense_ba,
    optimize_dense_ba_sharded,
)
from dense_visual_odometry_torch.models.posegraph import (
    PoseGraphEdges,
    concat_edges,
    odometry_chain_edges,
    optimize_pose_graph,
)
from dense_visual_odometry_torch.models.robust import FrameData
from dense_visual_odometry_torch.parallel.batched import (
    batched_track_pair,
    make_batched_tracker,
)
from dense_visual_odometry_torch.parallel.distributed import optimize_pose_graph_sharded
from dense_visual_odometry_torch.utils.lie import se3

# Sharded against single-device: the JAX dry run's tracking and pose-graph
# bound (``__graft_entry__.py:113-117``, ``:166-169``) and the JAX package's
# sharded dense BA test's (``tests/unit/test_dense_ba.py:139-148``).
# Success flags must be equal (a bound of 0 differing).
BOUNDS = {"transform": 1e-5, "success_differs": 0.0, "pose_graph": 1e-5, "ba_poses": 2e-5,
          "ba_inv_depth": 1e-4, "ba_chi2_rel": 1e-3}


class DryRun(NamedTuple):
    sharded: Dict[str, tuple]  # check -> the sharded run's result
    single: Dict[str, tuple]  # check -> the single-device run's result
    errors: Dict[str, Dict[str, float]]  # check -> field -> max |sharded - single|
    wall_ms: Dict[str, Dict[str, float]]  # check -> {"sharded", "single"} median ms


def chain_graph(transforms: torch.Tensor, loops: Sequence[Tuple[int, int]],
                noise: float = 1e-3, seed: int = 0) -> Tuple[torch.Tensor, PoseGraphEdges]:
    """A pose graph over the tracked chain: -> (initial poses, edges).

    ``transforms`` (N, 4, 4) chain N + 1 poses (``odometry_chain_edges``,
    identity information); each loop (a, b) adds an edge whose measurement
    is the chain's relative pose perturbed by a seeded twist of scale
    ``noise``, so that the loops disagree with the chain.  The initial
    poses integrate the chain."""
    dev = transforms.device
    chain = odometry_chain_edges(transforms)
    poses = [torch.eye(4, dtype=torch.float32, device=dev)]
    for m in chain.measurement:
        poses.append(poses[-1] @ m)
    poses = torch.stack(poses)
    rng = np.random.default_rng(seed)
    a = torch.tensor([x for x, _ in loops], dtype=torch.int32, device=dev)
    b = torch.tensor([y for _, y in loops], dtype=torch.int32, device=dev)
    twist = torch.tensor(rng.normal(size=(len(loops), 6)) * noise, dtype=torch.float32,
                         device=dev)
    meas = se3.inverse(poses[a.long()]) @ poses[b.long()] @ se3.exp(twist)
    info = torch.eye(6, dtype=torch.float32, device=dev).expand(len(loops), 6, 6).clone()
    return poses, concat_edges(chain, PoseGraphEdges(a, b, meas, info))


def _timed(fn, repeats: int, device: torch.device):
    """-> (the last result, median wall ms of ``repeats`` calls)."""
    times, out = [], None
    for _ in range(repeats):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.median(times))


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(b.device) - b).abs().max())


def _checks(prev, curr, intrinsics, configs, graph, ba, graph_iterations, ba_config):
    """-> [(check name, sharded run(mesh), single-device run())] of the four
    kinds of check."""
    out = []
    for name, cfg in configs.items():
        out.append((f"track_{name}",
                    lambda mesh, cfg=cfg: make_batched_tracker(cfg, mesh)(prev, curr, intrinsics),
                    lambda cfg=cfg: batched_track_pair(prev, curr, intrinsics, cfg)))
    poses0, edges = graph
    out.append(("pose_graph",
                lambda mesh: optimize_pose_graph_sharded(mesh, poses0, edges, graph_iterations),
                lambda: optimize_pose_graph(poses0, edges, graph_iterations)))
    for name, (poses, data) in ba.items():
        out.append((f"dense_ba_{name}",
                    lambda mesh, p=poses, d=data: optimize_dense_ba_sharded(mesh, p, d, ba_config),
                    lambda p=poses, d=data: optimize_dense_ba(p, d, ba_config)))
    return out


def _errors(sharded, single) -> Dict[str, float]:
    """max |sharded - single| of a check's result fields (chi2 relative)."""
    if hasattr(single, "transform"):
        return {"transform": _max_abs(sharded.transform, single.transform),
                "success_differs": float((sharded.success.cpu() != single.success.cpu()).sum())}
    if hasattr(single, "iterations"):
        return {"pose_graph": _max_abs(sharded.poses, single.poses)}
    return {"ba_poses": _max_abs(sharded.poses, single.poses),
            "ba_inv_depth": _max_abs(sharded.inv_depth, single.inv_depth),
            "ba_chi2_rel": abs(float(sharded.chi2) - float(single.chi2))
            / max(abs(float(single.chi2)), 1e-30)}


def single_device(
    prev: FrameData,
    curr: FrameData,
    intrinsics: torch.Tensor,
    configs: Mapping[str, RobustDVOConfig],
    graph: Tuple[torch.Tensor, PoseGraphEdges],
    ba: Mapping[str, Tuple[torch.Tensor, DenseBAData]],
    graph_iterations: int = 10,
    ba_config: DenseBAConfig = DenseBAConfig(),
    repeats: int = 1,
) -> Tuple[Dict[str, tuple], Dict[str, float]]:
    """The checks' single-device runs, with no process group: -> (check ->
    result, check -> median wall ms); arguments as :func:`dryrun_multichip`'s."""
    results, wall = {}, {}
    for name, _, single in _checks(prev, curr, intrinsics, configs, graph, ba,
                                   graph_iterations, ba_config):
        results[name], wall[name] = _timed(single, repeats, prev.gray[0].device)
    return results, wall


def dryrun_multichip(
    mesh: DeviceMesh,
    prev: FrameData,
    curr: FrameData,
    intrinsics: torch.Tensor,
    configs: Mapping[str, RobustDVOConfig],
    graph: Tuple[torch.Tensor, PoseGraphEdges],
    ba: Mapping[str, Tuple[torch.Tensor, DenseBAData]],
    graph_iterations: int = 10,
    ba_config: DenseBAConfig = DenseBAConfig(),
    single: Optional[Dict[str, tuple]] = None,
    repeats: int = 1,
    unheld: Sequence[str] = (),
) -> DryRun:
    """Run the checks on this rank; raise ``AssertionError`` where a sharded
    result leaves :data:`BOUNDS` of its single-device run, but for the
    checks named in ``unheld``, whose errors are only reported.

    prev / curr / intrinsics: the whole batch (every rank's); ``configs``:
    name -> tracker configuration (the JAX dry run's plain and tile
    level-kernel ones, or others; check ``track_<name>``); ``graph``:
    (initial poses, edges) (:func:`chain_graph`; check ``pose_graph``);
    ``ba``: name -> (keyframe poses, data) (check ``dense_ba_<name>``).
    ``single``: the single-device results to hold the sharded ones against
    (:func:`single_device`'s, on any device), else computed here on this
    rank's device.  Each run is made ``repeats`` times and timed."""
    single_ms = {}
    if single is None:
        single, single_ms = single_device(prev, curr, intrinsics, configs, graph, ba,
                                          graph_iterations, ba_config, repeats)
    sharded, wall, errors, failed = {}, {}, {}, []
    for name, run, _ in _checks(prev, curr, intrinsics, configs, graph, ba,
                                graph_iterations, ba_config):
        sharded[name], ms = _timed(lambda: run(mesh), repeats, prev.gray[0].device)
        wall[name] = {"sharded": ms, "single": single_ms.get(name)}
        errors[name] = _errors(sharded[name], single[name])
        if name not in unheld:
            failed += [(name, field, err) for field, err in errors[name].items()
                       if not err <= BOUNDS.get(field, 0.0)]
    if failed:
        raise AssertionError(f"sharded runs part from single-device runs: {failed}")
    return DryRun(sharded=sharded, single=single, errors=errors, wall_ms=wall)
