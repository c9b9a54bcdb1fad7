"""The multi-device back end on ``torch.distributed``, on the CPU.

One gloo world of 4 spawned processes (``parallel.distributed.spawn_ranks``:
a file store under the test's temporary directory, so no TCP port, one torch
thread a rank) runs every sharded case once and returns its results; the
tests compare them.  World 1 runs in the test process.  The join has a
timeout, so a hang fails the tests instead of holding the suite.

- The dry run (``parallel.dryrun.dryrun_multichip``): sharded tracking under
  ``tpu_fast`` and under ``tpu_slam`` with 8 x 10 tiles (the tile
  level-kernel path), the edge-sharded pose graph over the tracked chain
  with loop edges, and the owner-sharded dense BA on the JAX package's
  8-keyframe planes, each against the single-device run: bit for bit at
  world 1, within the JAX package's bounds at world 4 (transforms 1e-5 with
  equal success flags, pose-graph poses 1e-5, dense BA poses 2e-5, inverse
  depths 1e-4, chi2 1e-3 relative), and the replicated poses equal bit for
  bit across the 4 ranks.
- The hard-motion trigger: at 120x160, B=8, exactly one pair (index 4, on
  rank 2) trips it; the sharded result equals the single-device one, and
  rank 0's pairs tracked alone (each rank deciding for itself) part from it
  by far more than 1e-5.
- The retrack: ``retrack_max_scale`` lies between the pairs' scales so that
  only rank 1 has a "bad" element; every rank must run the second cascade
  (its triggers are collectives), and the run ends within the timeout and
  equals the single-device one.
- Against the JAX package's own sharded functions on its 8-device CPU mesh:
  the pose graph on ``tests/unit/test_distributed._graph``'s graphs within
  1e-4 (that test's bound) and the dense BA on ``_planar_sequence`` (K=8)
  within 2e-5 / 1e-4 / 1e-3; ``pad_edges`` equal to the JAX package's.
- ``shard_batch`` gives each rank 2 of 8 pairs; K not dividing the ranks
  raises.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dense_visual_odometry_torch.camera import CameraModel
from dense_visual_odometry_torch.config import RobustDVOConfig
from dense_visual_odometry_torch.io import synthetic
from dense_visual_odometry_torch.models import robust
from dense_visual_odometry_torch.models.dense_ba import (
    DenseBAConfig,
    build_dense_ba_data,
    build_reduced_system,
    optimize_dense_ba_sharded,
    reduced_system_sharded,
)
from dense_visual_odometry_torch.models.posegraph import PoseGraphEdges
from dense_visual_odometry_torch.parallel import (
    batched_track_pair,
    make_batched_tracker,
    make_mesh,
    shard_batch,
    stack_frame_data,
)
from dense_visual_odometry_torch.parallel.distributed import (
    default_backend,
    init_distributed,
    optimize_pose_graph_sharded,
    pad_edges,
    spawn_ranks,
)
from dense_visual_odometry_torch.parallel.dryrun import (
    BOUNDS,
    chain_graph,
    dryrun_multichip,
    single_device,
)

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
WORLD = 4
TIMEOUT_S = 180.0
H, W, BAND = 120, 160, 16
# (3, 5) alone trips the trigger at levels 1 and 0; no other pair does.
TRIGGER_PAIRS = [(0, 1), (4, 5), (6, 7), (9, 10), (3, 5), (10, 11), (8, 10), (0, 3)]
HARD = 4  # its index: rank 2's first pair
# (0, 3)'s finest scale is ~7.7, every other pair's below 4.3.
RETRACK_PAIRS = [(0, 1), (4, 5), (6, 7), (0, 3), (9, 10), (10, 11), (8, 10), (6, 7)]
RETRACK_SCALE = 5.0
BAD = 3  # rank 1's second pair
LOOPS = [(0, 4), (2, 6), (1, 7)]  # loop edges of the dry run's pose graph
GRAPH_ITERS = 10
BA_CFG = DenseBAConfig(max_iterations=5)  # the JAX sharded dense BA test's
JAX_GRAPHS = {"k6": dict(k=6, extra_edges=5), "k8": dict(k=8, extra_edges=8)}
JAX_GRAPH_ITERS = 15


def config(name, **overrides):
    data = json.loads((CONFIGS / f"{name}.json").read_text())
    return RobustDVOConfig.from_dict({**data, **overrides})


TRACK_CONFIGS = {
    "fast": config("tpu_fast"),
    # chip_smoke.VARIANTS["slam_tiles_cb48"]: the tile level-kernel path.
    "slam_tiles": config("tpu_slam", recenter_blocks=8, recenter_col_blocks=10,
                         fallback_max_rotation=0.25, recenter_center_bound=48),
}
RETRACK_CONFIG = dataclasses.replace(TRACK_CONFIGS["fast"], retrack_max_scale=RETRACK_SCALE)


def _scene():
    gray, depth, k = synthetic.textured_scene(H, W, seed=0)
    poses = synthetic.handheld_trajectory(12, seed=0)
    grays, depths = synthetic.render_sequence(gray, depth, k, poses)
    for d in depths:
        d[:BAND], d[-BAND:], d[:, :BAND], d[:, -BAND:] = 0, 0, 0, 0
    cam = CameraModel.create(k, 1.0)
    frames = [robust.preprocess_frame(g, d, cam, levels=4, device="cpu")
              for g, d in zip(grays, depths)]
    return frames, cam.intrinsics


def _batch(frames, pairs):
    return (stack_frame_data([frames[i] for i, _ in pairs]),
            stack_frame_data([frames[j] for _, j in pairs]))


def _planar_ba():
    """The JAX package's sharded dense BA case (``tests/unit/test_dense_ba.py``
    ``test_sharded_matches_single_device``) -> (grays, depths, noisy poses)."""
    from tests.unit.test_dense_ba import _planar_sequence

    grays, depths, gt = _planar_sequence(8, tx=0.015)
    rng = np.random.default_rng(1)
    noisy = gt.copy()
    noisy[1:, 0, 3] += rng.uniform(-0.005, 0.005, size=7)
    return grays, depths, noisy.astype(np.float32)


def _jax_graphs():
    """``tests/unit/test_distributed._graph`` on the JAX tests' seed -> name
    -> (noisy poses, edges) as numpy."""
    from tests.unit.test_distributed import _graph

    out = {}
    for name, kw in JAX_GRAPHS.items():
        _, noisy, e = _graph(np.random.default_rng(1234), **kw)
        out[name] = (np.asarray(noisy), tuple(np.asarray(x) for x in e))
    return out


def _torch_edges(e) -> PoseGraphEdges:
    return PoseGraphEdges(*(torch.as_tensor(x) for x in e))


def _inputs():
    """Every case's inputs, and their single-device results, on the CPU."""
    from tests.unit.test_dense_ba import K_MAT

    frames, k = _scene()
    prev, curr = _batch(frames, TRIGGER_PAIRS)
    chain = batched_track_pair(prev, curr, k, TRACK_CONFIGS["fast"]).transform[:-1]
    graph = chain_graph(chain, LOOPS)
    grays, depths, noisy = _planar_ba()
    ba = {"planar": (torch.tensor(noisy),
                     build_dense_ba_data(grays, depths, K_MAT, grid_stride=6, device="cpu"))}
    single, _ = single_device(prev, curr, k, TRACK_CONFIGS, graph, ba, GRAPH_ITERS, BA_CFG)
    ba6 = (torch.tensor(noisy[:6]),
           build_dense_ba_data(grays[:6], depths[:6], K_MAT, grid_stride=6, device="cpu"))
    return dict(prev=prev, curr=curr, k=k, graph=graph, ba=ba, ba6=ba6, single=single,
                retrack=_batch(frames, RETRACK_PAIRS), jax_graphs=_jax_graphs())


def _rank_cases(rank, world, inputs):
    """Every sharded case on one rank of the gloo world -> its results."""
    torch.set_num_threads(1)
    mesh = make_mesh("cpu")
    out = {}
    run = dryrun_multichip(mesh, inputs["prev"], inputs["curr"], inputs["k"], TRACK_CONFIGS,
                           inputs["graph"], inputs["ba"], GRAPH_ITERS, BA_CFG,
                           single=inputs["single"])
    out["dryrun"] = {name: _arrays(r) for name, r in run.sharded.items()}
    out["errors"] = run.errors
    # Rank-local semantics: this rank's pairs alone, no group.
    mine = shard_batch((inputs["prev"], inputs["curr"]), mesh)
    out["alone"] = batched_track_pair(*mine, inputs["k"], TRACK_CONFIGS["fast"]).transform
    out["shard_batch"] = [tuple(x.shape) for x in mine[0].gray]
    out["shard_equal"] = all(
        torch.equal(a, b[2 * rank:2 * rank + 2]) for a, b in zip(mine[0].gray, inputs["prev"].gray))
    out["retrack"] = _arrays(make_batched_tracker(RETRACK_CONFIG, mesh)(*inputs["retrack"],
                                                                         inputs["k"]))
    out["jax_graphs"] = {
        name: optimize_pose_graph_sharded(mesh, torch.tensor(p), _torch_edges(e),
                                          JAX_GRAPH_ITERS).poses
        for name, (p, e) in inputs["jax_graphs"].items()}
    out["reduced"] = reduced_system_sharded(mesh, *inputs["ba"]["planar"], BA_CFG)
    try:  # K = 6 keyframes over 4 ranks
        optimize_dense_ba_sharded(mesh, *inputs["ba6"], BA_CFG)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def _arrays(result) -> dict:
    return {f: getattr(result, f) for f in result._fields
            if isinstance(getattr(result, f), torch.Tensor)}


@pytest.fixture(scope="module")
def inputs():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield _inputs()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world4(inputs, tmp_path_factory):
    return spawn_ranks(_rank_cases, WORLD, (inputs,), backend="gloo", timeout_s=TIMEOUT_S,
                       root=tmp_path_factory.mktemp("world4"))


@pytest.fixture
def world1(tmp_path):
    """A gloo group of one rank in the test process."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        yield make_mesh("cpu")
    finally:
        dist.destroy_process_group()


def test_world1_is_single_device_bit_for_bit(inputs, world1):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run = dryrun_multichip(world1, inputs["prev"], inputs["curr"], inputs["k"],
                               TRACK_CONFIGS, inputs["graph"], inputs["ba"], GRAPH_ITERS,
                               BA_CFG)
    finally:
        torch.set_num_threads(n)
    fields = {"track_fast": ("transform", "success", "hessian"),
              "track_slam_tiles": ("transform", "success", "hessian"),
              "pose_graph": ("poses", "chi2", "chi2_history", "iterations"),
              "dense_ba_planar": ("poses", "inv_depth", "chi2", "chi2_history")}
    for check, names in fields.items():
        for name in names:
            s, r = getattr(run.sharded[check], name), getattr(run.single[check], name)
            assert torch.equal(s, r), (check, name)
        if check.startswith("track"):
            for name in ("iterations", "error", "count", "scale"):
                assert torch.equal(getattr(run.sharded[check].diagnostics, name),
                                   getattr(run.single[check].diagnostics, name)), (check, name)
    # The single-device runs equal those made without any group.
    for check in fields:
        for name in fields[check][:2]:
            assert torch.equal(getattr(run.single[check], name),
                               getattr(inputs["single"][check], name)), (check, name)


@pytest.mark.parametrize("check", ["track_fast", "track_slam_tiles", "pose_graph",
                                   "dense_ba_planar"])
def test_world4_within_bounds_of_single_device(world4, inputs, check):
    single = inputs["single"][check]
    for rank, res in enumerate(world4):
        got = res["dryrun"][check]
        if check.startswith("track"):
            err = (got["transform"] - single.transform).abs().max()
            assert float(err) <= BOUNDS["transform"], rank
            assert torch.equal(got["success"], single.success), rank
        elif check == "pose_graph":
            assert float((got["poses"] - single.poses).abs().max()) <= BOUNDS["pose_graph"]
        else:
            assert float((got["poses"] - single.poses).abs().max()) <= BOUNDS["ba_poses"]
            assert float((got["inv_depth"] - single.inv_depth).abs().max()) <= \
                BOUNDS["ba_inv_depth"]
            assert abs(float(got["chi2"]) - float(single.chi2)) <= \
                BOUNDS["ba_chi2_rel"] * abs(float(single.chi2))
        # Every rank returns the same (replicated or gathered) result.
        for name, x in got.items():
            assert torch.equal(x, world4[0]["dryrun"][check][name]), (rank, name)


def test_trigger_is_decided_over_every_rank(world4, inputs, monkeypatch):
    """Exactly one pair, on rank 2, trips the trigger; the sharded run
    follows the whole batch's decision, and deciding per rank would not."""
    hard = []
    real = robust._any_over_ranks

    def spy(mask, group):
        hard.append(mask.clone())
        return real(mask, group)

    monkeypatch.setattr(robust, "_any_over_ranks", spy)
    batched_track_pair(inputs["prev"], inputs["curr"], inputs["k"], TRACK_CONFIGS["fast"])
    tripped = torch.stack(hard[:-1]).any(dim=0)  # the levels' triggers (the last: retrack)
    assert tripped.nonzero().flatten().tolist() == [HARD]
    single = inputs["single"]["track_fast"].transform
    sharded = world4[0]["dryrun"]["track_fast"]["transform"]
    assert float((sharded - single).abs().max()) <= 1e-5
    alone = world4[0]["alone"]
    assert float((alone - single[:2]).abs().max()) > 100 * 1e-5
    # Rank 2's own pairs trip it and so track as in the whole batch.
    assert float((world4[2]["alone"] - single[4:6]).abs().max()) <= 1e-5


def test_retrack_is_decided_over_every_rank(world4, inputs):
    prev, curr = inputs["retrack"]
    single = batched_track_pair(prev, curr, inputs["k"], RETRACK_CONFIG)
    base = batched_track_pair(prev, curr, inputs["k"], TRACK_CONFIGS["fast"])
    bad = base.diagnostics.scale[-1] > RETRACK_SCALE
    assert bad.nonzero().flatten().tolist() == [BAD]
    for res in world4:
        got = res["retrack"]
        assert float((got["transform"] - single.transform).abs().max()) <= 1e-5
        assert torch.equal(got["success"], single.success)
    # The retrack moved the bad pair.
    assert float((single.transform[BAD] - base.transform[BAD]).abs().max()) > 1e-5


@pytest.mark.parametrize("name", list(JAX_GRAPHS))
def test_pose_graph_matches_jax_sharded(world4, inputs, name):
    import jax
    import jax.numpy as jnp

    from dense_visual_odometry_tpu.models.posegraph import PoseGraphEdges as JEdges
    from dense_visual_odometry_tpu.parallel.batched import make_mesh as jax_mesh
    from dense_visual_odometry_tpu.parallel.distributed import (
        optimize_pose_graph_sharded as jax_sharded,
    )

    if jax.device_count() < 8:
        pytest.skip("needs 8 simulated devices")
    poses, e = inputs["jax_graphs"][name]
    want = jax_sharded(jax_mesh(), jnp.asarray(poses), JEdges(*(jnp.asarray(x) for x in e)),
                       max_iterations=JAX_GRAPH_ITERS)
    for res in world4:
        np.testing.assert_allclose(res["jax_graphs"][name].numpy(), np.asarray(want.poses),
                                   atol=1e-4)


def test_dense_ba_matches_jax_sharded(world4):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from dense_visual_odometry_tpu.models import dense_ba as jba
    from tests.unit.test_dense_ba import K_MAT

    if jax.device_count() < 8:
        pytest.skip("needs 8 simulated devices")
    grays, depths, noisy = _planar_ba()
    data = jba.build_dense_ba_data(grays, depths, K_MAT, grid_stride=6)
    want = jba.optimize_dense_ba_sharded(
        Mesh(np.asarray(jax.devices()[:8]), ("data",)), jnp.asarray(noisy), data,
        jba.DenseBAConfig(max_iterations=BA_CFG.max_iterations))
    got = world4[1]["dryrun"]["dense_ba_planar"]
    np.testing.assert_allclose(got["poses"].numpy(), np.asarray(want.poses), atol=2e-5)
    np.testing.assert_allclose(got["inv_depth"].numpy(), np.asarray(want.inv_depth), atol=1e-4)
    np.testing.assert_allclose(float(got["chi2"]), float(want.chi2), rtol=1e-3)


def test_pad_edges_matches_jax(inputs):
    import jax.numpy as jnp

    from dense_visual_odometry_tpu.models.posegraph import PoseGraphEdges as JEdges
    from dense_visual_odometry_tpu.parallel.distributed import pad_edges as jax_pad

    for _, e in inputs["jax_graphs"].values():
        for multiple in (1, 4, 8):
            want = jax_pad(JEdges(*(jnp.asarray(x) for x in e)), multiple)
            got = pad_edges(_torch_edges(e), multiple)
            assert got.i.shape[0] % multiple == 0
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_reduced_system_sums_over_ranks(world4, inputs):
    """The owners' shares of (chi2, A', b'), summed by the all_reduce, are
    the single-device system within float32 sums in another order."""
    poses, data = inputs["ba"]["planar"]
    want = build_reduced_system(poses, data.inv_depth0, data, BA_CFG)[:3]
    for res in world4:
        for got, w in zip(res["reduced"], want):
            assert float((got - w).abs().max()) <= 1e-5 * float(w.abs().max())
    for i in range(3):
        for res in world4:
            assert torch.equal(res["reduced"][i], world4[0]["reduced"][i])


def test_shard_batch_splits_the_pairs(world4):
    for rank, res in enumerate(world4):
        assert [s[0] for s in res["shard_batch"]] == [2] * 4, rank
        assert res["shard_equal"], rank


def test_keyframes_must_divide_the_ranks(world4):
    for res in world4:
        assert res["indivisible"] is not None and "divide" in res["indivisible"]


def test_entry_points_resolve_to_the_gpu(world1):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_distributed()
    with pytest.raises(RuntimeError, match="CUDA"):
        robust.make_tracker(TRACK_CONFIGS["fast"])
    assert default_backend("cuda") == "nccl" and default_backend("cpu") == "gloo"
    # Already initialised: the group's (rank, world size).
    assert init_distributed(device="cpu") == (0, 1)


def test_make_mesh_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh("cpu")
