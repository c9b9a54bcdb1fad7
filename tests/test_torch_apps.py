"""The port's command-line tools against the JAX package's, on the CPU.

A 120x160 TUM directory written by the port's ``make_dataset``
(``handheld-fr1``, 5 frames, the seeded synthetic source frame) is tracked
by both packages' ``apps.benchmark.run`` with ``--platform cpu`` under
``tpu_fast`` at grid strides (4, 2, 1, 1): poses within 1e-5, ATE and RPE
within 1e-6, the same summary and report keys (timings and ``backend``
differ by nature; the port's summary adds ``read_s``, the time it waited
for frames) and the same trajectory file to its printed precision.
The depth maps get a 16-pixel band of invalid depth, as the port's tracking
tests give theirs (``test_torch_track.py``): XLA:CPU fuses multiply-adds
and PyTorch does not, and where a border pixel projects onto the bounds
test's edge the last bit decides its validity (measured here without the
band: the sessions part by 4e-4 from the fifth frame at strides (2, 2, 1, 1)
too, with the band by at most 1.1e-6).

Then ``apps.evaluate`` prints the JAX package's JSON on the same files
(counts equal, errors within 1e-9: both read each pose's quaternion into a
float32 matrix, and XLA:CPU's fused multiply-adds round some entries one
float32 step apart from PyTorch's);
``-m sparse`` (``--sparse-matcher zncc`` and ``learned``) matches the JAX
package's CLI, the port's session replaying the JAX session's RANSAC samples
(``test_torch_sparse.replay_session``); ``-m slam`` runs under
``tpu_slam`` (plain, ``--slam-two-step``, with ``--slam-refine-caps`` and
with ``--dense-refine``) and reports the SLAM session's optimized
trajectory and its keyframes, and plain and with ``--dense-refine`` it
matches the JAX package's ``-m slam`` under ``test_torch_slam.CFG``; without
a GPU
the default platform raises; ``--pipeline``, ``--host-gray``,
``--pyr-down``, ``-s`` and ``--profile-dir`` run; ``make_batched_tracker``
and ``pad_batch_to_devices`` agree with the JAX package's.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.apps import benchmark as tbench
from dense_visual_odometry_torch.apps import evaluate as tevaluate
from dense_visual_odometry_torch.apps import make_dataset as tmake
from dense_visual_odometry_torch.config import RobustDVOConfig as TConfig
from dense_visual_odometry_torch.io import png as tpng
from dense_visual_odometry_torch.io import synthetic as tsyn
from dense_visual_odometry_torch.models import robust as trobust
from dense_visual_odometry_torch.parallel import batched as tbatched
from dense_visual_odometry_tpu.apps import benchmark as jbench
from dense_visual_odometry_tpu.apps import evaluate as jevaluate
from dense_visual_odometry_tpu.camera import CameraModel as JCamera
from dense_visual_odometry_tpu.config import RobustDVOConfig as JConfig
from dense_visual_odometry_tpu.models import robust as jrobust
from dense_visual_odometry_tpu.parallel import batched as jbatched

ROOT = Path(__file__).resolve().parents[1]
H, W, N_FRAMES, BAND = 120, 160, 5, 16


def args(**kw):
    base = dict(benchmark="tum", data_dir=None, config=None, output_dir=None, camera=None,
                size=None, method="robust-dvo", platform="cpu", profile_dir=None,
                pipeline=False, host_gray=False, pyr_down=False, verbose=False)
    return SimpleNamespace(**{**base, **kw})


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """-> (TUM directory, camera YAML, configuration JSON at (4, 2, 1, 1))."""
    root = tmp_path_factory.mktemp("tum")
    source = tsyn.textured_scene(H, W, seed=0)
    tmake.write_tum_dataset(root / "seq", n_frames=N_FRAMES, motion="handheld-fr1",
                            source=source)
    for path in (root / "seq" / "depth").iterdir():
        d = tpng.read_depth(path)
        d[:BAND], d[-BAND:], d[:, :BAND], d[:, -BAND:] = 0, 0, 0, 0
        tpng.write(path, d)
    cam = root / "cam.yaml"
    cam.write_text(f"intrinsics: {np.asarray(source[2], float).tolist()}\n"
                   f"depth_scale: {1 / tmake.TUM_DN_PER_M}\n")
    cfg = root / "fast_stride4.json"
    cfg.write_text(json.dumps({**json.loads((ROOT / "configs" / "tpu_fast.json").read_text()),
                               "grid_strides": [4, 2, 1, 1]}))
    return root / "seq", cam, cfg


@pytest.fixture(scope="module")
def runs(dataset, tmp_path_factory):
    seq, cam, cfg = dataset
    out = tmp_path_factory.mktemp("runs")
    kw = dict(data_dir=str(seq), camera=str(cam), config=str(cfg))
    t = tbench.run(args(**kw, output_dir=str(out / "port")))
    j = jbench.run(args(**kw, output_dir=str(out / "jax")))
    return t, j, out / "port", out / "jax"


def test_benchmark_matches_jax(runs):
    t, j, t_dir, j_dir = runs
    assert t.keys() == j.keys() | {"read_s"}  # the port also reports its read time
    assert 0 < t["read_s"] < t["total_time_s"]
    assert t["backend"] == "cpu" and t["frames"] == N_FRAMES
    for key in ("ate_rmse_m", "rpe_trans_rmse_m", "rpe_rot_rmse_rad", "mean_trans_err_m",
                "mean_rot_err_rad"):
        assert abs(t[key] - j[key]) <= 1e-6, key
    assert t["ate_rmse_m"] < 0.01
    t_rep = json.loads((t_dir / "report.json").read_text())
    j_rep = json.loads((j_dir / "report.json").read_text())
    assert t_rep.keys() == j_rep.keys()
    assert t_rep["summary"].keys() == j_rep["summary"].keys() | {"read_s"}
    assert t_rep["sequence"] == j_rep["sequence"]
    assert t_rep["timestamps"] == j_rep["timestamps"]
    assert t_rep["ground_truth_poses"] == j_rep["ground_truth_poses"]
    for key in ("estimated_poses", "transformations"):
        np.testing.assert_allclose(t_rep[key], j_rep[key], atol=1e-5)
    t_traj = np.loadtxt(t_dir / "trajectory.txt")
    j_traj = np.loadtxt(j_dir / "trajectory.txt")
    np.testing.assert_array_equal(t_traj[:, 0], j_traj[:, 0])
    # 1e-5, and the file's rounding to 6 decimals.
    np.testing.assert_allclose(t_traj[:, 1:], j_traj[:, 1:], atol=1.1e-5)


def test_evaluate_matches_jax(runs, dataset, capsys):
    _, _, t_dir, _ = runs
    gt = dataset[0] / "groundtruth.txt"
    outputs = []
    for main in (tevaluate.main, jevaluate.main):
        assert main([str(t_dir / "trajectory.txt"), str(gt), "--max-time-diff", "0.01"]) == 0
        outputs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    t, j = outputs
    assert t.keys() == j.keys()
    for key, value in j.items():
        if isinstance(value, float):
            assert abs(t[key] - value) <= 1e-9, key
        else:
            assert t[key] == value, key
    assert t["pairs"] >= N_FRAMES - 1


@pytest.fixture(scope="module")
def sparse_runs(dataset, tmp_path_factory):
    """``-m sparse`` with each matcher through both packages' CLI ->
    {matcher: {side: (summary, directory)}}; the port's ``SparseVO`` draws
    the JAX session's samples."""
    from dense_visual_odometry_torch.models import sparse as tsparse
    from tests.test_torch_sparse import replay_session

    seq, cam, _ = dataset
    out = tmp_path_factory.mktemp("sparse")
    runs = {}
    for matcher in ("zncc", "learned"):
        kw = dict(data_dir=str(seq), camera=str(cam), method="sparse", sparse_matcher=matcher)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tsparse, "SparseVO", lambda camera, matcher, device: replay_session(
                camera, matcher, 0, device=device))
            runs[matcher] = {"port": (tbench.run(args(**kw, output_dir=str(out / f"t_{matcher}"))),
                                      out / f"t_{matcher}")}
        runs[matcher]["jax"] = (jbench.run(args(**kw, output_dir=str(out / f"j_{matcher}"))),
                                out / f"j_{matcher}")
    return runs


@pytest.mark.parametrize("matcher", ["zncc", "learned"])
def test_sparse_cli_matches_jax(sparse_runs, matcher):
    """The port's ``-m sparse`` against the JAX package's on the CPU: poses
    within 1e-5, ATE and RPE within 1e-6, the same summary and report keys
    (the port's summary adds ``read_s``), the trajectory file to its printed
    precision."""
    (t, t_dir), (j, j_dir) = (sparse_runs[matcher][side] for side in ("port", "jax"))
    assert t.keys() == j.keys() | {"read_s"}
    assert t["method"] == "sparse" and t["backend"] == "cpu" and t["frames"] == N_FRAMES
    for key in ("ate_rmse_m", "rpe_trans_rmse_m", "rpe_rot_rmse_rad", "mean_trans_err_m",
                "mean_rot_err_rad"):
        assert abs(t[key] - j[key]) <= 1e-6, key
    assert t["ate_rmse_m"] < 0.02
    t_rep = json.loads((t_dir / "report.json").read_text())
    j_rep = json.loads((j_dir / "report.json").read_text())
    assert t_rep.keys() == j_rep.keys()
    assert t_rep["summary"].keys() == j_rep["summary"].keys() | {"read_s"}
    for key in ("estimated_poses", "transformations"):
        np.testing.assert_allclose(t_rep[key], j_rep[key], atol=1e-5)
    t_traj = np.loadtxt(t_dir / "trajectory.txt")
    j_traj = np.loadtxt(j_dir / "trajectory.txt")
    np.testing.assert_array_equal(t_traj[:, 0], j_traj[:, 0])
    np.testing.assert_allclose(t_traj[:, 1:], j_traj[:, 1:], atol=1.1e-5)


SLAM_FLAGS = {"slam": {}, "slam_two_step": {"slam_two_step": True},
              "slam_caps": {"slam_two_step": True, "slam_refine_caps": "4,3,2,2"},
              "slam_dense_refine": {"dense_refine": True}}
# The CLI takes the default policy (0.15 m), which promotes no frame of the 5
# here; the tests lower its translation threshold so that the runs promote
# and the dense refinement has two keyframes.
SLAM_TRANSLATION = 0.02


def _lowered_policy(monkeypatch, slam_module=None, translation=SLAM_TRANSLATION):
    """Lower the translation threshold of the policy that ``slam_module``'s
    ``SlamSession`` and ``apps.benchmark`` build (default: the port's)."""
    import dataclasses

    from dense_visual_odometry_torch.models import slam as tslam

    module = slam_module or tslam
    base = module.KeyframePolicy
    monkeypatch.setattr(module, "KeyframePolicy", lambda **kw: dataclasses.replace(
        base(**kw), max_translation=translation))


@pytest.fixture(scope="module")
def slam_runs(dataset, tmp_path_factory):
    """``-m slam`` under ``configs/tpu_slam.json`` on the directory, plain,
    two-step, two-step with caps and with ``--dense-refine``."""
    seq, cam, _ = dataset
    out = tmp_path_factory.mktemp("slam_runs")
    kw = dict(data_dir=str(seq), camera=str(cam), method="slam",
              config=str(ROOT / "configs" / "tpu_slam.json"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small CPU ops: see test_torch_slam.one_torch_thread
    try:
        with pytest.MonkeyPatch.context() as mp:
            _lowered_policy(mp)
            return {name: (tbench.run(args(**kw, **flags, output_dir=str(out / name))),
                           out / name)
                    for name, flags in SLAM_FLAGS.items()}
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name", sorted(SLAM_FLAGS))
def test_slam_method_runs(slam_runs, name):
    """Each run writes its report and trajectory, reports its keyframes,
    and tracks the directory within 2 mm (ATE)."""
    summary, out_dir = slam_runs[name]
    assert sorted(p.name for p in out_dir.iterdir()) == ["report.json", "trajectory.txt"]
    assert summary["method"] == "slam" and summary["frames"] == N_FRAMES
    assert summary["keyframes"] >= 2 and summary["backend"] == "cpu"
    assert summary["ate_rmse_m"] < 2e-3
    report = json.loads((out_dir / "report.json").read_text())
    assert report["summary"]["keyframes"] == summary["keyframes"]
    assert summary.get("dense_refined", False) == (name == "slam_dense_refine")
    traj = np.loadtxt(out_dir / "trajectory.txt")
    assert traj.shape == (N_FRAMES, 8) and np.isfinite(traj).all()


def test_slam_reports_the_optimized_trajectory(slam_runs, dataset):
    """The trajectory of ``-m slam`` is the SLAM session's
    ``optimized_trajectory`` (the JAX package's report), and
    ``--slam-refine-caps`` reaches the policy."""
    from dense_visual_odometry_torch.io.datasets import load_tum_sequence
    from dense_visual_odometry_torch.models.slam import KeyframePolicy, SlamSession

    seq_dir, cam, _ = dataset
    seq = load_tum_sequence(str(seq_dir), camera_yaml=str(cam))
    sess = SlamSession(seq.camera, TConfig.from_json(ROOT / "configs" / "tpu_slam.json"),
                       KeyframePolicy(max_translation=SLAM_TRANSLATION), device="cpu")
    for rgb, depth in seq:
        sess.step(rgb, depth)
    traj = np.loadtxt(slam_runs["slam"][1] / "trajectory.txt")
    np.testing.assert_allclose(traj[:, 1:4], sess.optimized_trajectory()[:, :3, 3], atol=1e-6)
    caps, plain = (np.loadtxt(slam_runs[n][1] / "trajectory.txt") for n in
                   ("slam_caps", "slam_two_step"))
    assert np.abs(caps[:, 1:4] - plain[:, 1:4]).max() > 0


SLAM_PARITY = ("slam", "slam_dense_refine")
# The parity runs' threshold: keyframes at frames 0 and 3, so that frame 4
# hangs off the second keyframe and the dense refinement, which holds the
# first keyframe, moves it (at SLAM_TRANSLATION every frame hangs off
# keyframe 0 and the refinement leaves the trajectory as it was).
PARITY_TRANSLATION = 0.015


@pytest.fixture(scope="module")
def slam_parity_runs(dataset, tmp_path_factory):
    """``-m slam``, plain and with ``--dense-refine``, through both packages'
    CLI under ``test_torch_slam.CFG`` (no level kernel: ``tpu_slam``'s
    Pallas kernels would run in interpret mode in the JAX package, a minute
    a compile here) with the lowered policy -> {name: {side: (summary,
    directory)}}."""
    from dense_visual_odometry_torch.models import slam as tslam
    from dense_visual_odometry_tpu.models import slam as jslam
    from tests.test_torch_slam import CFG

    seq, cam, _ = dataset
    out = tmp_path_factory.mktemp("slam_parity")
    cfg = out / "slam_cpu.json"
    cfg.write_text(json.dumps(CFG))
    kw = dict(data_dir=str(seq), camera=str(cam), method="slam", config=str(cfg))
    runs = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small CPU ops: see test_torch_slam.one_torch_thread
    try:
        for name in SLAM_PARITY:
            runs[name] = {}
            for side, bench, module in (("port", tbench, tslam), ("jax", jbench, jslam)):
                with pytest.MonkeyPatch.context() as mp:
                    _lowered_policy(mp, module, PARITY_TRANSLATION)
                    d = out / f"{side}_{name}"
                    runs[name][side] = (bench.run(args(**kw, **SLAM_FLAGS[name],
                                                       output_dir=str(d))), d)
    finally:
        torch.set_num_threads(threads)
    return runs


@pytest.mark.parametrize("name", SLAM_PARITY)
def test_slam_cli_matches_jax(slam_parity_runs, name):
    """The port's ``-m slam`` against the JAX package's on the CPU: the same
    keyframes, the report's poses (the optimized trajectory, after the dense
    refinement where asked) within ``test_torch_slam.BA_ATOL`` (5e-5: the
    poses that the pose graph moves, it says why), the errors within that
    of the truth, and the trajectory file to its printed precision."""
    from tests.test_torch_slam import BA_ATOL

    (t, t_dir), (j, j_dir) = (slam_parity_runs[name][side] for side in ("port", "jax"))
    assert t.keys() == j.keys() | {"read_s"}
    assert t["keyframes"] == j["keyframes"] >= 2
    assert t.get("dense_refined") == j.get("dense_refined")
    for key in ("ate_rmse_m", "rpe_trans_rmse_m", "mean_trans_err_m"):
        assert abs(t[key] - j[key]) <= BA_ATOL, key
    t_rep = json.loads((t_dir / "report.json").read_text())
    j_rep = json.loads((j_dir / "report.json").read_text())
    assert t_rep.keys() == j_rep.keys()
    for key in ("estimated_poses", "transformations"):
        np.testing.assert_allclose(t_rep[key], j_rep[key], atol=BA_ATOL)
    t_traj = np.loadtxt(t_dir / "trajectory.txt")
    j_traj = np.loadtxt(j_dir / "trajectory.txt")
    np.testing.assert_array_equal(t_traj[:, 0], j_traj[:, 0])
    np.testing.assert_allclose(t_traj[:, 1:], j_traj[:, 1:], atol=BA_ATOL + 1e-6)


def test_slam_cli_dense_refine_moves_the_poses(slam_parity_runs):
    """In both packages ``--dense-refine`` changes the reported trajectory
    (the comparison above holds a refinement that ran)."""
    for side in ("port", "jax"):
        plain, refined = (np.loadtxt(slam_parity_runs[n][side][1] / "trajectory.txt")
                          for n in SLAM_PARITY)
        assert np.abs(plain[:, 1:4] - refined[:, 1:4]).max() > 1e-5, side


def test_default_platform_is_the_gpu(dataset):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.main(["tum", "-d", str(dataset[0]), "--camera", str(dataset[1])])


def test_cli_options_run(dataset, runs, tmp_path):
    """``--pipeline`` reads the same poses a frame later; ``--host-gray``,
    ``--pyr-down`` (half resolution, intrinsics of level 1), ``-s`` and
    ``--profile-dir`` run and track; the trace holds the program's spans."""
    seq, cam, cfg = dataset
    kw = dict(data_dir=str(seq), camera=str(cam), config=str(cfg))
    base = runs[0]
    piped = tbench.run(args(**kw, pipeline=True, output_dir=str(tmp_path / "p")))
    assert piped["ate_rmse_m"] == base["ate_rmse_m"]
    gray = tbench.main(["tum", "-d", str(seq), "--camera", str(cam), "-c", str(cfg),
                        "--platform", "cpu", "--host-gray", "-s", "3",
                        "--profile-dir", str(tmp_path / "prof")])
    assert gray["frames"] == 3 and gray["ate_rmse_m"] < 0.01
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert {"session.step", "track.level", "sync.trigger"} <= {e.get("name") for e in events}
    half = tbench.run(args(**kw, pyr_down=True, size=3))
    assert half["frames"] == 3 and np.isfinite(half["ate_rmse_m"])


def test_batched_helpers_match_jax():
    """``make_batched_tracker`` tracks as the JAX package's (a two-level
    ``tpu_fast`` at 48x64, B=2) and ``pad_batch_to_devices`` pads alike."""
    assert tbatched.pad_batch_to_devices([1, 2, 3], 4) == jbatched.pad_batch_to_devices(
        [1, 2, 3], 4) == ([1, 2, 3, 3], 3)
    with pytest.raises(ValueError, match="empty batch"):
        tbatched.pad_batch_to_devices([], 2)
    data = {**json.loads((ROOT / "configs" / "tpu_fast.json").read_text()), "levels": 2,
            "grid_strides": [3, 1], "shift_stack_levels": [0, 1],
            "max_iterations_per_level": [12, 12]}
    gray, depth, k = tsyn.textured_scene(48, 64, seed=2)
    poses = tsyn.handheld_trajectory(3, seed=2)
    grays, depths = tsyn.render_sequence(gray, depth, k, poses)
    for d in depths:
        d[:4], d[-4:], d[:, :4], d[:, -4:] = 0, 0, 0, 0
    jcam = JCamera.create(k, 1.0)
    prep = jax.jit(lambda g, d: jrobust.preprocess_frame(g, d, jcam, levels=2))
    frames = [jax.tree.map(np.asarray, prep(g, d)) for g, d in zip(grays, depths)]
    stack = lambda fs: jax.tree.map(lambda *x: np.stack(x), *fs)  # noqa: E731
    prev, curr = stack([frames[0], frames[1]]), stack([frames[1], frames[2]])
    j_res = jax.jit(jbatched.make_batched_tracker(JConfig.from_dict(data)))(
        jax.tree.map(jnp.asarray, prev), jax.tree.map(jnp.asarray, curr), jnp.asarray(k))
    t_res = tbatched.make_batched_tracker(TConfig.from_dict(data))(
        trobust.frame_data_from_numpy(prev, "cpu"), trobust.frame_data_from_numpy(curr, "cpu"),
        torch.tensor(k))
    np.testing.assert_allclose(t_res.transform.numpy(), np.asarray(j_res.transform), atol=1e-5)
    np.testing.assert_array_equal(t_res.diagnostics.iterations.numpy(),
                                  np.asarray(j_res.diagnostics.iterations))
