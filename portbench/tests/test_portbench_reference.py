"""The plain reference against the port's CPU path, at the benchmark's
640x480 on a few frame pairs."""

import ast

import numpy as np
import pytest
import torch

from portbench.harness.cell import BENCH_DIR
from portbench.reference import dvo
from portbench.scene import render, synthetic


@pytest.fixture(scope="module")
def pool():
    g, d, k = synthetic.textured_scene(480, 640, seed=1)
    poses = synthetic.handheld_trajectory(96, seed=2, t_step=0.008, r_step=0.005,
                                          rpy_span=None, fast_span=None)
    sel = [10, 11, 40, 41, 70, 71, 88, 89]
    chroma = 20 * synthetic._smooth_noise(np.random.default_rng(2), 480, 640, 30)
    frames = render.make_pool(g, d, k, poses[sel], 77, 5000.0, chroma, "cpu")
    truth = torch.tensor(np.stack([np.linalg.inv(poses[sel[j]]) @ poses[sel[i]]
                                   for i, j in ((0, 1), (2, 3), (4, 5), (6, 7))]))
    return frames, k, truth


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH_DIR / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
        assert {m.split(".")[0] for m in names} <= {"__future__", "typing", "torch", "numpy"}, path


def test_pyramids_match_the_port(pool):
    from dense_visual_odometry_torch.camera import CameraModel
    from dense_visual_odometry_torch.models.robust import preprocess_frame

    frames, k, _ = pool
    cam = CameraModel.create(k, 1 / 5000.0)
    port = preprocess_frame(frames["rgb"], frames["depth"].view(torch.uint16), cam, levels=4,
                            device="cpu")
    gray = dvo.pyramid(dvo.luma(frames["rgb"]), 4)
    depth = dvo.pyramid(dvo.metres(frames["depth"], 5000.0, 5.0), 4)
    for a, b in zip(port.gray, gray):
        assert float((a.double() - b).abs().max()) < 1e-4
    for a, b in zip(port.depth_m, depth):
        assert float((a.double() - b).abs().max()) < 1e-6


def test_refine_lands_where_the_parity_tier_does(pool):
    """At tolerance 1e-6 the port's solve stops at the optimum that the
    reference, with the template's Jacobian as the tier states, finds."""
    from dense_visual_odometry_torch.camera import CameraModel
    from dense_visual_odometry_torch.config import RobustDVOConfig
    from dense_visual_odometry_torch.models.robust import preprocess_frame
    from dense_visual_odometry_torch.parallel.batched import batched_track_pair

    frames, k, truth = pool
    cfg = RobustDVOConfig.from_json(BENCH_DIR.parent / "configs" / "tpu_parity.json")
    cam = CameraModel.create(k, 1 / 5000.0)
    a, b = [0, 2, 4, 6], [1, 3, 5, 7]
    fa = preprocess_frame(frames["rgb"][a], frames["depth"][a].view(torch.uint16), cam,
                          levels=4, device="cpu")
    fb = preprocess_frame(frames["rgb"][b], frames["depth"][b].view(torch.uint16), cam,
                          levels=4, device="cpu")
    res = batched_track_pair(fa, fb, torch.tensor(k), cfg)
    assert bool(res.success.all())
    gray = dvo.luma(frames["rgb"])
    depth = dvo.metres(frames["depth"], 5000.0, 5.0)
    ref = dvo.refine(gray[a], depth[a], gray[b], torch.tensor(k, dtype=torch.float64), truth, 2,
                     True, template_jacobian=True)
    tr, rot = dvo.motion_gap(ref, res.transform.double())
    assert float(tr.max()) < 0.05 and float(rot.max()) < 0.005
    # The optimum is not the truth: the sensor's noise moves it.
    tr_truth, _ = dvo.motion_gap(truth, ref)
    assert float(tr_truth.max()) > 0.05


def test_motion_gap_reads_small_rotations():
    xi = torch.tensor([[0.0, 0.0, 0.0, 1e-5, 0.0, 0.0]], dtype=torch.float64)
    eye = torch.eye(4, dtype=torch.float64)[None]
    tr, rot = dvo.motion_gap(eye, dvo.se3_exp(xi).float().double())
    assert float(rot[0]) == pytest.approx(np.degrees(1e-5), rel=1e-2)
    assert float(tr[0]) == 0.0
