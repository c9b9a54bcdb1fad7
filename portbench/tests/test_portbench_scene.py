"""The frozen scene copy, the on-card renderer and the traffic mixes."""

import json

import numpy as np
import pytest
import torch

from portbench.harness import drive
from portbench.harness.cell import BENCH_DIR, load_cell
from portbench.scene import render, synthetic

# Mean and largest motion a frame of each mix's 96-frame pool, as the
# set-up prints them.
REALISED = {
    "xyz.b256": {"mean_mm": 6.952905344332783, "mean_deg": 0.3217899939339082},
    "desk.b64": {"mean_mm": 10.297883359809184, "mean_deg": 0.6010060498724304},
}


def test_scene_is_determined_by_its_seed():
    a = synthetic.textured_scene(48, 64, seed=3)
    b = synthetic.textured_scene(48, 64, seed=3)
    c = synthetic.textured_scene(48, 64, seed=4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    t = synthetic.handheld_trajectory(20, seed=5)
    np.testing.assert_array_equal(t, synthetic.handheld_trajectory(20, seed=5))
    assert not np.array_equal(t, synthetic.handheld_trajectory(20, seed=6))


@pytest.mark.parametrize("kw", [{}, {"t_step": 0.008, "r_step": 0.005}])
def test_frozen_copy_matches_the_port_at_its_defaults(kw):
    from dense_visual_odometry_torch.io import synthetic as port

    np.testing.assert_array_equal(synthetic.handheld_trajectory(40, seed=2, **kw),
                                  port.handheld_trajectory(40, seed=2, **kw))
    for x, y in zip(synthetic.textured_scene(48, 64, seed=1), port.textured_scene(48, 64, seed=1)):
        np.testing.assert_array_equal(x, y)


def test_spans_can_be_left_out():
    with_spans = synthetic.handheld_trajectory(40, seed=2)
    without = synthetic.handheld_trajectory(40, seed=2, rpy_span=None, fast_span=None)
    assert not np.array_equal(with_spans, without)


@pytest.mark.parametrize("mix", sorted(REALISED))
def test_mix_realised_motion(mix):
    traffic = json.loads((BENCH_DIR / "traffic" / f"{mix}.json").read_text())
    cell = load_cell("fast.b256.xyz")
    cell.traffic = traffic
    poses = cell.motion()(traffic["pool_frames"], traffic["trajectory_seed"], **traffic["motion"])
    stats = drive.motion_stats(poses)
    for key, value in REALISED[mix].items():
        assert stats[key] == pytest.approx(value, rel=1e-9)


@pytest.mark.parametrize("frame", [1, 3, 5])
def test_torch_renderer_matches_numpy(frame):
    gray, depth, k = synthetic.textured_scene(120, 160, seed=1)
    pose = synthetic.handheld_trajectory(6, seed=2)[frame]
    want = synthetic.render_view(gray, depth, k, np.linalg.inv(pose))
    got = render.render_view(torch.tensor(gray), torch.tensor(depth), k, np.linalg.inv(pose))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4)


def test_pool_is_determined_by_the_seed():
    gray, depth, k = synthetic.textured_scene(60, 80, seed=1)
    poses = synthetic.handheld_trajectory(3, seed=2)
    chroma = np.zeros((60, 80), np.float32)
    a = render.make_pool(gray, depth, k, poses, 9, 5000.0, chroma, "cpu")
    b = render.make_pool(gray, depth, k, poses, 9, 5000.0, chroma, "cpu")
    c = render.make_pool(gray, depth, k, poses, 10, 5000.0, chroma, "cpu")
    assert torch.equal(a["rgb"], b["rgb"]) and torch.equal(a["depth"], b["depth"])
    assert not torch.equal(a["rgb"], c["rgb"])
    assert a["rgb"].dtype == torch.uint8 and a["depth"].view(torch.uint16).dtype == torch.uint16


def test_chroma_cancels_in_the_luma():
    gray = torch.full((4, 4), 100.0)
    chroma = torch.linspace(-20, 20, 16).reshape(4, 4)
    rgb = render.chroma_rgb(gray, chroma).double()
    luma = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    assert float((luma - 100.0).abs().max()) < 0.5
    assert float((rgb[..., 0] - rgb[..., 2]).abs().max()) > 10
