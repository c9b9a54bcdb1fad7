"""The port's ``apps/visualize.py`` against the JAX package's, on the CPU,
on a report over a bundled-format directory of four 96x128 frames of the
seeded synthetic scene (``chip_smoke.bundled_dataset``).

- ``build_cloud``: the same points within :data:`CLOUD_ATOL` (1e-6 m) and the
  same colours, subsampled or not (the JAX package deprojects with XLA's
  float32 inverse of K, the port with LAPACK's).
- ``write_ply``: the same bytes on the same cloud.
- ``main``: the figure, the PLY and the animated GIF are written, in both
  modes; a TUM report's frames are read with the camera YAML it records.
- Without matplotlib the figure raises a clear error.
"""

import json
import sys

import numpy as np
import pytest

from chip_smoke import bundled_dataset
from dense_visual_odometry_torch.apps import visualize as tv
from dense_visual_odometry_torch.io import load_bundled_sequence as t_bundled
from dense_visual_odometry_tpu.apps import visualize as jv
from dense_visual_odometry_tpu.io import load_bundled_sequence as j_bundled

CLOUD_ATOL = 1e-6


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    """A report over the bundled-format directory: the true poses moved by a
    few millimetres as the estimate."""
    root = tmp_path_factory.mktemp("vis")
    data = bundled_dataset(root / "bundled", 96, 128, 4)
    gt = [np.asarray(v["transformation"]) for _, v in sorted(
        json.loads((data / "ground_truth.json").read_text()).items(), key=lambda kv: int(kv[0]))]
    est = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), np.stack(gt))
    est[:, :3, 3] += np.linspace(0.0, 0.004, len(est))[:, None]
    path = root / "report.json"
    path.write_text(json.dumps({
        "sequence": {"type": "test", "data_dir": str(data)},
        "timestamps": list(range(len(est))),
        "estimated_poses": est.tolist(),
        "ground_truth_poses": np.stack(gt).tolist(),
    }))
    return path, est, data


@pytest.mark.parametrize("stride, max_points", [(1, 10**6), (2, 5000)])
def test_build_cloud_matches_jax(report, stride, max_points):
    _, est, data = report
    pts, cols = tv.build_cloud(est, t_bundled(data), stride, max_points, "cpu")
    want_pts, want_cols = jv.build_cloud(est, j_bundled(data), stride, max_points)
    assert pts.shape == want_pts.shape and len(pts) > 1000
    np.testing.assert_allclose(pts, want_pts, rtol=0, atol=CLOUD_ATOL)
    np.testing.assert_array_equal(cols, want_cols)
    assert cols.dtype == want_cols.dtype == np.uint8


def test_ply_bytes_equal_jax(report, tmp_path):
    _, est, data = report
    pts, cols = tv.build_cloud(est, t_bundled(data), 2, 3000, "cpu")
    tv.write_ply(tmp_path / "t.ply", pts, cols)
    jv.write_ply(tmp_path / "j.ply", pts, cols)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    assert "element vertex 3000" in (tmp_path / "t.ply").read_text()


def test_main_writes_figure_cloud_and_replay(report, tmp_path):
    path, est, _ = report
    png, ply, gif = tmp_path / "t.png", tmp_path / "c.ply", tmp_path / "r.gif"
    out = tv.main(["report", str(path), "-o", str(png), "--ply", str(ply), "--stride", "2",
                   "--max-points", "4000", "--animate", str(gif), "--animate-stride", "2",
                   "--max-points", "4000", "--platform", "cpu"])
    assert out == png and png.stat().st_size > 1000
    assert ply.read_text().startswith("ply") and "element vertex 4000" in ply.read_text()
    assert gif.read_bytes()[:6] in (b"GIF87a", b"GIF89a") and gif.stat().st_size > 5000
    traj = tmp_path / "traj.txt"
    traj.write_text("".join(f"{i} {p[0, 3]} {p[1, 3]} {p[2, 3]} 0 0 0 1\n"
                            for i, p in enumerate(est)))
    assert tv.main(["trajectory", str(traj), "-o", str(tmp_path / "u.png")]).exists()


def test_tum_report_reads_its_camera(tmp_path):
    """The frames of a TUM report come with the camera YAML the report
    records (the JAX package reads the bundled set's YAML there)."""
    from dense_visual_odometry_torch.apps import make_dataset
    from dense_visual_odometry_torch.io import synthetic

    gray, depth, k = synthetic.textured_scene(48, 64, seed=1)
    seq_dir = make_dataset.write_tum_dataset(tmp_path / "seq", n_frames=2,
                                             source=(gray, depth, k))
    cam = tmp_path / "cam.yaml"
    cam.write_text(f"intrinsics: {np.asarray(k, float).tolist()}\ndepth_scale: 0.0002\n")
    seq = tv.load_sequence("TUM", {"type": "TUM", "data_dir": str(seq_dir),
                                   "camera_intrinsics": str(cam)})
    assert len(seq) == 2
    np.testing.assert_allclose(seq.camera.intrinsics.numpy(), k, rtol=1e-6)


def test_figure_without_matplotlib(report, tmp_path, monkeypatch):
    path, _, _ = report
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        tv.main(["report", str(path), "-o", str(tmp_path / "t.png")])
