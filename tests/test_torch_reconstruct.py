"""The port's reconstruction CLI (``apps/reconstruct.py``) against the JAX
package's, on the CPU.

A 120x160 TUM directory written by the port's ``make_dataset``
(``handheld-fr1``, 6 frames; the source's depth with the texture of the
60x80 scene upsampled, as ``test_torch_frame_to_model.py`` tracks, and a
16-pixel band of invalid depth, as ``test_torch_apps.py`` gives its own).
Its red channel is raised by one level and its blue lowered by one, so that
the luma is g + 0.185 and not an integer: of the 256 gray PNG levels r = g =
b, 18 convert (0.299 r + 0.587 g + 0.114 b) to a float32 one ulp below the
integer in one package and not in the other (XLA:CPU fuses the
multiply-adds), and the splat raycast's key keeps the truncated gray, so a
keyframe render's gray then parts by one level on ~7% of the pixels, and
keyframe tracking on such frames parts by 1.5e-4 m from the first frame
(measured).

- ``--trajectory groundtruth.txt`` (no tracking), dense and ``--brick`` at
  ``--resolution 48``: the two packages' meshes are equal up to the tie
  voxels' cells.  A vertex of one mesh has a vertex of the other within
  ``VERTEX_ATOL`` (XLA:CPU's fused multiply-adds part the fused SDF by
  float32 ulps, which move a vertex by up to 4e-6 m here, measured; the
  files print 6 decimals), unless it lies in a cell next to a tie voxel
  (``test_torch_tsdf.tie_voxels``: a projection within ``TIE_EPS`` pixels
  of a half pixel in some frame); those are counted and at most 1% of the
  vertices.
- ``-m track-model`` under ``configs/tpu_fast.json`` (keyframe renders, a
  3.2 m tracking cube of 128^3 voxels): trajectories within 1e-5 m, face
  counts within 0.5%.
- A benchmark report's ``estimated_poses`` are read as a trajectory (the
  JAX package's reader takes only a ``poses`` key, which its benchmark's
  report does not write); ``test`` (the bundled set) raises
  ``FileNotFoundError``; without a GPU the default platform raises.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from scipy.spatial import cKDTree

from dense_visual_odometry_torch.apps import make_dataset as tmake
from dense_visual_odometry_torch.apps import reconstruct as trec
from dense_visual_odometry_torch.io import png as tpng
from dense_visual_odometry_torch.io import synthetic as tsyn
from dense_visual_odometry_torch.io import trajectory as ttraj
from dense_visual_odometry_torch.models import tsdf as ttsdf
from dense_visual_odometry_tpu.apps import reconstruct as jrec
from tests.test_torch_tsdf import tie_voxels

ROOT = Path(__file__).resolve().parents[1]
H, W, N_FRAMES, BAND = 120, 160, 6, 16
VERTEX_ATOL = 1e-5  # m
TIE_VERTEX_SHARE = 0.01
TRACK_ATOL_M = 1e-5
FACE_RTOL = 0.005
TRACK_FLAGS = ["-m", "track-model", "--track-volume-extent", "3.2", "--track-resolution", "128"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as the other tracker files run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """-> (TUM directory, camera YAML)."""
    root = tmp_path_factory.mktemp("tum")
    coarse, _, _ = tsyn.textured_scene(H // 2, W // 2, seed=0)
    gray = F.interpolate(torch.tensor(coarse)[None, None], size=(H, W), mode="bilinear",
                         align_corners=False)[0, 0].numpy()
    _, depth, k = tsyn.textured_scene(H, W, seed=0)
    tmake.write_tum_dataset(root / "seq", n_frames=N_FRAMES, motion="handheld-fr1",
                            source=(gray, depth, k))
    for path in (root / "seq" / "depth").iterdir():
        d = tpng.read_depth(path)
        d[:BAND], d[-BAND:], d[:, :BAND], d[:, -BAND:] = 0, 0, 0, 0
        tpng.write(path, d)
    for path in (root / "seq" / "rgb").iterdir():
        rgb = tpng.read_rgb(path).astype(np.int64)
        rgb[..., 0] += 1  # luma g + 0.185: no longer an integer (module docstring)
        rgb[..., 2] -= 1
        tpng.write(path, np.clip(rgb, 0, 255).astype(np.uint8))
    cam = root / "cam.yaml"
    cam.write_text(f"intrinsics: {np.asarray(k, float).tolist()}\n"
                   f"depth_scale: {1 / tmake.TUM_DN_PER_M}\n")
    return root / "seq", cam


def argv(dataset, out: Path, *flags):
    seq, cam = dataset
    return ["tum", "-d", str(seq), "--camera", str(cam), "-o", str(out), *flags]


def run_both(dataset, tmp_path, name, *flags):
    """Both CLIs on the CPU -> (the port's Reconstruction, the JAX package's
    poses or None, the two mesh paths)."""
    ext = ".obj" if "--brick" in flags else ".ply"
    t_mesh, j_mesh = tmp_path / f"port_{name}{ext}", tmp_path / f"jax_{name}{ext}"
    rec = trec.run(trec.parse_args(argv(dataset, t_mesh, *flags, "--platform", "cpu")))
    track, poses = jrec._track_poses, []

    def kept(*args, **kw):
        poses.append(track(*args, **kw))
        return poses[-1]

    jrec._track_poses = kept  # the poses its main tracks, for the comparison
    try:
        j_argv = argv(dataset, j_mesh, *flags, "--platform", "cpu")
        j_argv[0] = "tum-fr1"  # the JAX CLI's name for a TUM directory
        assert jrec.main(j_argv) == 0
    finally:
        jrec._track_poses = track
    return rec, (poses[0] if poses else None), t_mesh, j_mesh


def read_mesh(path: Path):
    """-> (vertices (V, 3), face count) of either writer's ASCII file."""
    lines = path.read_text().splitlines()
    if path.suffix == ".obj":
        verts = [ln.split()[1:4] for ln in lines if ln.startswith("v ")]
        return np.array(verts, float).reshape(-1, 3), sum(ln.startswith("f ") for ln in lines)
    n_v = int(next(ln for ln in lines if ln.startswith("element vertex")).split()[-1])
    n_f = int(next(ln for ln in lines if ln.startswith("element face")).split()[-1])
    start = lines.index("end_header") + 1
    verts = [ln.split()[:3] for ln in lines[start:start + n_v]]
    return np.array(verts, float).reshape(-1, 3), n_f


def unmatched(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Vertices of ``a`` with no vertex of ``b`` within VERTEX_ATOL."""
    dist, _ = cKDTree(b).query(a, p=np.inf)
    return a[dist > VERTEX_ATOL]


def tie_cells(rec) -> np.ndarray:
    """The run's tie voxels, dilated by one voxel (the cubes they touch)."""
    cfg = rec.volume_config
    dense = ttsdf.TSDFConfig(dims=cfg.dims, voxel_size=cfg.voxel_size, origin=cfg.origin,
                             truncation=cfg.truncation, min_depth=cfg.min_depth)
    ties = torch.tensor(tie_voxels(dense, [np.asarray(p, np.float32) for p in rec.fused_poses],
                                   rec.intrinsics))
    return F.max_pool3d(ties[None, None].float(), 3, stride=1, padding=1)[0, 0].bool().numpy()


@pytest.mark.parametrize("volume", ["dense", "brick"])
def test_trajectory_meshes_match_jax(dataset, tmp_path, volume):
    flags = ["--trajectory", str(dataset[0] / "groundtruth.txt"), "--resolution", "48"]
    flags += ["--brick"] if volume == "brick" else []
    rec, _, t_mesh, j_mesh = run_both(dataset, tmp_path, volume, *flags)
    assert rec.summary["method"] == "trajectory" and rec.summary["backend"] == "cpu"
    (vt, ft), (vj, fj) = read_mesh(t_mesh), read_mesh(j_mesh)
    assert ft > 1000 and len(vt) == rec.summary["vertices"] and ft == rec.summary["faces"]
    cells = tie_cells(rec)
    cfg = rec.volume_config
    parted = np.concatenate([unmatched(vt, vj), unmatched(vj, vt)])
    idx = np.floor((parted - np.asarray(cfg.origin)) / cfg.voxel_size - 0.5).astype(np.int64)
    idx = np.clip(idx, 0, np.array(cfg.dims[::-1]) - 1)
    assert cells[idx[:, 2], idx[:, 1], idx[:, 0]].all(), "a vertex off the tie cells parts"
    print(f"{volume}: {len(parted)} vertices in tie cells part of {len(vt)} + {len(vj)}")
    assert len(parted) <= TIE_VERTEX_SHARE * len(vt)


def test_track_model_matches_jax(dataset, tmp_path):
    rec, j_poses, t_mesh, j_mesh = run_both(dataset, tmp_path, "track", "-c",
                                            str(ROOT / "configs" / "tpu_fast.json"), *TRACK_FLAGS)
    s = rec.summary
    assert s["method"] == "track-model" and s["failures"] == 0 and s["renders"] >= 1
    assert len(s["step_ms"]) == N_FRAMES
    gap = np.abs(rec.poses[:, :3, 3] - j_poses[:, :3, 3]).max()
    print(f"track-model: the trajectories part by {gap} m")
    assert gap <= TRACK_ATOL_M
    (_, ft), (_, fj) = read_mesh(t_mesh), read_mesh(j_mesh)
    assert abs(ft - fj) <= FACE_RTOL * fj


def test_reads_a_benchmark_report(dataset, tmp_path):
    seq, _ = dataset
    _, poses = ttraj.load_tum_trajectory(seq / "groundtruth.txt")
    ttraj.save_report(tmp_path / "report.json", sequence_info={}, timestamps=range(len(poses)),
                      estimated_poses=poses, transforms=poses)
    rec = trec.run(trec.parse_args(argv(dataset, tmp_path / "m.ply", "--trajectory",
                                        str(tmp_path / "report.json"), "--resolution", "32",
                                        "--platform", "cpu")))
    np.testing.assert_allclose(rec.poses, np.asarray(poses)[:N_FRAMES])
    assert json.loads((tmp_path / "report.json").read_text()).keys() >= {"estimated_poses"}


def test_bundled_set_and_default_platform(dataset, tmp_path):
    with pytest.raises(FileNotFoundError):
        trec.run(trec.parse_args(["test", "-o", str(tmp_path / "m.ply"), "--platform", "cpu"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            trec.run(trec.parse_args(argv(dataset, tmp_path / "m.ply")))
