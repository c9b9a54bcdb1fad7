"""The port's data path against the JAX package's, on the CPU.

Same seeded numpy inputs on both sides:

- ``metrics``: per-frame errors, the Umeyama alignment, ATE and RPE equal
  bit for bit (both are the same numpy float64 arithmetic).
- ``io/trajectory.py``: byte-equal TUM files, equal poses read back, and a
  ``save_report`` JSON equal to the JAX package's.
- ``apps.make_dataset.write_tum_dataset`` at 120x160, ``handheld-fr1``, 8
  frames, from the same source frame: both packages read it from a bundled
  set written into a temporary directory (their ``BUNDLED_DATA_DIR``
  patched in this test only); the three ``.txt`` files are equal and the
  PNGs decode to equal arrays.  ``io.synthetic``'s ``orbit_trajectory``,
  ``degrade_gray`` and ``degrade_depth`` give equal arrays for equal seeds.
- ``load_tum_sequence`` on that directory: equal paths, timestamps, ground
  truth, camera and decoded frames, by every read route (OpenCV, the
  native loader where it builds, the codec); ``pyr_down_sequence`` (the
  JAX package's is OpenCV's median blur) and ``host_gray_u8`` equal to the
  JAX package's; ``load_bundled_sequence`` raises FileNotFoundError in
  both while the set is absent.
- ``io/png.py``: round trips, and decodes equal to OpenCV's on every row
  filter type; the native loader equals the codec where it builds.
- ``io/checkpoint.py``: a session saved by the JAX package's
  ``save_session`` and loaded by the port's ``load_session`` takes its next
  step within 1e-5 of the JAX package's next step (equal iteration counts),
  and a session saved by the port loads in the JAX package.
"""

import json
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from dense_visual_odometry_torch import metrics as tmetrics
from dense_visual_odometry_torch.apps import make_dataset as tmake
from dense_visual_odometry_torch.camera import CameraModel as TCamera
from dense_visual_odometry_torch.config import RobustDVOConfig as TConfig
from dense_visual_odometry_torch.io import checkpoint as tckpt
from dense_visual_odometry_torch.io import datasets as tdata
from dense_visual_odometry_torch.io import native_loader as tnative
from dense_visual_odometry_torch.io import png as tpng
from dense_visual_odometry_torch.io import synthetic as tsyn
from dense_visual_odometry_torch.io import trajectory as ttraj
from dense_visual_odometry_torch.models.session import OdometrySession as TSession
from dense_visual_odometry_torch.utils.lie import se3
from dense_visual_odometry_tpu import metrics as jmetrics
from dense_visual_odometry_tpu.apps import make_dataset as jmake
from dense_visual_odometry_tpu.camera import CameraModel as JCamera
from dense_visual_odometry_tpu.config import RobustDVOConfig as JConfig
from dense_visual_odometry_tpu.io import checkpoint as jckpt
from dense_visual_odometry_tpu.io import datasets as jdata
from dense_visual_odometry_tpu.io import synthetic as jsyn
from dense_visual_odometry_tpu.io import trajectory as jtraj
from dense_visual_odometry_tpu.models.session import OdometrySession as JSession

H, W, N_FRAMES = 120, 160, 8
DN_PER_M = 5000.0


def seeded_poses(n, seed):
    """(n, 4, 4) float64 camera-to-world poses of a seeded random walk."""
    xi = np.cumsum(np.random.default_rng(seed).normal(0, 0.05, (n, 6)), axis=0)
    return se3.exp(torch.tensor(xi, dtype=torch.float64)).numpy()


def test_metrics_equal():
    est = seeded_poses(12, 0)
    gt = seeded_poses(12, 1)
    for t, j in zip(tmetrics.per_frame_errors(est, gt), jmetrics.per_frame_errors(est, gt)):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(tmetrics.align_umeyama(est[:, :3, 3], gt[:, :3, 3]),
                                  jmetrics.align_umeyama(est[:, :3, 3], gt[:, :3, 3]))
    for align in (True, False):
        t, j = tmetrics.ate_rmse(est, gt, align), jmetrics.ate_rmse(est, gt, align)
        assert t[0] == j[0]
        np.testing.assert_array_equal(t[1], j[1])
    for delta in (1, 3, 20):
        assert tmetrics.rpe(est, gt, delta) == jmetrics.rpe(est, gt, delta)


def test_trajectory_files_equal(tmp_path):
    poses = seeded_poses(10, 2)
    ts = 1000.0 + np.arange(10) / 30.0
    ttraj.save_tum_trajectory(tmp_path / "t.txt", ts, poses)
    jtraj.save_tum_trajectory(tmp_path / "j.txt", ts, poses)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    t_ts, t_poses = ttraj.load_tum_trajectory(tmp_path / "j.txt")
    j_ts, j_poses = jtraj.load_tum_trajectory(tmp_path / "j.txt")
    np.testing.assert_array_equal(t_ts, j_ts)
    np.testing.assert_allclose(t_poses, j_poses, atol=1e-7)
    transforms = [np.linalg.inv(poses[i + 1]) @ poses[i] for i in range(9)]
    kw = dict(sequence_info={"type": "TUM", "data_dir": "d"}, timestamps=ts,
              estimated_poses=list(poses), transforms=transforms, gt_poses=poses,
              per_frame=[{"time_s": 0.1}] * 10, summary={"ate_rmse_m": 0.01, "frames": 10})
    ttraj.save_report(tmp_path / "t.json", **kw)
    jtraj.save_report(tmp_path / "j.json", **kw)
    assert json.loads((tmp_path / "t.json").read_text()) == json.loads(
        (tmp_path / "j.json").read_text())
    # The port's poses as tensors write the same report.
    ttraj.save_report(tmp_path / "t2.json", **{**kw, "estimated_poses": [
        torch.tensor(p) for p in poses]})
    assert (tmp_path / "t2.json").read_text() == (tmp_path / "t.json").read_text()


@pytest.fixture(scope="module")
def bundled(tmp_path_factory):
    """A bundled-set-like directory (``ground_truth.json``,
    ``camera_intrinsics.yaml``, two RGB and depth PNGs) of a seeded 120x160
    scene."""
    root = tmp_path_factory.mktemp("bundled")
    gray, depth, k = tsyn.textured_scene(H, W, seed=5)
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    gt = {}
    for i in range(2):
        g8 = np.clip(np.round(gray + 3 * i), 0, 255).astype(np.uint8)
        rgb = np.stack([g8, np.roll(g8, 1, axis=1), np.roll(g8, 2, axis=0)], axis=-1)
        cv2.imwrite(str(root / f"rgb/{i}.png"), rgb[..., ::-1])
        cv2.imwrite(str(root / f"depth/{i}.png"), np.round(depth * DN_PER_M).astype(np.uint16))
        gt[str(i)] = {"rgb": f"rgb/{i}.png", "depth": f"depth/{i}.png",
                      "transformation": np.eye(4).tolist()}
    (root / "ground_truth.json").write_text(json.dumps(gt))
    (root / "camera_intrinsics.yaml").write_text(
        f"intrinsics: {np.asarray(k, float).tolist()}\ndepth_scale: 0.0002\n")
    return root


@pytest.fixture(scope="module")
def datasets_written(bundled, tmp_path_factory):
    """Both packages' ``write_tum_dataset`` output from frame 1 of the
    bundled-like set, with each package's bundled directory pointed at it."""
    out = tmp_path_factory.mktemp("written")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdata, "BUNDLED_DATA_DIR", bundled)
        mp.setattr(jdata, "BUNDLED_DATA_DIR", bundled)
        tmake.write_tum_dataset(out / "port", n_frames=N_FRAMES, motion="handheld-fr1",
                                source_frame=1, seed=3)
        jmake.write_tum_dataset(out / "jax", n_frames=N_FRAMES, motion="handheld-fr1",
                                source_frame=1, seed=3)
    return out / "port", out / "jax"


def test_write_tum_dataset_equal(datasets_written):
    port, jax_dir = datasets_written
    for name in ("rgb.txt", "depth.txt", "groundtruth.txt"):
        assert (port / name).read_text() == (jax_dir / name).read_text(), name
    names = sorted(p.relative_to(jax_dir) for p in jax_dir.rglob("*.png"))
    assert names == sorted(p.relative_to(port) for p in port.rglob("*.png"))
    assert len(names) >= 2 * N_FRAMES - 1
    for name in names:
        a = cv2.imread(str(port / name), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(jax_dir / name), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(a, b)


def test_make_dataset_synthetic_source(tmp_path, capsys):
    """``--source synthetic``: the seeded 640x480 scene under the TUM fr1
    pinhole."""
    tmake.main(["-o", str(tmp_path), "--frames", "2", "--source", "synthetic",
                "--motion", "medium"])
    assert "wrote 2 frames" in capsys.readouterr().out
    rgb = tpng.read_rgb(next((tmp_path / "rgb").iterdir()), via="codec")
    assert rgb.shape == (tmake.SOURCE_HEIGHT, tmake.SOURCE_WIDTH, 3)
    with pytest.raises(FileNotFoundError):
        tmake.main(["-o", str(tmp_path / "b"), "--frames", "2"])  # no bundled set here


@pytest.mark.parametrize("seed", [0, 4])
def test_synthetic_streams_equal(seed):
    np.testing.assert_array_equal(tsyn.orbit_trajectory(9, 0.01, 0.02, 0.004),
                                  jsyn.orbit_trajectory(9, 0.01, 0.02, 0.004))
    gray, depth, _ = tsyn.textured_scene(48, 64, seed=seed)
    depth[5:9, 10:20] = 0.0
    for pkg in (tsyn, jsyn):
        rng, state = np.random.default_rng(seed), {}
        out = [pkg.degrade_gray(gray, i, rng, state) for i in range(3)]
        out += [pkg.degrade_depth(depth, rng) for _ in range(2)]
        if pkg is tsyn:
            ref = out
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("via", tpng.ROUTES)
def test_load_tum_sequence_agrees(datasets_written, bundled, via, monkeypatch):
    port, _ = datasets_written
    cam = bundled / "camera_intrinsics.yaml"
    if via == "native":
        try:
            tnative.load_library()
        except tnative.NativeLoaderUnavailable as exc:
            pytest.skip(f"native loader unavailable: {exc}")
    t = tdata.load_tum_sequence(port, camera_yaml=cam)
    j = jdata.load_tum_sequence(port, camera_yaml=cam)
    assert len(t) == len(j) >= N_FRAMES - 1
    assert t.rgb_paths == j.rgb_paths and t.depth_paths == j.depth_paths
    np.testing.assert_array_equal(t.timestamps, j.timestamps)
    np.testing.assert_array_equal(t.gt_poses, j.gt_poses)
    assert t.extra == j.extra and t.name == j.name
    np.testing.assert_array_equal(t.camera.intrinsics.numpy(), np.asarray(j.camera.intrinsics))
    assert t.camera.depth_scale == j.camera.depth_scale
    monkeypatch.setattr(tpng, "route", lambda write=False: via)
    for (trgb, tdep), (jrgb, jdep) in zip(t, j):
        np.testing.assert_array_equal(trgb, jrgb)
        np.testing.assert_array_equal(tdep, jdep)
        assert trgb.dtype == np.uint8 and tdep.dtype == np.uint16
    assert len(list(t.subset(3).prefetched())) == 3


def test_pyr_down_and_host_gray_agree(datasets_written, bundled):
    port, _ = datasets_written
    cam = bundled / "camera_intrinsics.yaml"
    t = tdata.pyr_down_sequence(tdata.load_tum_sequence(port, camera_yaml=cam, size=2))
    j = jdata.pyr_down_sequence(jdata.load_tum_sequence(port, camera_yaml=cam, size=2))
    np.testing.assert_allclose(t.camera.intrinsics.numpy(), np.asarray(j.camera.intrinsics),
                               rtol=1e-7)
    assert t.extra == j.extra and t.name == j.name
    for (trgb, tdep), (jrgb, jdep) in zip(t.prefetched(), j.prefetched()):
        np.testing.assert_array_equal(trgb, jrgb)
        np.testing.assert_array_equal(tdep, jdep)
    rgb = np.random.default_rng(0).integers(0, 256, (37, 41, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tdata.host_gray_u8(rgb), jdata.host_gray_u8(rgb))


def test_load_bundled_sequence_raises_while_absent():
    with pytest.raises(FileNotFoundError):
        tdata.load_bundled_sequence()
    with pytest.raises(FileNotFoundError):
        jdata.load_bundled_sequence()


def encode_filtered(image: np.ndarray, kind: int) -> bytes:
    """A PNG of ``image`` (uint8 RGB or uint16 gray) with every row under
    filter ``kind`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    rgb = image.ndim == 3
    depth, colour = (8, 2) if rgb else (16, 0)
    rows = image.astype(np.uint8 if rgb else ">u2").reshape(image.shape[0], -1).view(np.uint8)
    bpp = 3 if rgb else 2
    rows = rows.astype(np.int32)
    prev = np.zeros_like(rows[0])
    out = []
    for row in rows:
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(np.concatenate([[kind], (row - pred) & 0xFF]).astype(np.uint8))
        prev = row

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(
            ">I", zlib.crc32(tag + body) & 0xFFFFFFFF)

    return (tpng.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", image.shape[1], image.shape[0], depth,
                                         colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(np.concatenate(out).tobytes()))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
def test_png_codec_decodes_like_opencv(tmp_path, kind):
    rng = np.random.default_rng(kind)
    base = np.cumsum(rng.integers(-9, 10, (21, 33, 3)), axis=1)
    rgb = np.clip(base + 128, 0, 255).astype(np.uint8)
    depth = np.clip(np.cumsum(rng.integers(-900, 900, (21, 33)), axis=0) + 30000, 0,
                    65535).astype(np.uint16)
    for name, image in (("rgb", rgb), ("depth", depth)):
        path = tmp_path / f"{name}.png"
        path.write_bytes(encode_filtered(image, kind))
        ref = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        got = tpng.decode(path)
        np.testing.assert_array_equal(got, ref[..., ::-1] if name == "rgb" else ref)
    np.testing.assert_array_equal(tpng.read_rgb(tmp_path / "rgb.png", via="codec"), rgb)
    np.testing.assert_array_equal(tpng.read_depth(tmp_path / "depth.png", via="codec"), depth)


def test_png_round_trip(tmp_path):
    rng = np.random.default_rng(9)
    images = {"rgb": rng.integers(0, 256, (17, 23, 3), dtype=np.uint8),
              "gray": rng.integers(0, 256, (17, 23), dtype=np.uint8),
              "depth": rng.integers(0, 65536, (17, 23), dtype=np.uint16)}
    for via in ("codec", "cv2"):
        for name, image in images.items():
            path = tpng.write(tmp_path / f"{name}-{via}.png", image, via=via)
            np.testing.assert_array_equal(tpng.decode(path), image)
            np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_UNCHANGED),
                                          image[..., ::-1] if name == "rgb" else image)
    np.testing.assert_array_equal(tpng.read_rgb(tmp_path / "gray-codec.png", via="codec"),
                                  np.repeat(images["gray"][..., None], 3, axis=2))
    with pytest.raises(ValueError, match="cannot write"):
        tpng.encode(tmp_path / "x.png", np.zeros((4, 4), np.float32))
    with pytest.raises(FileNotFoundError):
        tpng.read_depth(tmp_path / "missing.png", via="codec")
    assert tpng.route() in tpng.ROUTES


def test_native_loader_equals_codec(tmp_path):
    try:
        tnative.load_library()
    except tnative.NativeLoaderUnavailable as exc:
        pytest.skip(f"native loader unavailable: {exc}")
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (19, 27, 3), dtype=np.uint8)
    depth = rng.integers(0, 65536, (19, 27), dtype=np.uint16)
    paths = []
    for i in range(3):
        paths.append((tpng.encode(tmp_path / f"r{i}.png", np.roll(rgb, i, axis=0)),
                      tpng.encode(tmp_path / f"d{i}.png", np.roll(depth, i, axis=1))))
    for r, d in paths:
        np.testing.assert_array_equal(tnative.decode_rgb(r), tpng.read_rgb(r, via="codec"))
        np.testing.assert_array_equal(tnative.decode_depth(d), tpng.read_depth(d, via="codec"))
    with tnative.NativeSequenceLoader([r for r, _ in paths], [d for _, d in paths]) as loader:
        for (r, d), (lr, ld) in zip(paths, loader):
            np.testing.assert_array_equal(lr, tpng.decode(r))
            np.testing.assert_array_equal(ld, tpng.decode(d))


@pytest.fixture(scope="module")
def sessions(bundled):
    """Frames of a seeded 120x160 handheld sequence (a 16-pixel band of
    invalid depth, see ``test_torch_apps.py``), the camera and ``tpu_fast``
    at (4, 2, 1, 1) for both packages."""
    gray, depth, k = tsyn.textured_scene(H, W, seed=0)
    poses = tsyn.handheld_trajectory(4, seed=1)
    grays, depths = tsyn.render_sequence(gray, depth, k, poses)
    for d in depths:
        d[:16], d[-16:], d[:, :16], d[:, -16:] = 0, 0, 0, 0
    frames = [(g, np.round(d * DN_PER_M).astype(np.uint16)) for g, d in zip(grays, depths)]
    data = {**json.loads((Path(__file__).resolve().parents[1] / "configs" /
                          "tpu_fast.json").read_text()), "grid_strides": [4, 2, 1, 1]}
    return frames, k, data


def test_session_checkpoint_resumes_across_packages(sessions, tmp_path):
    frames, k, data = sessions
    jcfg, tcfg = JConfig.from_dict(data), TConfig.from_dict(data)
    jsess = JSession(JCamera.create(k, 1 / DN_PER_M), jcfg)
    for g, d in frames[:3]:
        jsess.step(g, d)
    jckpt.save_session(tmp_path / "jax.npz", jsess)
    tsess = tckpt.load_session(tmp_path / "jax.npz",
                               TSession(TCamera.create(k, 1 / DN_PER_M), tcfg, device="cpu"))
    np.testing.assert_array_equal(tsess.current_pose.matrix.numpy(),
                                  np.asarray(jsess.current_pose.matrix))
    g, d = frames[3]
    j_pose = np.asarray(jsess.step(g, d).matrix)
    t_pose = tsess.step(g, d).matrix.numpy()
    np.testing.assert_allclose(t_pose, j_pose, atol=1e-5)
    np.testing.assert_array_equal(
        tsess.last_output.result.diagnostics.iterations.numpy(),
        np.asarray(jsess.last_output.result.diagnostics.iterations))
    # And the other way: the port's checkpoint loads in the JAX package.
    tckpt.save_session(tmp_path / "port.npz", tsess)
    jback = jckpt.load_session(tmp_path / "port.npz", JSession(JCamera.create(k, 1 / DN_PER_M),
                                                              jcfg))
    np.testing.assert_array_equal(np.asarray(jback.current_pose.matrix), t_pose)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
    with pytest.raises(ValueError, match="pyramid levels"):
        tckpt.load_session(tmp_path / "jax.npz", TSession(
            TCamera.create(k, 1.0), TConfig(levels=3), device="cpu"))


def test_trajectory_state_round_trip(tmp_path):
    poses = seeded_poses(5, 3)
    ts = np.arange(5, dtype=np.float64)
    tckpt.save_trajectory_state(tmp_path / "t.npz", poses, ts, frame_index=4)
    for load in (tckpt.load_trajectory_state, jckpt.load_trajectory_state):
        state = load(tmp_path / "t.npz")
        np.testing.assert_array_equal(state["poses"], poses)
        np.testing.assert_array_equal(state["timestamps"], ts)
        assert state["frame_index"] == 4
    jckpt.save_trajectory_state(tmp_path / "j.npz", poses)
    state = tckpt.load_trajectory_state(tmp_path / "j.npz")
    assert state["timestamps"] is None and state["frame_index"] == 0
