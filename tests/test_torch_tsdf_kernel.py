"""The dense fusion's and the volume march's wrappers and kernels
(``ops/cuda/tsdf.py``).

This file imports no JAX, so its ``cuda`` tests run on a GPU machine that
has none, without the suite's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_tsdf_kernel.py

There ``test_cuda_integrate_matches_plain`` holds the fusion kernel against
the plain version (``tsdf.integrate_plain``) on the card after several
successive fusions: the three fields equal bit for bit.
``test_cuda_raycast_matches_plain`` and ``test_cuda_raycast_at_512`` hold
the march kernel against ``tsdf.raycast_view_march_volume_plain`` on the
card: depth and gray equal bit for bit.  Here they skip.  The plain fusion
against the JAX package's is ``tests/test_torch_tsdf.py``; the plain march
against a float64 reference ``tests/test_torch_kinfu512.py``.
"""

import math
import types

import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.models import frame_to_model, tsdf
from dense_visual_odometry_torch.ops.cuda import tsdf as tkernel
from dense_visual_odometry_torch.utils import profiling
from dense_visual_odometry_torch.utils.lie import se3

K = np.array([[517.3, 0.0, 318.6], [0.0, 516.5, 255.3], [0.0, 0.0, 1.0]], np.float32)


def _pose(rx=0.0, ry=0.0, t=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Camera-to-world: a rotation about x then y, and a translation."""
    cx, sx, cy, sy = math.cos(rx), math.sin(rx), math.cos(ry), math.sin(ry)
    r_x = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    r_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    p = np.eye(4)
    p[:3, :3] = r_y @ r_x
    p[:3, 3] = t
    return p.astype(np.float32)


def _frame(h, w, seed, depth0=1.2, invalid=False):
    """A seeded (depth m, gray) pair: a smooth relief around ``depth0`` and
    a textured gray; ``invalid``: a block and a tenth of the pixels at 0."""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    depth = (depth0 + 0.25 * np.sin(u / 37.0 + seed) * np.cos(v / 53.0)
             + 0.002 * rng.standard_normal((h, w)))
    gray = rng.uniform(0.0, 255.0, (h, w))
    if invalid:
        depth[h // 4:h // 2, w // 5:w // 2] = 0.0
        depth[rng.uniform(size=(h, w)) < 0.1] = 0.0
    return depth.astype(np.float32), gray.astype(np.float32)


def _k(h, w) -> np.ndarray:
    """The fr1 intrinsics scaled to an (h, w) frame."""
    k = K.copy()
    k[0] *= w / 640.0
    k[1] *= h / 480.0
    return k


# Each case: (dims, TSDFConfig keywords, frame (h, w), fusions as (pose,
# frame keywords)).  "cell" is kinfu512.b1.desk's volume (512^3 over 3 m,
# truncation 30 mm, cap 128); "odd" takes the scalar path and reaches its
# weight cap; "carve" observes free space where the first frame put the
# surface.
CELL = dict(voxel_size=3.0 / 512, origin=(-1.5, -1.5, 0.3), truncation=0.03,
            max_weight=128.0)
MOVES = [(_pose(), {"seed": 1}), (_pose(0.02, -0.03, (0.01, -0.02, 0.015)), {"seed": 2}),
         (_pose(-0.04, 0.05, (-0.03, 0.01, 0.05)), {"seed": 3})]
CASES = {
    "cell": ((512, 512, 512), CELL, (480, 640), MOVES),
    "odd": ((37, 41, 53), dict(voxel_size=0.04, origin=(-1.06, -0.82, 0.3), truncation=0.1,
                               max_weight=2.0), (61, 83), MOVES + MOVES[:1]),
    "scale_sq": ((64, 64, 64), dict(CELL, voxel_size=0.045, truncation_scale_sq=0.004),
                 (120, 160), MOVES),
    "carve": ((64, 64, 64), dict(CELL, voxel_size=0.045, truncation=0.06, carve_decay=0.5),
              (120, 160), [(_pose(), {"seed": 1}), (_pose(), {"seed": 1, "depth0": 1.8}),
                           (_pose(), {"seed": 2, "depth0": 1.6})]),
    "out_of_view": ((64, 64, 64), dict(CELL, voxel_size=0.045), (120, 160),
                    [(_pose(), {"seed": 1}),
                     (_pose(ry=1.0), {"seed": 2})]),
    "invalid_depth": ((64, 64, 64), dict(CELL, voxel_size=0.045), (120, 160),
                      [(p, dict(kw, invalid=True)) for p, kw in MOVES]),
}
# The CPU runs the same cases with the cell's volume at 64^3.
CPU_DIMS = {"cell": (64, 64, 64)}


def _config(case, cpu=False):
    dims, kw, _, _ = CASES[case]
    if cpu and case in CPU_DIMS:
        dims = CPU_DIMS[case]
        kw = dict(kw, voxel_size=kw["voxel_size"] * 512 / dims[0])
    return tsdf.TSDFConfig(dims=dims, **kw)


def _fusions(case, dev):
    """The case's frames and poses as float32 tensors on ``dev``."""
    _, _, (h, w), moves = CASES[case]
    k = torch.from_numpy(_k(h, w)).to(dev)
    for pose, kw in moves:
        depth, gray = _frame(h, w, **kw)
        yield (torch.from_numpy(depth).to(dev), torch.from_numpy(gray).to(dev), k,
               torch.from_numpy(pose).to(dev))


def _plain(volume, depth, gray, k, pose, cfg):
    return tsdf.integrate_plain(volume, depth, gray, k, se3.inverse(pose), cfg)


def _same_bits(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _observed(volume) -> int:
    return int((volume.weight > 0).sum())


@pytest.mark.parametrize("case", list(CASES))
def test_cpu_takes_the_plain_path(case):
    """A CPU volume runs the plain version and launches nothing: the same
    bits as the observe-and-fuse chain, fusion after fusion."""
    cfg = _config(case, cpu=True)
    vol, ref = tsdf.make_volume(cfg, "cpu"), tsdf.make_volume(cfg, "cpu")
    before = tkernel.integrate_volume.launches
    for depth, gray, k, pose in _fusions(case, torch.device("cpu")):
        assert tsdf.integrate(vol, depth, gray, k, pose, cfg) is vol
        xc, yc, zc = tsdf._voxel_camera_coords(cfg, se3.inverse(pose))
        new = tsdf.fuse(cfg, *tsdf.observe(cfg, xc, yc, zc, depth, gray, k), *ref)
        for field, value in zip(ref, new):
            field.copy_(value)
        assert all(_same_bits(a, b) for a, b in zip(vol, ref))
    assert tkernel.integrate_volume.launches == before
    _check_case(case, vol, cfg)


def _check_case(case, vol, cfg):
    """What each case is there to reach."""
    assert _observed(vol) > 1000
    if case == "odd":
        assert float(vol.weight.max()) == cfg.max_weight
    if case == "carve":  # a carved weight is no whole number
        assert bool((vol.weight != vol.weight.round()).any())


def _meta_inputs(dims=(4, 6, 8), h=5, w=7):
    meta = torch.device("meta")
    volume = tsdf.TSDFVolume(*(torch.zeros(dims, device=meta) for _ in range(3)))
    frame = (torch.zeros(h, w, device=meta), torch.zeros(h, w, device=meta),
             torch.zeros(3, 3, device=meta), torch.zeros(4, 4, device=meta))
    axes = tuple(torch.zeros(n, device=meta) for n in dims[::-1])
    return volume, frame, axes


@pytest.mark.parametrize("case", ["float64", "strided", "numel", "shapes", "frame", "axes",
                                  "device"])
def test_integrate_volume_checks_inputs(case):
    """A volume on a device with a kernel is refused unless the kernel takes
    it: float32, contiguous, 32-bit indexable, shapes that agree; on any
    device but CUDA the wrapper raises (meta tensors stand in for CUDA ones:
    the checks come before the launch)."""
    meta = torch.device("meta")
    volume, frame, axes = _meta_inputs()
    cfg = tsdf.TSDFConfig(dims=(4, 6, 8))
    err, match = {
        "float64": (TypeError, "float32"), "strided": (ValueError, "contiguous"),
        "numel": (ValueError, "32-bit"), "shapes": (ValueError, "one \\(D, H, W\\) shape"),
        "frame": (ValueError, "one \\(H, W\\) shape"), "axes": (ValueError, "W, H and D"),
        "device": (RuntimeError, "no kernel for device meta"),
    }[case]
    if case == "float64":
        volume = volume._replace(gray=torch.zeros(4, 6, 8, dtype=torch.float64, device=meta))
    elif case == "strided":
        volume = volume._replace(tsdf=torch.zeros(4, 8, 6, device=meta).transpose(1, 2))
    elif case == "numel":
        volume, frame, axes = _meta_inputs(dims=(1024, 1024, 2048))
    elif case == "shapes":
        volume = volume._replace(weight=torch.zeros(4, 6, 9, device=meta))
    elif case == "frame":
        frame = (frame[0], torch.zeros(5, 8, device=meta), *frame[2:])
    elif case == "axes":
        axes = axes[::-1]
    before = tkernel.integrate_volume.launches
    with pytest.raises(err, match=match):
        tkernel.integrate_volume(volume, *frame, axes, cfg)
    assert tkernel.integrate_volume.launches == before
    if case == "device":  # integrate: a CPU volume or the kernel, never the plain path
        pose = torch.eye(4, device=meta)
        with pytest.raises(RuntimeError, match="no kernel for device meta"):
            tsdf.integrate(volume, frame[0], frame[1], frame[2], pose, cfg)


def test_fused_kernel_counter(monkeypatch):
    """With the tracer on, ``_integrate`` counts ``map.fused_kernel``: the
    fusions that launched the kernel (a stand-in launch here)."""
    def launch(volume, *args):
        tkernel.integrate_volume.launches += int(volume == "cuda")

    monkeypatch.setattr(frame_to_model, "_vol_integrate", launch)
    fd = types.SimpleNamespace(depth_m=[None], gray=[None])
    profiling.disable_tracing()
    profiling.drain()
    profiling.enable_tracing()
    try:
        for volume in ("cuda", "cpu", "cuda"):
            tracker = types.SimpleNamespace(volume=volume, _intrinsics=None, tsdf_config=None,
                                            _voxels_fused=8)
            frame_to_model.FrameToModelTracker._integrate(tracker, fd, None)
    finally:
        profiling.disable_tracing()
    counters = profiling.drain()["counters"]
    assert counters["map.fused"] == 3 and counters["map.voxels_fused"] == 24
    assert counters["map.fused_kernel"] == 2 and counters["integrate_volume.launches"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_integrate_matches_plain(case):
    """The kernel against the plain version on the card, fusion after
    fusion from the same volume, one launch a fusion: the three fields
    equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU build")
    dev = torch.device("cuda")
    cfg = _config(case)
    vol, ref = tsdf.make_volume(cfg, dev), tsdf.make_volume(cfg, dev)
    for n, (depth, gray, k, pose) in enumerate(_fusions(case, dev)):
        before = tkernel.integrate_volume.launches
        assert tsdf.integrate(vol, depth, gray, k, pose, cfg) is vol
        assert tkernel.integrate_volume.launches == before + 1
        _plain(ref, depth, gray, k, pose, cfg)
        torch.cuda.synchronize()
        for name, a, b in zip(tsdf.TSDFVolume._fields, vol, ref):
            assert a.is_cuda and a.dtype == torch.float32 and a.is_contiguous()
            assert _same_bits(a, b), f"{name} differs after fusion {n}"
    _check_case(case, vol, cfg)


# ---------------------------------------------------------------------------
# The volume march.
# ---------------------------------------------------------------------------

# A 32^3 cube of 1.44 m whose front face is 0.3 m before the first camera,
# a truncation of 2.2 voxels; 60x80 views whose principal point is a pixel
# centre, so that a column's and a row's rays are parallel to the x and y
# slabs (their direction is exactly 0 there).
RAY_CELL = dict(voxel_size=0.045, origin=(-0.72, -0.72, 0.3), truncation=0.1, max_weight=128.0)
RAY_K = np.array([[64.6, 0.0, 40.0], [0.0, 64.5, 30.0], [0.0, 0.0, 1.0]], np.float32)
RAY_SHAPE = (60, 80)


def _flat(h, w, seed, depth):
    """A flat frame at ``depth`` with a textured gray."""
    rng = np.random.default_rng(seed)
    return np.full((h, w), depth, np.float32), rng.uniform(0.0, 255.0, (h, w)).astype(np.float32)


def _relief(seed, depth0=1.0, invalid=False):
    h, w = RAY_SHAPE
    depth, gray = _frame(h, w, seed, depth0=depth0, invalid=invalid)
    return depth * np.float32(0.4) + np.float32(0.6 * depth0), gray


# Each case: (TSDFConfig keywords, fusions as (pose, (depth, gray))), the
# render's pose, its steps (None: tsdf.volume_march_steps) and min_weight.
RAY_MOVES = [(_pose(), _relief(1)), (_pose(0.02, -0.03, (0.01, -0.02, 0.015)), _relief(2))]
RAY_RENDER = _pose(0.01, 0.02, (0.02, 0.01, -0.01))
RAY_CASES = {
    "outside": (RAY_CELL, RAY_MOVES, RAY_RENDER, None, 1.0),
    "inside": (dict(RAY_CELL, origin=(-0.72, -0.72, -0.4)),
               [(p, _relief(n + 1, depth0=0.7)) for n, (p, _) in enumerate(RAY_MOVES)],
               RAY_RENDER, None, 1.0),
    "oblique": (RAY_CELL, RAY_MOVES, _pose(0.15, -0.2, (0.1, 0.05, 0.0)), None, 1.0),
    "parallel_in": (RAY_CELL, RAY_MOVES, _pose(), None, 1.0),
    "parallel_out": (RAY_CELL, RAY_MOVES, _pose(t=(-0.9, 0.0, 0.0)), None, 1.0),
    "no_surface": (RAY_CELL, [], RAY_RENDER, None, 1.0),
    "entry_crossing": (RAY_CELL, [(_pose(), _flat(*RAY_SHAPE, 1, 0.33))], _pose(), None, 1.0),
    "behind_at_entry": (RAY_CELL, [(_pose(), _flat(*RAY_SHAPE, 2, 0.28))], _pose(), None, 1.0),
    "n_steps_0": (RAY_CELL, RAY_MOVES, RAY_RENDER, 0, 1.0),
    "few_steps": (RAY_CELL, RAY_MOVES, RAY_RENDER, 9, 1.0),
    "min_weight": (RAY_CELL, [(p, _relief(n + 1, invalid=True)) for n, (p, _) in
                              enumerate(RAY_MOVES)], RAY_RENDER, None, 2.0),
    "scale_sq": (dict(RAY_CELL, truncation=0.06, truncation_scale_sq=0.03), RAY_MOVES,
                 RAY_RENDER, None, 1.0),
}


def _ray_case(case, dev):
    """-> (cfg, volume, intrinsics, pose, steps, step, min_weight) on ``dev``."""
    kw, fusions, pose, steps, min_weight = RAY_CASES[case]
    cfg = tsdf.TSDFConfig(dims=(32, 32, 32), **kw)
    vol = tsdf.make_volume(cfg, dev)
    k = torch.from_numpy(RAY_K).to(dev)
    for fpose, (depth, gray) in fusions:
        tsdf.integrate_plain(vol, torch.from_numpy(depth).to(dev), torch.from_numpy(gray).to(dev),
                             k, se3.inverse(torch.from_numpy(fpose).to(dev)), cfg)
    step = tsdf.VOLUME_MARCH_STEP * cfg.truncation
    if steps is None:
        steps = tsdf.volume_march_steps(cfg, pose, step)
    return cfg, vol, k, torch.from_numpy(pose).to(dev), steps, step, min_weight


def _check_ray_case(case, depth, gray, vol, min_weight):
    """What each render case is there to reach."""
    hit = depth > 0
    share = float(hit.double().mean())
    if case in ("no_surface", "n_steps_0"):
        assert share == 0.0 and not bool((gray != 0).any())
    elif case == "behind_at_entry":  # the entry samples read the band behind the surface
        assert share < 0.1, share
    elif case == "few_steps":  # 9 steps of 8 cm reach the surface's nearest part only
        assert 0.0 < share < 0.5, share
    else:
        assert share > 0.3, share
    if case == "entry_crossing":  # the crossing lies between the entry and the next sample
        assert float(depth[hit].max()) < 0.3 + 2 * tsdf.VOLUME_MARCH_STEP * 0.1
    if case == "min_weight":  # voxels seen once are free space to this render
        assert bool(((vol.weight > 0) & (vol.weight < min_weight)).any())
    if case == "parallel_in":
        assert bool(hit[:, 40].all()) and bool(hit[30].all())
    if case == "parallel_out":  # the camera is left of the box: that column never enters
        assert not bool(hit[:, 40].any())


@pytest.mark.parametrize("case", list(RAY_CASES))
def test_cpu_render_takes_the_plain_path(case):
    """A CPU volume renders by the plain march and launches nothing: the same
    bits as ``raycast_view_march_volume_plain``."""
    cfg, vol, k, pose, steps, step, min_weight = _ray_case(case, torch.device("cpu"))
    before = tkernel.raycast_volume.launches
    depth, gray = tsdf.raycast_view_march_volume(vol, k, pose, cfg, RAY_SHAPE, steps, step,
                                                 min_weight=min_weight)
    ref = tsdf.raycast_view_march_volume_plain(vol, k, pose, cfg, RAY_SHAPE, steps, step,
                                               min_weight=min_weight)
    assert tkernel.raycast_volume.launches == before
    assert _same_bits(depth, ref[0]) and _same_bits(gray, ref[1])
    assert depth.shape == RAY_SHAPE and depth.dtype == torch.float32
    _check_ray_case(case, depth, gray, vol, min_weight)


@pytest.mark.parametrize("case", ["float64", "strided", "numel", "shapes", "mixed", "camera",
                                  "view", "device"])
def test_raycast_volume_checks_inputs(case):
    """The march kernel's wrapper refuses what the kernel does not take:
    float32, contiguous, 32-bit indexable fields of one shape, a camera on
    the volume's device, a 3x3 K and a 4x4 pose, a positive view; on any
    device but CUDA it raises (meta tensors stand in for CUDA ones: the
    checks come before the launch)."""
    meta = torch.device("meta")
    volume, _, _ = _meta_inputs()
    k, pose = torch.zeros(3, 3, device=meta), torch.zeros(4, 4, device=meta)
    cfg, shape = tsdf.TSDFConfig(dims=(4, 6, 8)), (5, 7)
    err, match = {
        "float64": (TypeError, "float32"), "strided": (ValueError, "contiguous"),
        "numel": (ValueError, "32-bit"), "shapes": (ValueError, "one \\(D, H, W\\) shape"),
        "mixed": (ValueError, "volume's device"), "camera": (ValueError, "3x3"),
        "view": (ValueError, "positive \\(H, W\\)"),
        "device": (RuntimeError, "no kernel for device meta"),
    }[case]
    if case == "float64":
        pose = torch.zeros(4, 4, dtype=torch.float64, device=meta)
    elif case == "strided":
        volume = volume._replace(weight=torch.zeros(4, 8, 6, device=meta).transpose(1, 2))
    elif case == "numel":
        volume, _, _ = _meta_inputs(dims=(1024, 1024, 2048))
    elif case == "shapes":
        volume = volume._replace(gray=torch.zeros(4, 6, 9, device=meta))
    elif case == "mixed":
        pose = torch.zeros(4, 4)
    elif case == "camera":
        k = torch.zeros(4, 4, device=meta)
    elif case == "view":
        shape = (0, 7)
    before = tkernel.raycast_volume.launches
    with pytest.raises(err, match=match):
        tkernel.raycast_volume(volume, k, pose, cfg, shape, 10, 0.08, 1.0, 10.0,
                               tsdf.volume_box(cfg))
    assert tkernel.raycast_volume.launches == before
    if case == "device":  # the march: a CPU volume or the kernel, never the plain path
        with pytest.raises(RuntimeError, match="no kernel for device meta"):
            tsdf.raycast_view_march_volume(volume, k, pose, cfg, shape, 10, 0.08)


def test_render_kernel_counter(monkeypatch):
    """With the tracer on, a keyframe render and a KinectFusion step's render
    count ``map.render_kernel``: the renders that launched the march kernel
    (a stand-in launch here)."""
    def render(volume, *args):
        tkernel.raycast_volume.launches += int(volume == "cuda")
        return torch.ones(4, 4), torch.ones(4, 4)

    eye = torch.eye(4)
    result = types.SimpleNamespace(transform=eye[None], success=torch.tensor([True]))
    monkeypatch.setattr(frame_to_model, "_vol_render", render)
    monkeypatch.setattr(frame_to_model, "_preprocess",
                        lambda *a: types.SimpleNamespace(depth_m=[torch.ones(1, 2, 2)]))
    monkeypatch.setattr(frame_to_model, "track_pair", lambda *a, **kw: result)
    monkeypatch.setattr(frame_to_model, "_batch1", lambda frame: frame)
    camera = types.SimpleNamespace(intrinsics=torch.eye(3))
    config = types.SimpleNamespace(levels=1)
    profiling.disable_tracing()
    profiling.drain()
    profiling.enable_tracing()
    try:
        for volume in ("cuda", "cpu", "cuda"):
            tracker = types.SimpleNamespace(
                volume=volume, _intrinsics=None, config=config, tsdf_config=None, _shape=None,
                policy=frame_to_model.ModelTrackerPolicy(), renders=0,
                _tensor=lambda m: torch.as_tensor(m, dtype=torch.float32),
                _march=lambda world: None)
            frame_to_model.FrameToModelTracker._render(tracker, np.eye(4))
            assert tracker.renders == 1 and len(tracker._keyframe.gray) == 1
            frame_to_model._kinfu_step(volume, eye, None, None, camera, eye, config, None, None,
                                       1.0, 10.0)
    finally:
        profiling.disable_tracing()
    drained = profiling.drain()
    assert sum(s["name"] == "map.render" for s in drained["spans"]) == 6
    counters = drained["counters"]
    assert counters["map.render_kernel"] == 4 and counters["raycast_volume.launches"] == 4


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU build")
    return torch.device("cuda")


def _render_both(vol, k, pose, cfg, shape, steps, step, min_weight):
    """The kernel's render (one launch) and the plain march's, on the card."""
    before = tkernel.raycast_volume.launches
    out = tsdf.raycast_view_march_volume(vol, k, pose, cfg, shape, steps, step,
                                         min_weight=min_weight)
    assert tkernel.raycast_volume.launches == before + 1
    ref = tsdf.raycast_view_march_volume_plain(vol, k, pose, cfg, shape, steps, step,
                                               min_weight=min_weight)
    torch.cuda.synchronize()
    for a in out:
        assert a.is_cuda and a.dtype == torch.float32 and a.shape == shape
    return out, ref


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RAY_CASES))
def test_cuda_raycast_matches_plain(case):
    """The march kernel against the plain march on the card, one launch a
    render: depth and gray equal bit for bit."""
    cfg, vol, k, pose, steps, step, min_weight = _ray_case(case, _cuda())
    (depth, gray), (ref_d, ref_g) = _render_both(vol, k, pose, cfg, RAY_SHAPE, steps, step,
                                                 min_weight)
    assert _same_bits(depth, ref_d), f"depth parts at {int((depth != ref_d).sum())} pixels"
    assert _same_bits(gray, ref_g), f"gray parts at {int((gray != ref_g).sum())} pixels"
    _check_ray_case(case, depth.cpu(), gray.cpu(), vol, min_weight)


@pytest.mark.cuda
def test_cuda_raycast_at_512():
    """kinfu512.b1.desk's volume (512^3 over 3 m) fused from four frames of
    the synthetic scene, rendered at 640x480 from five poses of its
    hand-held path: the kernel equals the plain march bit for bit."""
    from dense_visual_odometry_torch.io import synthetic

    dev = _cuda()
    cfg = _config("cell")
    scene_gray, scene_depth, k_np = synthetic.textured_scene(480, 640, seed=1)
    poses = synthetic.handheld_trajectory(6, seed=2)
    grays, depths = synthetic.render_sequence(scene_gray, scene_depth, k_np, poses)
    rel = [np.linalg.inv(poses[0]) @ p for p in poses]
    k = torch.from_numpy(np.asarray(k_np, np.float32)).to(dev)
    vol = tsdf.make_volume(cfg, dev)
    for depth, gray, pose in zip(depths[:4], grays[:4], rel[:4]):
        tsdf.integrate(vol, torch.from_numpy(depth).to(dev), torch.from_numpy(gray).to(dev), k,
                       torch.from_numpy(pose.astype(np.float32)).to(dev), cfg)
    step = tsdf.VOLUME_MARCH_STEP * cfg.truncation
    for pose in rel[1:]:
        steps = tsdf.volume_march_steps(cfg, pose, step)
        pose_d = torch.from_numpy(pose.astype(np.float32)).to(dev)
        (depth, gray), (ref_d, ref_g) = _render_both(vol, k, pose_d, cfg, (480, 640), steps,
                                                     step, 1.0)
        assert _same_bits(depth, ref_d), f"depth parts at {int((depth != ref_d).sum())} pixels"
        assert _same_bits(gray, ref_g), f"gray parts at {int((gray != ref_g).sum())} pixels"
        assert float((depth > 0).double().mean()) > 0.5


@pytest.mark.cuda
def test_cuda_render_counters():
    """A KinectFusion tracker on the card launches the march kernel once a
    render, and counts it in ``map.render_kernel``."""
    from dense_visual_odometry_torch.camera import CameraModel
    from dense_visual_odometry_torch.config import RobustDVOConfig
    from dense_visual_odometry_torch.io import synthetic

    dev = _cuda()
    h, w = 120, 160
    scene_gray, scene_depth, k_np = synthetic.textured_scene(h, w, seed=1)
    poses = synthetic.handheld_trajectory(4, seed=2)
    grays, depths = synthetic.render_sequence(scene_gray, scene_depth, k_np, poses)
    cfg = tsdf.TSDFConfig(dims=(64, 64, 64), voxel_size=3.0 / 64, origin=(-1.5, -1.5, 0.3),
                          truncation=0.12, max_weight=128.0)
    policy = frame_to_model.ModelTrackerPolicy(render_every_frame=True, raycast="volume")
    tracker = frame_to_model.FrameToModelTracker(
        CameraModel.create(k_np, 1.0), RobustDVOConfig(levels=3), cfg, policy, device=dev)
    profiling.disable_tracing()
    profiling.drain()
    profiling.enable_tracing()
    try:
        for gray, depth in zip(grays, depths):
            tracker.step(gray, depth)
    finally:
        profiling.disable_tracing()
    drained = profiling.drain()
    renders = sum(s["name"] == "map.render" for s in drained["spans"])
    counters = drained["counters"]
    assert renders == len(grays) - 1
    assert counters["map.render_kernel"] == renders
    assert counters["raycast_volume.launches"] == renders
