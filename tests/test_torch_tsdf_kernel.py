"""The dense fusion's wrapper and kernel (``ops/cuda/tsdf.py``).

This file imports no JAX, so its ``cuda`` test runs on a GPU machine that
has none, without the suite's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_tsdf_kernel.py

There ``test_cuda_integrate_matches_plain`` holds the kernel against the
plain version (``tsdf.integrate_plain``) on the card after several
successive fusions: the three fields equal bit for bit; here it skips.  The
plain version against the JAX package's fusion is ``tests/test_torch_tsdf.py``.
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
