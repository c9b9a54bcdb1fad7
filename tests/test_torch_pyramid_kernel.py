"""The pyramid step's wrapper and kernel (``ops/cuda/pyramid.py``).

This file imports no JAX, so its ``cuda`` test runs on a GPU machine that
has none, without the suite's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_pyramid_kernel.py

There ``test_cuda_median_pyr_down_matches_plain`` holds the kernel against
the plain network on the card (``median3x3(x)[..., ::2, ::2]``, the same
PyTorch min/max): equal element for element, NaN where NaN; here it skips.
The plain network against the JAX package's pyramid is
``tests/test_torch_image_ops.py``.
"""

import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.camera import CameraModel
from dense_visual_odometry_torch.models import robust
from dense_visual_odometry_torch.ops import pyramid as tpyr
from dense_visual_odometry_torch.ops.cuda import pyramid as tkernel

LEVELS = 4
K = np.array([[517.3, 0.0, 318.6], [0.0, 516.5, 255.3], [0.0, 0.0, 1.0]], np.float32)


def _image(shape, seed=3, special=False, zeros=False):
    """A seeded float32 image; ``special``: NaN, +inf and -inf pixels (in
    rows of their own and beside each other); ``zeros``: depth with zeroed
    (invalid) pixels."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 255.0, shape).astype(np.float32)
    if special:
        x[..., 3, 5] = np.nan
        x[..., 10, 11:13] = np.inf
        x[..., 17, 20] = -np.inf
        x[..., 18, 20] = np.nan
        x[..., -2:, -2:] = np.inf
    if zeros:
        x = x / 64.0
        x[..., 3:9, 4:15] = 0.0
        x[rng.uniform(size=shape) < 0.1] = 0.0
    return torch.from_numpy(x)


def _plain_down(x):
    return tpyr.median3x3(x)[..., ::2, ::2].contiguous()


def _same(a, b) -> bool:
    """Equal element for element, NaN where NaN."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return (a.shape == b.shape and torch.equal(nan_a, nan_b)
            and torch.equal(a.masked_fill(nan_a, 0.0), b.masked_fill(nan_b, 0.0)))


@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (31, 45), (2, 3, 31, 45)],
                         ids=["1x1", "2x3", "31x45", "lead2x3"])
def test_cpu_takes_the_plain_path(shape):
    """CPU tensors run the plain network and launch nothing."""
    before = tkernel.median_pyr_down.launches
    x = _image(shape, special=shape[-2:] == (31, 45))
    out = tkernel.median_pyr_down(x)
    assert out.shape == shape[:-2] + ((shape[-2] + 1) // 2, (shape[-1] + 1) // 2)
    assert out.is_contiguous()
    assert _same(out, _plain_down(x))
    # A pyramid and a whole frame's pyramids on the CPU: the same path.
    pyr = tpyr.build_pyramid(x, LEVELS)
    assert _same(pyr[1], out)
    robust.preprocess_frame(_image((24, 32)), np.zeros((24, 32), np.uint16),
                            CameraModel.create(K, 2e-4), levels=LEVELS, device="cpu")
    assert tkernel.median_pyr_down.launches == before


@pytest.mark.parametrize("case", ["float64", "strided", "numel", "lead"])
def test_median_pyr_down_checks_inputs(case):
    """A tensor on a device with a kernel is refused unless the kernel takes
    it: float32, contiguous, 32-bit indexable, at most 65535 planes (meta
    tensors stand in for CUDA ones: the checks come before the launch)."""
    meta = torch.device("meta")
    bad = {
        "float64": (torch.zeros(2, 8, 10, dtype=torch.float64, device=meta), TypeError,
                    "float32"),
        "strided": (torch.zeros(2, 10, 8, device=meta).transpose(1, 2), ValueError,
                    "contiguous"),
        "numel": (torch.zeros(8, 16384, 16384, device=meta), ValueError, "32-bit"),
        "lead": (torch.zeros(65536, 2, 2, device=meta), ValueError, "32-bit"),
    }
    x, err, match = bad[case]
    with pytest.raises(err, match=match):
        tkernel.median_pyr_down(x)
    with pytest.raises(ValueError, match=r"\(\.\.\., H, W\)"):
        tkernel.median_pyr_down(torch.zeros(5, device=meta))


CUDA_CASES = {
    "b1": ((1, 480, 640), {}),
    "b2": ((2, 480, 640), {}),
    "b64": ((64, 480, 640), {}),
    "1x1": ((1, 1), {}),
    "2x3": ((2, 3), {}),
    "31x45": ((31, 45), {}),
    "61x81": ((61, 81), {}),
    "lead2x3": ((2, 3, 31, 45), {}),
    "nan_inf": ((2, 61, 81), {"special": True}),
    "depth_zeros": ((2, 480, 640), {"zeros": True}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_cuda_median_pyr_down_matches_plain(case):
    """The kernel against the plain network on the card, every level of a
    4-level pyramid, one launch a level."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU build")
    shape, kw = CUDA_CASES[case]
    x = _image(shape, **kw).cuda()
    before = tkernel.median_pyr_down.launches
    pyr = tpyr.build_pyramid(x, LEVELS)
    assert tkernel.median_pyr_down.launches == before + LEVELS - 1
    plain = [x]
    for _ in range(1, LEVELS):
        plain.append(_plain_down(plain[-1]))
    torch.cuda.synchronize()
    for level, (k, p) in enumerate(zip(pyr, plain)):
        assert k.is_cuda and k.dtype == torch.float32 and k.is_contiguous()
        assert _same(k, p), f"level {level} differs"
    if kw.get("special"):
        assert torch.isnan(pyr[1]).any() and torch.isinf(pyr[1]).any()

    # A frame's gray and depth pyramids: 2 x (levels - 1) launches.
    if len(shape) == 3 and shape[-2:] == (480, 640):
        rgb = torch.from_numpy(np.random.default_rng(5).integers(
            0, 256, shape + (3,), dtype=np.uint8)).cuda()
        depth = torch.from_numpy(np.random.default_rng(6).integers(
            0, 30000, shape, dtype=np.int64)).cuda()
        before = tkernel.median_pyr_down.launches
        frame = robust.preprocess_frame(rgb, depth, CameraModel.create(K, 2e-4),
                                        levels=LEVELS, device="cuda")
        assert tkernel.median_pyr_down.launches == before + 2 * (LEVELS - 1)
        gray = tpyr.rgb_to_gray(rgb)
        z = tpyr.preprocess_depth(depth, 2e-4)
        for level in range(1, LEVELS):
            gray, z = _plain_down(gray), _plain_down(z)
            assert _same(frame.gray[level], gray) and _same(frame.depth_m[level], z)
