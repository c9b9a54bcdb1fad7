"""Masked bilinear sampling, plain and through f16-packed planes.

Same semantics as ``dense_visual_odometry_tpu/ops/interp.py``: a sample at
(u, v) is valid iff ``floor(u) >= 0``, ``floor(v) >= 0``,
``floor(u) + 1 <= W - 1`` and ``floor(v) + 1 <= H - 1``; invalid samples
return 0.  :func:`bilinear_sample` reads four float32 taps.  In the packed
planes two f16 values share one int32 element (low half first), so a
bilinear sample reads two elements and a two-channel nearest sample one;
the f16 rounding points and all-f32 arithmetic are the reference's.

The bounds test runs on the float coordinates and indices are clamped
before the integer conversion, so a non-finite or far out-of-range
coordinate is simply invalid (it never wraps an int32).
"""

from __future__ import annotations

from typing import Tuple

import torch


def pack_pair_f16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two float planes -> one int32 plane holding (a, b) as f16 halves."""
    pair = torch.stack([a.to(torch.float16), b.to(torch.float16)], dim=-1)
    # Little-endian reinterpretation: a's bits land in the low 16 bits.
    return pair.contiguous().view(torch.int32)[..., 0]


def unpack_pair_f16(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_pair_f16` -> two float32 planes."""
    halves = packed.contiguous()[..., None].view(torch.float16)
    return halves[..., 0].to(torch.float32), halves[..., 1].to(torch.float32)


def pack_neighbors(image: torch.Tensor) -> torch.Tensor:
    """(..., H, W) image -> int32 plane of (I[y, x], I[y, x+1]) f16 pairs."""
    right = torch.cat([image[..., 1:], image[..., -1:]], dim=-1)
    return pack_pair_f16(image, right)


def _gather(plane: torch.Tensor, index: torch.Tensor, shape) -> torch.Tensor:
    """plane (B, H, W), index (B, ...) flat -> values of ``shape``."""
    h, w = plane.shape[-2], plane.shape[-1]
    flat = plane.reshape(plane.shape[:-2] + (h * w,))
    return torch.gather(flat, -1, index.reshape(index.shape[0], -1)).reshape(shape)


def _bilinear_base(h: int, w: int, u: torch.Tensor, v: torch.Tensor):
    """-> (valid, flat index of the top-left tap, wx, wy) of samples at
    (u, v) in an (H, W) plane; the index is clamped so that it reads safely
    where the sample is invalid."""
    x0f = torch.floor(u)
    y0f = torch.floor(v)
    valid = (x0f >= 0) & (y0f >= 0) & (x0f + 1 <= w - 1) & (y0f + 1 <= h - 1)
    x0c = torch.clamp(torch.nan_to_num(x0f), 0, w - 2).to(torch.int64)
    y0c = torch.clamp(torch.nan_to_num(y0f), 0, h - 2).to(torch.int64)
    return valid, y0c * w + x0c, u - x0f, v - y0f


def _lerp2(valid, v00, v01, v10, v11, wx, wy) -> torch.Tensor:
    """The reference's lerp order: along x on both rows, then along y."""
    top = v00 + wx * (v01 - v00)
    bot = v10 + wx * (v11 - v10)
    values = top + wy * (bot - top)
    return torch.where(valid, values, torch.zeros_like(values))


def bilinear_sample(
    image: torch.Tensor, u: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear sample of image (B, H, W) at u, v (B, H', W'), four float32
    taps -> (values, valid)."""
    h, w = image.shape[-2], image.shape[-1]
    valid, base, wx, wy = _bilinear_base(h, w, u, v)
    img = image.to(torch.float32)
    taps = [_gather(img, base + off, u.shape) for off in (0, 1, w, w + 1)]
    return _lerp2(valid, *taps, wx, wy), valid


def bilinear_sample_packed(
    packed_neighbors_plane: torch.Tensor, u: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear sample of a :func:`pack_neighbors` plane at (u, v).

    packed (B, H, W) int32; u, v (B, H', W') -> (values, valid).
    """
    h, w = packed_neighbors_plane.shape[-2], packed_neighbors_plane.shape[-1]
    valid, base, wx, wy = _bilinear_base(h, w, u, v)
    v00, v01 = unpack_pair_f16(_gather(packed_neighbors_plane, base, u.shape))
    v10, v11 = unpack_pair_f16(_gather(packed_neighbors_plane, base + w, u.shape))
    return _lerp2(valid, v00, v01, v10, v11, wx, wy), valid


def nearest_sample_packed(
    packed_plane: torch.Tensor, u: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest sample (round half to even) of a two-channel packed plane.

    -> (chan_a, chan_b, valid), zero where invalid.
    """
    h, w = packed_plane.shape[-2], packed_plane.shape[-1]
    xn = torch.round(u)
    yn = torch.round(v)
    valid = (xn >= 0) & (yn >= 0) & (xn <= w - 1) & (yn <= h - 1)
    xc = torch.clamp(torch.nan_to_num(xn), 0, w - 1).to(torch.int64)
    yc = torch.clamp(torch.nan_to_num(yn), 0, h - 1).to(torch.int64)
    a, b = unpack_pair_f16(_gather(packed_plane, yc * w + xc, u.shape))
    zero = torch.zeros_like(a)
    return torch.where(valid, a, zero), torch.where(valid, b, zero), valid
