"""Frozen-window ("shift ball") geometry shared by the solver and the kernels.

Counterparts of ``dense_visual_odometry_tpu/ops/shiftwarp.py``
(``shift_coverage``) and of the helpers in
``dense_visual_odometry_tpu/ops/pallas/stackwarp.py`` (``compute_recenter``,
``residual_displacements``, ``extract_parity_planes``,
``prepare_shift_stack``).  A level samples the current image through a
window extracted once, at the level's starting estimate, around one integer
centre (cu, cv) per batch element: the centre absorbs the mean displacement
of the strided grid, and a pixel stays valid while its displacement from
that centre lies inside the open ball ``|du| < r, |dv| < r``.  Inside the
ball, tent-tap accumulation over the window equals bilinear sampling.

The window is stored as ``s^2`` parity planes so that the tap at window row
``a + s*i`` and column ``b + s*j`` is
``planes[(a % s) * s + b % s][a // s + i, b // s + j]``.

With row blocks or 2-D tiles (``ops/blockwarp.py``) every block of grid
pixels has its own centre and its own window, and the ball may be
anisotropic (``|du| < r, |dv| < r_y``): :class:`WindowLayout` says how the
grid is cut, and :func:`tent_sample` samples each pixel from its block's
window.  One centre is the layout of a single block.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


def block_layout(grid_hp: int, n_blocks: int, radius_y: int, grid_stride: int
                 ) -> Tuple[int, int, int]:
    """-> (blocks, grid rows per block, halo rows) of ``n_blocks`` row blocks
    over ``grid_hp`` grid rows: the count is clamped to the rows, each block
    takes ``t`` = ceil(H' / count) rows (the last may be short), and the
    count follows from ``t`` (9 rows in 4 blocks: 3 blocks of 3).  The halo,
    2 r_y // s, is how many plane rows a block's window holds beyond its own
    ``t``.  JAX ``ops/pallas/stackwarp.block_layout``."""
    nblk = max(1, min(n_blocks, grid_hp))
    t = -(-grid_hp // nblk)
    nblk = -(-grid_hp // t)
    return nblk, t, (2 * radius_y) // grid_stride


def tile_layout(grid_hp: int, grid_wp: int, n_blocks_y: int, n_blocks_x: int, radius: int,
                radius_y: int, grid_stride: int) -> Tuple[int, int, int, int, int, int]:
    """-> (nby, t_y, halo_y, nbx, t_x, halo_x): :func:`block_layout` on the
    rows with the vertical radius and on the columns with the horizontal
    one.  JAX ``ops/pallas/stackwarp.tile_layout``."""
    nby, t_y, halo_y = block_layout(grid_hp, n_blocks_y, radius_y, grid_stride)
    nbx, t_x, halo_x = block_layout(grid_wp, n_blocks_x, radius, grid_stride)
    return nby, t_y, halo_y, nbx, t_x, halo_x


class WindowLayout(NamedTuple):
    """How a level's H' x W' grid is cut into blocks, each sampled from a
    window of its own: ``nby`` x ``nbx`` blocks of ``t_y`` x ``t_x`` grid
    pixels (the last row and column of blocks may be short), block
    ``(k, l)`` = ``k * nbx + l`` holding pixels ``[k t_y, (k+1) t_y) x
    [l t_x, (l+1) t_x)``; each window is ``s^2`` parity planes of ``ph`` x
    ``pw`` = ``t_y + 2 r_y // s`` x ``t_x + 2 r // s``.  One block is the
    single-centre window (``extract_parity_planes``)."""

    nby: int
    t_y: int
    nbx: int
    t_x: int
    ph: int
    pw: int
    radius: int  # horizontal tap radius r
    radius_y: int  # vertical tap radius r_y

    @property
    def blocks(self) -> int:
        return self.nby * self.nbx

    @property
    def tiles(self) -> bool:
        """A 2-D tile mosaic (``recenter_col_blocks``), not row blocks."""
        return self.nbx > 1


def window_layout(grid_hp: int, grid_wp: int, radius: int, grid_stride: int,
                  n_blocks: int = 1, n_blocks_x: int = 1,
                  radius_y: Optional[int] = None) -> WindowLayout:
    """The layout of ``n_blocks`` row blocks, or with ``n_blocks_x`` > 1 of
    ``n_blocks`` x ``n_blocks_x`` tiles, as the JAX package's level solver
    cuts a level (``solve_level_fused``); ``radius_y`` (default ``radius``)
    is the vertical tap radius, which needs blocks or tiles."""
    ry = radius if radius_y is None else radius_y
    s = grid_stride
    if n_blocks_x > 1:
        nby, t_y, halo_y, nbx, t_x, halo_x = tile_layout(
            grid_hp, grid_wp, n_blocks, n_blocks_x, radius, ry, s)
    elif n_blocks > 1:
        nby, t_y, halo_y = block_layout(grid_hp, n_blocks, ry, s)
        nbx, t_x, halo_x = 1, grid_wp, (2 * radius) // s
    else:
        if ry != radius:
            raise ValueError("an anisotropic ball (radius_y) needs row blocks or tiles")
        nby, t_y, halo_y = 1, grid_hp, (2 * radius) // s
        nbx, t_x, halo_x = 1, grid_wp, (2 * radius) // s
    return WindowLayout(nby, t_y, nbx, t_x, t_y + halo_y, t_x + halo_x, radius, ry)


def block_index(layout: WindowLayout, hp: int, wp: int, device):
    """-> (block (H', W') int64, local row (H',) and column (W',)) of every
    grid pixel: its block ``k * nbx + l`` and its place in that block."""
    row = torch.arange(hp, device=device)
    col = torch.arange(wp, device=device)
    k, l = row // layout.t_y, col // layout.t_x
    return k[:, None] * layout.nbx + l[None, :], row - k * layout.t_y, col - l * layout.t_x


def _grid_displacements(u, v, grid_stride):
    hp, wp = u.shape[-2], u.shape[-1]
    col = torch.arange(wp, dtype=torch.float32, device=u.device) * grid_stride
    row = torch.arange(hp, dtype=torch.float32, device=u.device) * grid_stride
    return u - col[None, :], v - row[:, None]


def shift_coverage(
    u: torch.Tensor,
    v: torch.Tensor,
    radius: int,
    grid_stride: int,
    coord_mask: torch.Tensor,
) -> torch.Tensor:
    """(B,) fraction of the pixels of ``coord_mask`` (those with real
    coordinates) that the recentred ball would keep."""
    cu, cv = compute_recenter(u, v, radius, grid_stride, coord_mask)
    du, dv = _grid_displacements(u, v, grid_stride)
    du = du - cu[..., None, None].to(torch.float32)
    dv = dv - cv[..., None, None].to(torch.float32)
    in_ball = (du > -radius) & (du < radius) & (dv > -radius) & (dv < radius)
    mf = coord_mask.to(torch.float32)
    denom = torch.clamp(torch.sum(mf, dim=(-2, -1)), min=1.0)
    return torch.sum(in_ball.to(torch.float32) * mf, dim=(-2, -1)) / denom


def compute_recenter(
    u: torch.Tensor,
    v: torch.Tensor,
    radius: int,
    grid_stride: int,
    coord_mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,) int32 centres: the mean displacement over ``coord_mask``,
    rounded half to even and clipped to +-4*radius."""
    du, dv = _grid_displacements(u, v, grid_stride)
    center_bound = 4 * radius
    mf = coord_mask.to(torch.float32)
    denom = torch.clamp(torch.sum(mf, dim=(-2, -1)), min=1.0)
    mean_du = torch.sum(du * mf, dim=(-2, -1)) / denom
    mean_dv = torch.sum(dv * mf, dim=(-2, -1)) / denom
    cu = torch.clamp(torch.round(mean_du), -center_bound, center_bound)
    cv = torch.clamp(torch.round(mean_dv), -center_bound, center_bound)
    return cu.to(torch.int32), cv.to(torch.int32)


def residual_displacements(
    u, v, cu, cv, radius: int, grid_stride: int, image_h: int, image_w: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Centre-relative displacements and validity for a given recentring.

    -> (du, dv (B, H', W') f32, valid): inside the ball around (cu, cv)
    and bilinear-in-bounds in the source image.
    """
    du, dv = _grid_displacements(u, v, grid_stride)
    du = du - cu[..., None, None].to(torch.float32)
    dv = dv - cv[..., None, None].to(torch.float32)
    in_ball = (du > -radius) & (du < radius) & (dv > -radius) & (dv < radius)
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    in_bounds = (
        (x0 >= 0) & (y0 >= 0) & (x0 + 1 <= image_w - 1) & (y0 + 1 <= image_h - 1)
    )
    return du, dv, in_ball & in_bounds


def extract_parity_planes(
    image: torch.Tensor,
    cu: torch.Tensor,
    cv: torch.Tensor,
    grid_hp: int,
    grid_wp: int,
    radius: int,
    grid_stride: int = 1,
) -> torch.Tensor:
    """Recentred window + parity split: image (B, H, W), cu/cv (B,) ->
    planes (B, s^2, 2r//s + H', 2r//s + W') f32.

    ``window[p + k] == image[p + c + k]`` for |k| <= r, zero outside the
    image and outside the window's full-resolution support.
    """
    s = grid_stride
    b = image.shape[0]
    win_h = (grid_hp - 1) * s + 1 + 2 * radius
    win_w = (grid_wp - 1) * s + 1 + 2 * radius
    ph = (2 * radius) // s + grid_hp
    pw = (2 * radius) // s + grid_wp
    pad = 5 * radius + s
    padded = F.pad(image.to(torch.float32)[:, None], (pad, pad, pad, pad))[:, 0]
    dev = image.device
    # Window row a = s*m + p of plane p*s + q reads image row cv + a - r.
    a = (
        s * torch.arange(ph, device=dev)[None, :]
        + torch.arange(s, device=dev)[:, None]
    )  # (s, ph)
    c = (
        s * torch.arange(pw, device=dev)[None, :]
        + torch.arange(s, device=dev)[:, None]
    )  # (s, pw)
    rows = pad - radius + cv.to(torch.int64)[:, None, None] + a[None]  # (B, s, ph)
    cols = pad - radius + cu.to(torch.int64)[:, None, None] + c[None]  # (B, s, pw)
    hp_pad, wp_pad = padded.shape[-2], padded.shape[-1]
    flat = padded.reshape(b, hp_pad * wp_pad)
    # (B, s_row, s_col, ph, pw) flat indices.
    idx = rows[:, :, None, :, None] * wp_pad + cols[:, None, :, None, :]
    vals = torch.gather(flat, 1, idx.reshape(b, -1)).reshape(b, s, s, ph, pw)
    inside = (a < win_h)[:, None, :, None] & (c < win_w)[None, :, None, :]
    vals = torch.where(inside[None], vals, torch.zeros_like(vals))
    return vals.reshape(b, s * s, ph, pw)


def prepare_shift_stack(
    image: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    radius: int,
    grid_stride: int,
    coord_mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Recentring, window extraction and parity split ahead of the stack
    kernel: image (B, H, W), u, v (B, H', W') -> (planes (B, s^2, ph, pw),
    du, dv (B, H', W') centre-relative displacements, valid)."""
    if radius < 1:
        raise ValueError("radius must be >= 1")
    if grid_stride < 1:
        raise ValueError(f"grid_stride must be >= 1, got {grid_stride}")
    h, w = image.shape[-2], image.shape[-1]
    hp, wp = u.shape[-2], u.shape[-1]
    cu, cv = compute_recenter(u, v, radius, grid_stride, coord_mask)
    du, dv, valid = residual_displacements(u, v, cu, cv, radius, grid_stride, h, w)
    planes = extract_parity_planes(image, cu, cv, hp, wp, radius, grid_stride)
    return planes, du, dv, valid


def tent_sample(
    planes: torch.Tensor,
    du: torch.Tensor,
    dv: torch.Tensor,
    radius: int,
    grid_stride: int,
    layout: Optional[WindowLayout] = None,
) -> torch.Tensor:
    """Tent-tap accumulation over the frozen window: planes (B, s^2, ph, pw),
    centre-relative displacements du, dv (B, H', W') -> (B, H', W').  With
    ``layout`` (blocks or tiles) planes are (B, blocks, s^2, ph, pw), each
    pixel is sampled from its block's window at its place in the block, and
    the vertical taps reach ``layout.radius_y``.

    The plain version of the kernels' sampling (``csrc/dvo_common.cuh``):
    the (2r_y+1)(2r+1)-tap sweep of the TPU kernels has at most four non-zero
    taps, at floor(d) and floor(d) + 1 on each axis; those are gathered
    from the parity planes and added in the sweep's order (rows ascending;
    within a row by column-parity plane, then by column: the second tap,
    b0 + 1, comes first exactly where s >= 2 and b0 = r + floor(du) lies in
    plane s - 1).  Taps
    outside [-r_y, r_y] x [-r, r] carry no weight; a NaN displacement gives
    NaN.
    """
    s = grid_stride
    b = planes.shape[0]
    ph, pw = planes.shape[-2], planes.shape[-1]
    hp, wp = du.shape[-2], du.shape[-1]
    dev = planes.device
    rx = radius
    ry = radius if layout is None else layout.radius_y
    flat = planes.reshape(b, -1)
    if layout is None or layout.blocks == 1:
        base = torch.zeros((), dtype=torch.int64, device=dev)
        ii = torch.arange(hp, device=dev)[None, :, None]
        jj = torch.arange(wp, device=dev)[None, None, :]
    else:
        blk, il, jl = block_index(layout, hp, wp, dev)
        base = (blk * (s * s * ph * pw))[None]
        ii, jj = il[None, :, None], jl[None, None, :]
    fy = torch.floor(dv)
    fx = torch.floor(du)
    # Integer taps, clamped so that out-of-range (or non-finite) ones index
    # safely; their terms are dropped below.
    ky0 = torch.clamp(torch.nan_to_num(fy), -ry - 1, ry + 1).to(torch.int64)
    kx0 = torch.clamp(torch.nan_to_num(fx), -rx - 1, rx + 1).to(torch.int64)

    def terms(ky, kyf):
        have_y = (kyf >= -ry) & (kyf <= ry)
        wy = torch.clamp(1.0 - torch.abs(dv - kyf), min=0.0)
        a = torch.clamp(ry + ky, 0, 2 * ry)
        out = []
        for t in range(2):
            kx = kx0 + t
            kxf = fx + float(t)
            have = have_y & (kxf >= -rx) & (kxf <= rx)
            wx = torch.clamp(1.0 - torch.abs(du - kxf), min=0.0)
            bb = torch.clamp(rx + kx, 0, 2 * rx)
            plane = (a % s) * s + bb % s
            idx = base + (plane * ph + (a // s + ii)) * pw + (bb // s + jj)
            val = torch.gather(flat, 1, idx.reshape(b, -1)).reshape(b, hp, wp)
            term = (wy * wx) * val
            out.append((have, term))
        return out

    acc = torch.zeros_like(du)
    swap = (s >= 2) & ((rx + kx0) % s == s - 1)
    for t in range(2):
        (h0, t0), (h1, t1) = terms(ky0 + t, fy + float(t))
        first_h = torch.where(swap, h1, h0)
        first = torch.where(swap, t1, t0)
        second_h = torch.where(swap, h0, h1)
        second = torch.where(swap, t0, t1)
        acc = torch.where(first_h, acc + first, acc)
        acc = torch.where(second_h, acc + second, acc)
    nan = torch.isnan(du) | torch.isnan(dv)
    return torch.where(nan, torch.full_like(acc, float("nan")), acc)
