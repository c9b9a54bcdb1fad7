"""Row-block and tile recentring of the frozen window.

Counterparts of the block and tile helpers of
``dense_visual_odometry_tpu/ops/pallas/stackwarp.py`` (``block_layout``
:231, ``compute_recenter_blocks`` :258, ``shift_coverage_blocks`` :312,
``extract_parity_planes_blocks`` :381, ``tile_layout`` :448, ``_tile_means``
:478, ``compute_recenter_tiles`` :497, ``shift_coverage_tiles`` :551,
``extract_parity_planes_tiles`` :630).  One window centre per element keeps
a pixel only while its displacement from the mean stays inside the ball;
under rotation the displacement spreads across the image.  Cutting the grid
into row blocks, or into a mosaic of 2-D tiles, gives each block its own
integer centre (the rounded mean displacement of its valid pixels, clipped),
so the ball covers only the spread within a block, and the vertical tap
radius may be smaller than the horizontal one.

The JAX package lays blocks out as a mosaic with halo rows and columns, so
that the TPU's uniform rolls never cross into a neighbour's window
(``slab_stack``, ``tile_stack``).  The port keeps the semantics, not the
mosaic: it extracts one window per block at that block's own centre,
(B, blocks, s^2, t_y + 2 r_y // s, t_x + 2 r // s) parity planes
(``shiftwarp.WindowLayout``), and samples each grid pixel from its block's
window at its place in the block (``shiftwarp.tent_sample``, the kernels'
``dvo::tent_sample``).

A level's centres are one value, :class:`Blocks` (one centre, row blocks or
tiles); :func:`window_centres`, :func:`window_coverage` and
:func:`window_planes` take it and call the one-centre, row-block or tile
function (:func:`window_planes` is the counterpart of both extraction
functions).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from dense_visual_odometry_torch.ops.shiftwarp import (
    WindowLayout,
    _grid_displacements,
    block_layout,
    compute_recenter,
    extract_parity_planes,
    shift_coverage,
    tile_layout,
    window_layout,
)


class Blocks(NamedTuple):
    """Where a level's window centres sit: one per element (the default),
    one per row block (``n_blocks`` > 1), or one per 2-D tile
    (``n_blocks_x`` > 1: ``n_blocks`` x ``n_blocks_x``).  ``radius_y``: the
    vertical tap radius of blocks and tiles (None: the horizontal one);
    ``center_bound``: the clip of the tiles' centres (None: 4 max(r, r_y))."""

    n_blocks: int = 1
    n_blocks_x: int = 1
    radius_y: Optional[int] = None
    center_bound: Optional[int] = None

    @property
    def tiles(self) -> bool:
        return self.n_blocks_x > 1

    @property
    def rows(self) -> bool:
        return not self.tiles and self.n_blocks > 1


ONE_CENTRE = Blocks()


def _mask(u: torch.Tensor, coord_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if coord_mask is None:
        return torch.ones_like(u)
    return coord_mask.to(torch.float32)


def _clip_round(mean: torch.Tensor, center_bound: int) -> torch.Tensor:
    """Half to even, clipped to +-``center_bound``, as int32."""
    return torch.clamp(torch.round(mean), -center_bound, center_bound).to(torch.int32)


def _row_blocks(x: torch.Tensor, nblk: int, t: int) -> torch.Tensor:
    """(..., H', W') zero-padded to nblk*t rows -> (..., nblk, t, W')."""
    pad = nblk * t - x.shape[-2]
    return F.pad(x, (0, 0, 0, pad)).reshape(x.shape[:-2] + (nblk, t, x.shape[-1]))


def compute_recenter_blocks(
    u: torch.Tensor,
    v: torch.Tensor,
    radius: int,
    grid_stride: int,
    n_blocks: int,
    coord_mask: Optional[torch.Tensor] = None,
    radius_y: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row-block centres: u, v (B, H', W') -> cu, cv (B, blocks) int32,
    each the masked mean displacement of its rows, rounded half to even;
    blocks with fewer than 8 valid pixels take the global mean; clipped to
    +-4 max(r, r_y).  The sums follow the JAX package's axes."""
    ry = radius if radius_y is None else radius_y
    nblk, t, _ = block_layout(u.shape[-2], n_blocks, ry, grid_stride)
    du, dv = _grid_displacements(u, v, grid_stride)
    mf = _mask(u, coord_mask)
    dub = _row_blocks(du * mf, nblk, t)
    dvb = _row_blocks(dv * mf, nblk, t)
    mb = _row_blocks(mf, nblk, t)
    count = torch.sum(mb, dim=(-2, -1))
    denom = torch.clamp(count, min=1.0)
    mean_du = torch.sum(dub, dim=(-2, -1)) / denom
    mean_dv = torch.sum(dvb, dim=(-2, -1)) / denom
    gdenom = torch.clamp(torch.sum(count, dim=-1), min=1.0)
    gmean_du = torch.sum(dub, dim=(-3, -2, -1)) / gdenom
    gmean_dv = torch.sum(dvb, dim=(-3, -2, -1)) / gdenom
    enough = count >= 8.0
    mean_du = torch.where(enough, mean_du, gmean_du[..., None])
    mean_dv = torch.where(enough, mean_dv, gmean_dv[..., None])
    bound = 4 * max(radius, ry)
    return _clip_round(mean_du, bound), _clip_round(mean_dv, bound)


def shift_coverage_blocks(
    u: torch.Tensor,
    v: torch.Tensor,
    radius: int,
    grid_stride: int,
    n_blocks: int,
    coord_mask: Optional[torch.Tensor] = None,
    radius_y: Optional[int] = None,
) -> torch.Tensor:
    """(B,) fraction of the pixels of ``coord_mask`` that per-block centres
    keep inside the ball |du| < r, |dv| < r_y: what the hard-motion trigger
    judges at a row-block level."""
    ry = radius if radius_y is None else radius_y
    nblk, t, _ = block_layout(u.shape[-2], n_blocks, ry, grid_stride)
    cu, cv = compute_recenter_blocks(u, v, radius, grid_stride, n_blocks, coord_mask, ry)
    du, dv = _grid_displacements(u, v, grid_stride)
    dub = _row_blocks(du, nblk, t) - cu[..., None, None].to(torch.float32)
    dvb = _row_blocks(dv, nblk, t) - cv[..., None, None].to(torch.float32)
    mb = _row_blocks(_mask(u, coord_mask), nblk, t)
    in_ball = (dub > -radius) & (dub < radius) & (dvb > -ry) & (dvb < ry)
    kept = torch.sum(in_ball.to(torch.float32) * mb, dim=(-3, -2, -1))
    return kept / torch.clamp(torch.sum(mb, dim=(-3, -2, -1)), min=1.0)


def _tiles(x: torch.Tensor, nby: int, t_y: int, nbx: int, t_x: int) -> torch.Tensor:
    """(..., H', W') zero-padded to whole tiles -> (..., nby, t_y, nbx, t_x)."""
    pad_r = nby * t_y - x.shape[-2]
    pad_c = nbx * t_x - x.shape[-1]
    return F.pad(x, (0, pad_c, 0, pad_r)).reshape(x.shape[:-2] + (nby, t_y, nbx, t_x))


def _tile_means(vals, mask, nby, t_y, nbx, t_x):
    """Masked per-tile means (..., nby, nbx), their counts, and the global
    mean of (..., H', W') ``vals``, summed over the JAX package's axes."""
    vb = _tiles(vals * mask, nby, t_y, nbx, t_x)
    mb = _tiles(mask, nby, t_y, nbx, t_x)
    count = torch.sum(mb, dim=(-3, -1))
    mean = torch.sum(vb, dim=(-3, -1)) / torch.clamp(count, min=1.0)
    gdenom = torch.clamp(torch.sum(count, dim=(-2, -1)), min=1.0)
    gmean = torch.sum(vb, dim=(-4, -3, -2, -1)) / gdenom
    return mean, count, gmean


def compute_recenter_tiles(
    u: torch.Tensor,
    v: torch.Tensor,
    radius: int,
    grid_stride: int,
    n_blocks_y: int,
    n_blocks_x: int,
    coord_mask: Optional[torch.Tensor] = None,
    radius_y: Optional[int] = None,
    center_bound: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile centres: u, v (B, H', W') -> cu, cv (B, nby, nbx) int32, each
    the masked mean displacement of its tile, rounded half to even; tiles
    with fewer than 8 valid pixels take the global mean; clipped to
    +-``center_bound`` (default 4 max(r, r_y); ``recenter_center_bound``)."""
    ry = radius if radius_y is None else radius_y
    nby, t_y, _, nbx, t_x, _ = tile_layout(
        u.shape[-2], u.shape[-1], n_blocks_y, n_blocks_x, radius, ry, grid_stride)
    du, dv = _grid_displacements(u, v, grid_stride)
    mf = _mask(u, coord_mask)
    mean_du, count, gmean_du = _tile_means(du, mf, nby, t_y, nbx, t_x)
    mean_dv, _, gmean_dv = _tile_means(dv, mf, nby, t_y, nbx, t_x)
    enough = count >= 8.0
    mean_du = torch.where(enough, mean_du, gmean_du[..., None, None])
    mean_dv = torch.where(enough, mean_dv, gmean_dv[..., None, None])
    bound = 4 * max(radius, ry) if center_bound is None else center_bound
    return _clip_round(mean_du, bound), _clip_round(mean_dv, bound)


def shift_coverage_tiles(
    u: torch.Tensor,
    v: torch.Tensor,
    radius: int,
    grid_stride: int,
    n_blocks_y: int,
    n_blocks_x: int,
    coord_mask: Optional[torch.Tensor] = None,
    radius_y: Optional[int] = None,
    center_bound: Optional[int] = None,
) -> torch.Tensor:
    """(B,) fraction of the pixels of ``coord_mask`` that per-tile centres
    keep inside the ball: what the hard-motion trigger judges at a tile
    level."""
    ry = radius if radius_y is None else radius_y
    nby, t_y, _, nbx, t_x, _ = tile_layout(
        u.shape[-2], u.shape[-1], n_blocks_y, n_blocks_x, radius, ry, grid_stride)
    cu, cv = compute_recenter_tiles(u, v, radius, grid_stride, n_blocks_y, n_blocks_x,
                                    coord_mask, ry, center_bound)
    du, dv = _grid_displacements(u, v, grid_stride)
    dub = _tiles(du, nby, t_y, nbx, t_x) - cu[..., :, None, :, None].to(torch.float32)
    dvb = _tiles(dv, nby, t_y, nbx, t_x) - cv[..., :, None, :, None].to(torch.float32)
    mb = _tiles(_mask(u, coord_mask), nby, t_y, nbx, t_x)
    in_ball = (dub > -radius) & (dub < radius) & (dvb > -ry) & (dvb < ry)
    kept = torch.sum(in_ball.to(torch.float32) * mb, dim=(-4, -3, -2, -1))
    return kept / torch.clamp(torch.sum(mb, dim=(-4, -3, -2, -1)), min=1.0)


def extract_windows(
    image: torch.Tensor,
    cu: torch.Tensor,
    cv: torch.Tensor,
    layout: WindowLayout,
    grid_stride: int,
) -> torch.Tensor:
    """One window per block at the block's own centre: image (B, H, W),
    cu / cv (B, blocks) int -> planes (B, blocks, s^2, ph, pw) f32.

    Plane ``p*s + q`` of block ``(k, l)`` holds at [m, n] the image at row
    ``s (k t_y + m) + p + cv - r_y`` and column ``s (l t_x + n) + q + cu - r``
    (zero outside the image): for the grid pixel (i, j) of the block, tap
    (ky, kx) of the sweep reads image[s i + cv + ky, s j + cu + kx].  One
    indexing over every block and batch element."""
    s = grid_stride
    b, h, w = image.shape
    dev = image.device
    nblk = layout.blocks
    cu = cu.reshape(b, nblk).to(torch.int64)
    cv = cv.reshape(b, nblk).to(torch.int64)
    t = torch.arange(nblk, device=dev)
    k, l = t // layout.nbx, t % layout.nbx
    # Window rows / columns of each parity: s*m + p (s, ph) and s*n + q (s, pw).
    a = s * torch.arange(layout.ph, device=dev)[None, :] + torch.arange(s, device=dev)[:, None]
    c = s * torch.arange(layout.pw, device=dev)[None, :] + torch.arange(s, device=dev)[:, None]
    rows = (s * layout.t_y * k - layout.radius_y)[None, :, None, None] + cv[:, :, None, None] \
        + a[None, None]  # (B, blocks, s, ph)
    cols = (s * layout.t_x * l - layout.radius)[None, :, None, None] + cu[:, :, None, None] \
        + c[None, None]  # (B, blocks, s, pw)
    rows = rows[:, :, :, None, :, None]
    cols = cols[:, :, None, :, None, :]
    inside = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    bidx = torch.arange(b, device=dev)[:, None, None, None, None, None]
    vals = image.to(torch.float32)[bidx, rows.clamp(0, h - 1), cols.clamp(0, w - 1)]
    vals = torch.where(inside, vals, torch.zeros_like(vals))
    return vals.reshape(b, nblk, s * s, layout.ph, layout.pw).contiguous()


def window_centres(u, v, radius: int, grid_stride: int, coord_mask: torch.Tensor,
                   blocks: Blocks = ONE_CENTRE) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int32 centres of ``blocks``' windows: (B,) with one centre
    (``shiftwarp.compute_recenter``), (B, blocks) with row blocks, (B, nby,
    nbx) with tiles."""
    if blocks.tiles:
        return compute_recenter_tiles(u, v, radius, grid_stride, blocks.n_blocks,
                                      blocks.n_blocks_x, coord_mask, blocks.radius_y,
                                      blocks.center_bound)
    if blocks.rows:
        return compute_recenter_blocks(u, v, radius, grid_stride, blocks.n_blocks, coord_mask,
                                       blocks.radius_y)
    return compute_recenter(u, v, radius, grid_stride, coord_mask)


def window_coverage(u, v, radius: int, grid_stride: int, coord_mask: torch.Tensor,
                    blocks: Blocks = ONE_CENTRE) -> torch.Tensor:
    """(B,) fraction of the pixels of ``coord_mask`` that ``blocks``'
    centres keep inside the ball: what the hard-motion trigger judges."""
    if blocks.tiles:
        return shift_coverage_tiles(u, v, radius, grid_stride, blocks.n_blocks,
                                    blocks.n_blocks_x, coord_mask, blocks.radius_y,
                                    blocks.center_bound)
    if blocks.rows:
        return shift_coverage_blocks(u, v, radius, grid_stride, blocks.n_blocks, coord_mask,
                                     blocks.radius_y)
    return shift_coverage(u, v, radius, grid_stride, coord_mask)


def window_planes(image: torch.Tensor, cu: torch.Tensor, cv: torch.Tensor, grid_hp: int,
                  grid_wp: int, radius: int, grid_stride: int,
                  blocks: Blocks = ONE_CENTRE) -> torch.Tensor:
    """The windows of ``image`` around :func:`window_centres`' centres:
    (B, s^2, ph, pw) with one centre (``shiftwarp.extract_parity_planes``),
    else (B, blocks, s^2, ph, pw) (:func:`extract_windows`)."""
    if blocks.tiles or blocks.rows:
        layout = window_layout(grid_hp, grid_wp, radius, grid_stride, blocks.n_blocks,
                               blocks.n_blocks_x, blocks.radius_y)
        return extract_windows(image, cu, cv, layout, grid_stride)
    return extract_parity_planes(image, cu, cv, grid_hp, grid_wp, radius, grid_stride)
