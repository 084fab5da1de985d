"""Spatial sharding with halo exchange for mosaic-scale images.

Counterpart: ``tmlibrary_tpu/parallel/halo.py:28-291``.  A mosaic too
large for one device is cut into row bands (a one-axis mesh) or tiles (a
``rows x cols`` mesh), one per rank; neighbourhood ops stay exact at the
seams because each rank extends its block with ``halo`` rows (and
columns) of its neighbours before the op and crops them off after.  At
the mosaic's outer border the halo is the block's own edge reflected
(numpy ``mode='symmetric'``, the scipy boundary the ops use), so the
assembled result is bit-identical to the single-device op on the whole
image.  Corners of a tile come with no extra exchange: the rows are
exchanged first, and the column exchange then ships edge columns that
already carry the neighbours' halo rows.

The ``*_block`` functions take and return this rank's block alone, so a
chain of them (the spatial layout's smoothing, Otsu's cut, labeling and
watershed) keeps each intermediate sharded, and :func:`gather_blocks`
assembles the result once, on every rank or on one.  The reference's
names take the full image (the same on every rank, as the reference
takes a global array) and return the full result on every member rank.
The edge bands travel by ``all_gather`` over the mesh's group.  A block with fewer rows (or
columns) than the halo raises :class:`ShardingError`: the reference's
exchange cannot fill such a halo either.  A mesh of one rank calls the
single-device op on the whole image.
"""

from __future__ import annotations

import torch

from tmlibrary_tpu_torch.errors import ShardingError
from tmlibrary_tpu_torch.ops.pyramid import downsample_2x, n_pyramid_levels
from tmlibrary_tpu_torch.ops.smooth import gaussian_radius, gaussian_smooth
from tmlibrary_tpu_torch.parallel import distributed
from tmlibrary_tpu_torch.parallel.mesh import Mesh


def gather_blocks(block: torch.Tensor, mesh: Mesh, h: int, w: int,
                  dst: int | None = None) -> "torch.Tensor | None":
    """The full ``(..., h, w)`` image from every rank's block: on every
    rank, or with ``dst`` on that rank alone (None on the others)."""
    if mesh.size == 1:
        return block
    if dst is None:
        parts = distributed.all_gather(block, mesh.group)
    else:
        parts = distributed.gather_to(block, dst, mesh.group)
        if parts is None:
            return None
    out = torch.empty(tuple(block.shape[:-2]) + (h, w), dtype=block.dtype,
                      device=block.device)
    for r, part in enumerate(parts):
        ys, xs = mesh.block_slices(h, w, r)
        out[..., ys, xs] = part
    return out


def exchange_edges(lo: torch.Tensor, hi: torch.Tensor, mesh: Mesh, axis: int):
    """``(from_prev, from_next)``: the previous neighbour's ``hi`` band and
    the next neighbour's ``lo`` band along mesh ``axis`` (0 rows, 1
    columns), None where the mesh ends."""
    if mesh.size == 1:
        return None, None
    parts = distributed.all_gather(torch.stack([lo, hi]), mesh.group)
    r, c = mesh.coords()
    prev = mesh.rank_at(r - 1, c) if axis == 0 else mesh.rank_at(r, c - 1)
    nxt = mesh.rank_at(r + 1, c) if axis == 0 else mesh.rank_at(r, c + 1)
    return (None if prev is None else parts[prev][1],
            None if nxt is None else parts[nxt][0])


def halo_exchange(block: torch.Tensor, halo: int, mesh: Mesh, axis: int = 0) -> torch.Tensor:
    """``block`` extended by ``halo`` rows (``axis=0``) or columns
    (``axis=1``) of its neighbours, its own edge reflected where the
    mesh ends."""
    if halo == 0:
        return block
    dim = block.dim() - 2 + axis
    n = block.shape[dim]
    if n < halo:
        raise ShardingError(f"a block of {n} {'rows' if axis == 0 else 'columns'} cannot "
                            f"hold a halo of {halo}")
    lo, hi = block.narrow(dim, 0, halo), block.narrow(dim, n - halo, halo)
    from_prev, from_next = exchange_edges(lo, hi, mesh, axis)
    top = lo.flip(dim) if from_prev is None else from_prev
    bottom = hi.flip(dim) if from_next is None else from_next
    return torch.cat([top, block, bottom], dim=dim)


def halo_map_block(fn, block: torch.Tensor, mesh: Mesh, halo: int) -> torch.Tensor:
    """``fn`` (a neighbourhood op reaching at most ``halo`` pixels, which
    returns its input's shape) over this rank's block of an image sharded
    on ``mesh``, exact at the seams: ``fn`` gets the block extended by
    ``halo`` rows, and by ``halo`` columns too on a ``rows x cols`` mesh,
    and the extension is cropped off its result."""
    tiles = mesh.grid[1] > 1
    ext = halo_exchange(block, halo, mesh, 0)
    if tiles:
        ext = halo_exchange(ext, halo, mesh, 1)
    out = fn(ext)
    if halo:
        out = out[..., halo:-halo, :]
        if tiles:
            out = out[..., halo:-halo]
    return out


def sharded_halo_map(fn, image: torch.Tensor, mesh: Mesh, halo: int) -> torch.Tensor:
    """:func:`halo_map_block` over a full image, gathered on every member
    rank.  The image's sides must divide the mesh."""
    h, w = image.shape[-2:]
    mesh.check_divides(h, w)
    return gather_blocks(halo_map_block(fn, mesh.block(image), mesh, halo), mesh, h, w)


def gaussian_smooth_block(block: torch.Tensor, mesh: Mesh, sigma: float) -> torch.Tensor:
    """Gaussian blur of this rank's block (rows or tiles), bit-identical
    to the block of
    :func:`~tmlibrary_tpu_torch.ops.smooth.gaussian_smooth` on the whole
    image, edges included."""
    if mesh.size == 1:
        return gaussian_smooth(block, sigma)
    return halo_map_block(lambda ext: gaussian_smooth(ext, sigma), block, mesh,
                          gaussian_radius(sigma))


def sharded_gaussian_smooth(image: torch.Tensor, mesh: Mesh, sigma: float) -> torch.Tensor:
    """:func:`gaussian_smooth_block` over a full image, gathered on every
    member rank."""
    h, w = image.shape[-2:]
    mesh.check_divides(h, w)
    return gather_blocks(gaussian_smooth_block(mesh.block(image), mesh, sigma), mesh, h, w)


#: the reference's names for the tile mesh: one function serves both
sharded_halo_map_2d = sharded_halo_map
sharded_gaussian_smooth_2d = sharded_gaussian_smooth


def sharded_downsample_2x(image: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Row-sharded 2x2 mean (a pyramid level step); each rank's rows must
    be even, so no window straddles a seam."""
    h, w = image.shape[-2:]
    n = mesh.size
    if h % n or (h // n) % 2:
        raise ShardingError(f"rows {h} must split into even-sized shards over {n} devices")
    if n == 1:
        return downsample_2x(image)
    return gather_blocks(downsample_2x(mesh.block(image)), mesh, h // 2, (w + 1) // 2)


def sharded_pyramid_levels(mosaic: torch.Tensor, mesh: Mesh,
                           n_levels: int | None = None) -> list[torch.Tensor]:
    """The pyramid's level chain over a row-sharded mosaic, bit-identical
    to :func:`~tmlibrary_tpu_torch.ops.pyramid.pyramid_levels`: a level
    is computed sharded while the ranks' rows stay even, and the small
    tail levels on the whole image (the reference's fallback)."""
    levels = [mosaic.to(torch.float32)]
    if n_levels is None:
        n_levels = n_pyramid_levels(*mosaic.shape[-2:])
    n = mesh.size
    for _ in range(n_levels - 1):
        cur = levels[-1]
        h = cur.shape[-2]
        if h % n == 0 and (h // n) % 2 == 0:
            levels.append(sharded_downsample_2x(cur, mesh))
        else:
            levels.append(downsample_2x(cur))
    return levels
