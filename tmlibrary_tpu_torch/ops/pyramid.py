"""Pyramid tiling ops (illuminati).

Counterpart: ``tmlibrary_tpu/ops/pyramid.py`` (``downsample_2x``,
``pyramid_levels``, ``n_pyramid_levels``, ``cut_tiles``, ``to_uint8``),
reference ``tmlib/workflow/illuminati/api.py`` ``PyramidBuilder``: level
0 is the corrected, aligned and stitched well mosaic; each higher level
is the 2x2 mean of the one below (odd trailing rows and columns
edge-padded first), until the image fits one 256-px tile; each level is
stretched to uint8 and cut into tiles on the host.

Bit-exact against the reference on either device: each 2x2 window is
summed in the order XLA-CPU's ``reduce_window`` takes, then divided by 4
(a power of two, so exact); ``to_uint8`` divides by a tensor
(``_exact.div``).  That order depends on the level's width: where the
output width is a power of two it is ``(a00 + a01) + (a10 + a11)``,
otherwise ``((a00 + a01) + a10) + a11`` (measured on every output width
from 1 to 8192 tried, any height).  ``avg_pool2d`` is not used: its
summation order on the card is not the reference's.  The reference takes the
pyramid's dtype from its config (``compute_dtype``, float32 by default);
the port computes in float32, the dtype the order above was measured in.
"""

from __future__ import annotations

import numpy as np
import torch

from tmlibrary_tpu_torch.ops import _exact

TILE_SIZE = 256


def downsample_2x(img: torch.Tensor) -> torch.Tensor:
    """2x2 mean over the last two axes of ``(..., H, W)``; an odd trailing
    row or column is edge-padded first, so each side halves rounding up."""
    img = img.to(torch.float32)
    if img.shape[-2] % 2:
        img = torch.cat([img, img[..., -1:, :]], dim=-2)
    if img.shape[-1] % 2:
        img = torch.cat([img, img[..., -1:]], dim=-1)
    top = img[..., 0::2, 0::2] + img[..., 0::2, 1::2]
    width = img.shape[-1] // 2
    if width & (width - 1) == 0:  # XLA-CPU's order: see the module docstring
        summed = top + (img[..., 1::2, 0::2] + img[..., 1::2, 1::2])
    else:
        summed = (top + img[..., 1::2, 0::2]) + img[..., 1::2, 1::2]
    return summed / 4.0


def n_pyramid_levels(height: int, width: int) -> int:
    """Level count of :func:`pyramid_levels` for an image of this size:
    the native level and one per halving until it fits one tile."""
    n, h, w = 1, height, width
    while max(h, w) > TILE_SIZE:
        h, w = (h + 1) // 2, (w + 1) // 2
        n += 1
    return n


def pyramid_levels(mosaic: torch.Tensor, n_levels: int | None = None) -> list[torch.Tensor]:
    """The level chain, native level first; ``n_levels=None`` builds until
    the image fits in one tile."""
    levels = [mosaic.to(torch.float32)]
    if n_levels is None:
        n_levels = n_pyramid_levels(*mosaic.shape[-2:])
    for _ in range(n_levels - 1):
        levels.append(downsample_2x(levels[-1]))
    return levels


def cut_tiles(level) -> dict[tuple[int, int], np.ndarray]:
    """Cut one level into 256-px tiles on the host; edge tiles are
    zero-padded to full size.  Keys are ``(row, col)`` tile indices."""
    if isinstance(level, torch.Tensor):
        level = level.cpu().numpy()
    level = np.asarray(level)
    h, w = level.shape
    tiles: dict[tuple[int, int], np.ndarray] = {}
    for ty in range(0, max(h, 1), TILE_SIZE):
        for tx in range(0, max(w, 1), TILE_SIZE):
            tile = level[ty : ty + TILE_SIZE, tx : tx + TILE_SIZE]
            if tile.shape != (TILE_SIZE, TILE_SIZE):
                full = np.zeros((TILE_SIZE, TILE_SIZE), level.dtype)
                full[: tile.shape[0], : tile.shape[1]] = tile
                tile = full
            tiles[(ty // TILE_SIZE, tx // TILE_SIZE)] = tile
    return tiles


def to_uint8(level: torch.Tensor, lower: float, upper: float) -> torch.Tensor:
    """Percentile stretch of ``[lower, upper]`` to the display range
    (reference ``ChannelImage.scale`` with corilla's clip percentiles)."""
    span = max(float(upper) - float(lower), 1e-6)
    x = level.to(torch.float32)
    lo = torch.tensor(float(lower), dtype=torch.float32, device=x.device)
    return torch.clamp(_exact.div(x - lo, span) * 255.0, 0, 255).to(torch.uint8)
