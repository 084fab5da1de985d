"""Per-site image quality-control statistics.

Counterpart: ``tmlibrary_tpu/ops/qc.py`` (``saturation_fraction``,
``background_level``, ``focus_tenengrad``, ``laplacian_variance``,
``site_qc_stats``): cheap statistics of the *raw* channel image, computed
beside the jterator batch.  They only read the pipeline's inputs, so the
pipeline's outputs are the same with QC on and off.

Every function takes a batch ``(B, H, W)`` and returns ``(B,)`` float32.
``saturation_frac`` is a count times the reciprocal of the pixel count,
exact on either device; the other three are means, whose summation
order differs from XLA's, and are held by ``chip_smoke.QC_TIERS``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

#: uint16 sensor ceiling: pixels at or above it count as saturated
SATURATION_LEVEL = 65535.0

#: block edge (pixels) of the background block-mean grid
BACKGROUND_BLOCK = 8

#: the statistics :func:`site_qc_stats` returns, in a stable order
QC_IMAGE_METRICS = (
    "saturation_frac",
    "background",
    "focus_tenengrad",
    "laplacian_var",
)


def _site_mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(-2, -1))


def saturation_fraction(img: torch.Tensor, level: float = SATURATION_LEVEL) -> torch.Tensor:
    """Fraction of each site's pixels at or above ``level``: the exact
    count times the float32 reciprocal of the pixel count, which is how
    XLA-CPU evaluates the reference's mean (a division by a constant
    becomes a multiplication by its reciprocal)."""
    img = img.to(torch.float32)
    count = (img >= level).sum(dim=(-2, -1)).to(torch.float32)
    recip = np.float32(1.0) / np.float32(img.shape[-2] * img.shape[-1])
    return count * torch.tensor(recip, device=img.device)


def background_level(img: torch.Tensor, block: int = BACKGROUND_BLOCK) -> torch.Tensor:
    """Minimum of each site's ``block`` x ``block`` tile means; the image is
    cropped to whole tiles, and a site smaller than one tile gives its
    mean."""
    img = img.to(torch.float32)
    b, h, w = img.shape
    bh, bw = (h // block) * block, (w // block) * block
    if bh == 0 or bw == 0:
        return _site_mean(img)
    tiles = img[:, :bh, :bw].reshape(b, bh // block, block, bw // block, block)
    return tiles.mean(dim=(2, 4)).amin(dim=(1, 2))


def _edge_padded(img: torch.Tensor) -> torch.Tensor:
    return F.pad(img[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]


def focus_tenengrad(img: torch.Tensor) -> torch.Tensor:
    """Mean squared Sobel gradient magnitude over ``mean(img)**2 + 1``
    (Sobel by shifted slices of the edge-padded image)."""
    img = img.to(torch.float32)
    p = _edge_padded(img)
    gx = (p[:, :-2, 2:] + 2.0 * p[:, 1:-1, 2:] + p[:, 2:, 2:]
          - p[:, :-2, :-2] - 2.0 * p[:, 1:-1, :-2] - p[:, 2:, :-2])
    gy = (p[:, 2:, :-2] + 2.0 * p[:, 2:, 1:-1] + p[:, 2:, 2:]
          - p[:, :-2, :-2] - 2.0 * p[:, :-2, 1:-1] - p[:, :-2, 2:])
    denom = _site_mean(img) ** 2 + 1.0
    return _site_mean(gx * gx + gy * gy) / denom


def laplacian_variance(img: torch.Tensor) -> torch.Tensor:
    """Population variance of the 4-neighbour Laplacian over
    ``mean(img)**2 + 1``."""
    img = img.to(torch.float32)
    p = _edge_padded(img)
    lap = p[:, :-2, 1:-1] + p[:, 2:, 1:-1] + p[:, 1:-1, :-2] + p[:, 1:-1, 2:] - 4.0 * img
    centred = lap - _site_mean(lap)[:, None, None]
    denom = _site_mean(img) ** 2 + 1.0
    return _site_mean(centred * centred) / denom


def site_qc_stats(img: torch.Tensor) -> dict[str, torch.Tensor]:
    """Every statistic of :data:`QC_IMAGE_METRICS` for a raw channel batch
    ``(B, H, W)``; a z-stack channel ``(B, Z, H, W)`` is max-projected over
    ``Z`` first."""
    img = img.to(torch.float32)
    if img.dim() == 4:
        img = img.amax(dim=1)
    return {
        "saturation_frac": saturation_fraction(img),
        "background": background_level(img),
        "focus_tenengrad": focus_tenengrad(img),
        "laplacian_var": laplacian_variance(img),
    }
