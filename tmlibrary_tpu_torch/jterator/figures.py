"""Host-side figure artifacts for pipeline debugging.

Counterpart: ``tmlibrary_tpu/jterator/figures.py:22-132`` (reference
``tmlib/workflow/jterator/handles.py`` ``Figure``): after a batch
persists, one segmentation overlay per object family and site (sites
layout) or per family and well (spatial layout, nearest-subsampled to at
most ``max_dim`` pixels a side): the intensity channel
percentile-stretched to 8 bits, object boundaries coloured by label id
on a golden-angle hue wheel.  The same numpy as the reference; the PNG
is written by the port's codec (:mod:`~tmlibrary_tpu_torch.io.png`)
instead of ``cv2.imwrite``, so the files' bytes differ and their decoded
pixels do not.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from tmlibrary_tpu_torch.io import png


def _stretch_u8(img: np.ndarray, p_lo: float = 1.0, p_hi: float = 99.0) -> np.ndarray:
    """Percentile contrast stretch to uint8."""
    img = np.asarray(img, np.float32)
    lo, hi = np.percentile(img, (p_lo, p_hi))
    if hi <= lo:
        hi = lo + 1.0
    return np.clip((img - lo) / (hi - lo) * 255.0, 0, 255).astype(np.uint8)


def _label_palette(n: int) -> np.ndarray:
    """``(n + 1, 3)`` BGR palette: background black, label ``i`` at hue
    ``i * 0.618... mod 1`` (saturation 0.85, value 1), channels truncated
    as ``int(x * 255)``."""
    out = np.zeros((n + 1, 3), np.uint8)
    if n == 0:
        return out
    h = (np.arange(1, n + 1, dtype=np.float64) * 0.618033988749895) % 1.0
    s, v = 0.85, 1.0
    sector = np.floor(h * 6.0)
    f = h * 6.0 - sector
    p = np.full_like(h, v * (1.0 - s))
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    ones = np.full_like(h, v)
    sector = sector.astype(np.int64) % 6
    r = np.choose(sector, [ones, q, p, p, t, ones])
    g = np.choose(sector, [t, ones, ones, q, p, p])
    b = np.choose(sector, [p, p, t, ones, ones, q])
    out[1:, 0] = (b * 255).astype(np.uint8)
    out[1:, 1] = (g * 255).astype(np.uint8)
    out[1:, 2] = (r * 255).astype(np.uint8)
    return out


def _boundaries(labels: np.ndarray) -> np.ndarray:
    """Foreground pixels with a 4-neighbour of another label."""
    lab = np.asarray(labels)
    edge = np.zeros(lab.shape, bool)
    edge[:-1, :] |= lab[:-1, :] != lab[1:, :]
    edge[1:, :] |= lab[1:, :] != lab[:-1, :]
    edge[:, :-1] |= lab[:, :-1] != lab[:, 1:]
    edge[:, 1:] |= lab[:, 1:] != lab[:, :-1]
    return edge & (lab > 0)


def segmentation_overlay(intensity: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """``(H, W, 3)`` BGR uint8: the stretched intensity, boundaries coloured."""
    base = _stretch_u8(intensity)
    img = np.stack([base, base, base], axis=-1)
    lab = np.asarray(labels, np.int64)
    n = int(lab.max()) if lab.size else 0
    if n > 0:
        edges = _boundaries(lab)
        img[edges] = _label_palette(n)[lab[edges]]
    return img


def write_mosaic_figure(figures_dir, objects_name: str, mosaic: np.ndarray,
                        labels: np.ndarray, shard: str, max_dim: int = 2048) -> Path:
    """One whole-well overlay, ``<objects>_<shard>.png``, the mosaic
    nearest-subsampled by ``ceil(max side / max_dim)`` first."""
    mosaic = np.asarray(mosaic)
    step = max(1, -(-max(mosaic.shape) // max_dim))
    overlay = segmentation_overlay(mosaic[::step, ::step], np.asarray(labels)[::step, ::step])
    out_dir = Path(figures_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    return png.write(out_dir / f"{objects_name}_{shard}.png", overlay)


def write_figures(figures_dir, objects_name: str, intensity_stack: np.ndarray,
                  label_stack: np.ndarray, site_indices: list[int]) -> list[Path]:
    """One overlay per site, ``<objects>_site<idx:05d>.png``, for
    ``(B, H, W)`` stacks aligned with ``site_indices``."""
    out_dir = Path(figures_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    return [
        png.write(out_dir / f"{objects_name}_site{site:05d}.png",
                  segmentation_overlay(intensity_stack[b], label_stack[b]))
        for b, site in enumerate(site_indices)
    ]
