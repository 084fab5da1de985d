"""Thresholding ops.

Counterpart: ``tmlibrary_tpu/ops/threshold.py:19-140``
(``threshold_manual``, ``otsu_value``, ``_otsu_argmax``,
``threshold_otsu``).  Every function takes a batch ``(B, H, W)`` and
thresholds each site on its own.

The Otsu cut decides every mask, so it must be bit-exact: the
normalisation and bin-centre expressions are evaluated op by op in
float32 (true divisions, see :mod:`._exact`), the histogram counts are
integers, and the between-class variance uses a cumulative sum in
XLA-CPU's order — the same cut as the JAX reference, on the CPU and on
the card.
"""

from __future__ import annotations

import torch

from tmlibrary_tpu_torch.ops._exact import cumsum_xla_cpu, div
from tmlibrary_tpu_torch.ops.histogram import histogram_fixed_bins


def threshold_manual(img: torch.Tensor, value) -> torch.Tensor:
    """Fixed global threshold (reference ``jtmodules/threshold_manual``)."""
    return img > value


def _site_min_max(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    flat = img.reshape(img.shape[0], -1)
    return flat.amin(dim=1), flat.amax(dim=1)


def otsu_value(img: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """Per-site Otsu threshold over a fixed-bin histogram → ``(B,)``."""
    img_f = img.to(torch.float32)
    lo, hi = _site_min_max(img_f)
    span = torch.clamp(hi - lo, min=1e-6)
    b = (slice(None),) + (None,) * (img_f.dim() - 1)
    scaled = div(img_f - lo[b], span[b]) * bins
    idx = torch.clamp(scaled.to(torch.int32), 0, bins - 1)
    hist = histogram_fixed_bins(idx, bins)
    steps = div(torch.arange(bins, dtype=torch.float32, device=img_f.device) + 0.5, bins)
    centers = lo[:, None] + steps[None, :] * span[:, None]
    return _otsu_argmax(hist, centers)


def _otsu_argmax(hist: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Between-class-variance argmax over ``(B, bins)`` histograms."""
    w0 = cumsum_xla_cpu(hist)
    w1 = w0[:, -1:] - w0
    sum0 = cumsum_xla_cpu(hist * centers)
    mu0 = div(sum0, torch.clamp(w0, min=1e-12))
    mu1 = div(sum0[:, -1:] - sum0, torch.clamp(w1, min=1e-12))
    d = mu0 - mu1
    between = w0 * w1 * (d * d)
    between = torch.where((w0 > 0) & (w1 > 0), between, torch.full_like(between, -1.0))
    k = torch.argmax(between, dim=1)  # first maximum, like jnp.argmax
    return centers.gather(1, k[:, None])[:, 0]


def threshold_otsu(
    img: torch.Tensor, bins: int = 256, correction_factor: float = 1.0
) -> torch.Tensor:
    """Otsu global threshold per site; ``correction_factor`` scales the cut."""
    img_f = img.to(torch.float32)
    t = otsu_value(img_f, bins=bins) * correction_factor
    return img_f > t.reshape((-1,) + (1,) * (img_f.dim() - 1))
