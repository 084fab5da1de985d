"""Gaussian and box smoothing.

Counterpart: ``tmlibrary_tpu/ops/smooth.py:21-125`` (``gaussian_smooth``,
matching ``scipy.ndimage.gaussian_filter``, and ``uniform_smooth``'s XLA
taps, matching ``uniform_filter``).  Separable correlation with
symmetric padding (scipy ``mode='reflect'``), accumulated in float32 as
``out = out + k[i] * shifted`` tap by tap.  (On the CPU the JAX package
sends ``uniform_smooth`` to a native box mean when its library is
loaded, which is only within a tolerance of the taps; the port
reproduces the taps, the path the TPU runs.)

Rounding: each multiply and each add is rounded separately (two PyTorch
ops), on the CPU and on the card alike.  The taps are computed on the
host in numpy float32, so they do not depend on the device's ``exp``.
That reproduces the JAX function run eagerly bit for bit; under ``jit``
XLA-CPU contracts the multiply-adds into FMAs and computes the taps with
its own ``exp``, so a jitted reference differs by an ulp or two.
"""

from __future__ import annotations

import numpy as np
import torch


def gaussian_radius(sigma: float, truncate: float = 4.0) -> int:
    """Kernel reach — ``int(truncate * sigma + 0.5)`` exactly as scipy."""
    return int(truncate * float(sigma) + 0.5)


def gaussian_taps(sigma: float, radius: int) -> np.ndarray:
    """Normalised float32 taps: ``exp(-0.5 (x/σ)²) / Σ``, the sum taken
    left to right in float32."""
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(np.float32(-0.5) * (x / np.float32(sigma)) ** 2)
    total = np.float32(0.0)
    for v in k:
        total = np.float32(total + v)
    return (k / total).astype(np.float32)


def _symmetric_index(n: int, offset: int, device) -> torch.Tensor:
    """Indices ``i + offset`` for ``i in range(n)``, mirrored at the edges
    with the edge sample repeated (numpy ``mode='symmetric'``)."""
    if abs(offset) > n:
        raise ValueError(f"kernel radius {abs(offset)} exceeds image size {n}")
    idx = torch.arange(n, device=device) + offset
    idx = torch.where(idx < 0, -idx - 1, idx)
    return torch.where(idx >= n, 2 * n - 1 - idx, idx)


def _correlate1d(img: torch.Tensor, taps: np.ndarray, dim: int, left: int | None = None) -> torch.Tensor:
    """``out = out + k[i] * shifted`` tap by tap; tap ``i`` reads offset
    ``i - left`` (``left`` defaults to the centre)."""
    r = taps.shape[0] // 2 if left is None else left
    n = img.shape[dim]
    out = torch.zeros_like(img)
    for i, k in enumerate(taps):
        shifted = img.index_select(dim, _symmetric_index(n, i - r, img.device))
        out = out + float(k) * shifted
    return out


def gaussian_smooth(
    img: torch.Tensor, sigma: float, truncate: float = 4.0
) -> torch.Tensor:
    """Separable Gaussian blur over the last two axes of ``(..., H, W)``."""
    taps = gaussian_taps(float(sigma), gaussian_radius(sigma, truncate))
    img = img.to(torch.float32)
    out = _correlate1d(img, taps, img.dim() - 2)
    return _correlate1d(out, taps, img.dim() - 1)


def uniform_smooth(img: torch.Tensor, size: int) -> torch.Tensor:
    """Separable box (mean) filter over the last two axes of ``(..., H,
    W)``, scipy ``uniform_filter`` centring (an even window's extra tap
    on the left), as the reference's XLA taps: every tap is
    ``float32(1 / size)``, rows then columns."""
    if size < 1:
        raise ValueError("size must be >= 1")
    taps = np.full((size,), 1.0 / size, dtype=np.float32)
    img = img.to(torch.float32)
    out = _correlate1d(img, taps, img.dim() - 2, left=size // 2)
    return _correlate1d(out, taps, img.dim() - 1, left=size // 2)
