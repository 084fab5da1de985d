"""Gaussian, box, median and bilateral smoothing.

Counterpart: ``tmlibrary_tpu/ops/smooth.py:21-176`` (``gaussian_smooth``,
matching ``scipy.ndimage.gaussian_filter``, ``uniform_smooth``'s XLA
taps, matching ``uniform_filter``, ``median_smooth`` and
``bilateral_smooth`` over a symmetric-padded window).  Separable correlation with
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

import math

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
    return _mirror(torch.arange(n, device=device) + offset, n)


def _mirror(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Indices beyond ``0 .. n - 1`` reflected back, the edge sample
    repeated."""
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


def _symmetric_pad(img: torch.Tensor, r: int) -> torch.Tensor:
    """``(..., H + 2r, W + 2r)``: the last two axes padded by ``r``,
    mirrored with the edge sample repeated (numpy ``mode='symmetric'``)."""
    h, w = img.shape[-2:]
    if r > min(h, w):
        raise ValueError(f"window radius {r} exceeds image size {min(h, w)}")
    out = img
    for dim, n in ((-2, h), (-1, w)):
        out = out.index_select(dim, _mirror(torch.arange(-r, n + r, device=img.device), n))
    return out


def _window_stack(img: torch.Tensor, size: int) -> torch.Tensor:
    """The ``size * size`` symmetric-padded neighbourhood of every pixel
    of ``(..., H, W)`` as ``(..., H, W, size * size)``, row offsets
    outer: two ``unfold`` views of the padded image, copied once."""
    win = _symmetric_pad(img, size // 2).unfold(-2, size, 1).unfold(-2, size, 1)
    return win.reshape(*img.shape, size * size)


def median_smooth(img: torch.Tensor, size: int) -> torch.Tensor:
    """Median over the odd ``size * size`` window of every pixel of
    ``(..., H, W)``, symmetric padding (``scipy.ndimage.median_filter``).
    A median of an odd count is one of the window's values, so it is
    exact on either device; a window holding NaN gives NaN, as
    ``jnp.median`` does."""
    if size % 2 != 1:
        raise ValueError("median filter size must be odd")
    return torch.median(_window_stack(img.to(torch.float32), size), dim=-1).values


def bilateral_smooth(
    img: torch.Tensor, size: int = 5, sigma_space: float = 2.0, sigma_range: float = 50.0
) -> torch.Tensor:
    """Bilateral filter of ``(..., H, W)``: each pixel the mean of its
    symmetric-padded ``size * size`` window weighted by
    ``exp(-(dy² + dx²) / (2 σs²)) * exp(-(v - centre)² / (2 σr²))``.

    The reference evaluates it in float32; the port evaluates the
    weights and both sums in float64, window offsets row by row, and
    rounds once, so the card and the CPU agree (their float32 ``exp``
    differ by ulps) and the result lies within
    ``chip_smoke.BILATERAL_TIER`` of the reference's."""
    img = img.to(torch.float32)
    r = size // 2
    h, w = img.shape[-2:]
    padded = _symmetric_pad(img, r).to(torch.float64)
    centre = img.to(torch.float64)
    two_var = torch.full((), 2.0 * float(sigma_range) ** 2, dtype=torch.float64,
                         device=img.device)
    num = torch.zeros_like(centre)
    den = torch.zeros_like(centre)
    for dy in range(size):
        for dx in range(size):
            w_space = math.exp(-((dy - r) ** 2 + (dx - r) ** 2) / (2.0 * float(sigma_space) ** 2))
            v = padded[..., dy : dy + h, dx : dx + w]
            d = v - centre
            weight = torch.exp(-(d * d) / two_var) * w_space
            num = num + weight * v
            den = den + weight
    return (num / torch.clamp(den, min=1e-12)).to(torch.float32)
