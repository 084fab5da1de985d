"""Cycle-to-cycle image registration (the align step's numeric core).

Counterpart: ``tmlibrary_tpu/ops/registration.py`` (``phase_correlation``,
``phase_correlation_quality``, ``phase_correlation_subpixel``,
``batch_phase_correlation``, ``batch_phase_correlation_quality``,
``intersection_window``) and the align step's filter
(``tmlibrary_tpu/workflow/steps/align.py:63-70``), reference
``tmlib/workflow/align/registration.py``: the shift between two
acquisitions of a site by FFT phase correlation.

The JAX package leaves the FFTs to XLA, so ``torch.fft`` (cuFFT on the
card) ports them.  Every function takes ``(..., H, W)`` images and maps
over the leading axes.  Shifts are exact against the reference wherever
the correlation peak is unique (rolled content); the peak's height
(``quality``) and the subpixel refinement differ by the FFTs' rounding
and are held by ``chip_smoke.REGISTRATION_TIERS``.

Sign convention: the returned ``(dy, dx)`` is the stored *correction*,
the roll that aligns ``target`` with ``reference``, not the drift: for
``target = roll(reference, (5, -7))`` it is ``(-5, 7)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _correlation(reference: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The normalised cross-power spectrum's inverse: ``(..., H, W)``."""
    a = reference.to(torch.float32)
    b = target.to(torch.float32)
    cross = torch.fft.rfft2(a) * torch.fft.rfft2(b).conj()
    return torch.fft.irfft2(cross / cross.abs().clamp(min=1e-12), s=tuple(a.shape[-2:]))


def _peak(corr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dy, dx)`` int32 of the first maximum of each surface in
    row-major order (``torch.argmax``, like ``jnp.argmax``), signed:
    above ``H // 2`` (``W // 2``) wraps to negative; and the peak."""
    h, w = corr.shape[-2:]
    flat = corr.reshape(corr.shape[:-2] + (h * w,))
    idx = flat.argmax(dim=-1)
    dy, dx = idx // w, idx % w
    dy = torch.where(dy > h // 2, dy - h, dy).to(torch.int32)
    dx = torch.where(dx > w // 2, dx - w, dx).to(torch.int32)
    return dy, dx, flat.gather(-1, idx[..., None])[..., 0]


def phase_correlation(
    reference: torch.Tensor, target: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer ``(dy, dx)`` such that rolling ``target`` by it aligns it
    with ``reference`` (``reference[y, x] ~ target[y - dy, x - dx]``)."""
    dy, dx, _ = _peak(_correlation(reference, target))
    return dy, dx


def phase_correlation_quality(
    reference: torch.Tensor, target: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dy, dx, quality)``: quality is the correlation surface's peak
    clipped to ``[0, 1]`` -- 1.0 for a circular shift of identical
    content, near ``1 / sqrt(H * W)`` for unrelated images."""
    dy, dx, peak = _peak(_correlation(reference, target))
    return dy, dx, peak.clamp(0.0, 1.0)


def phase_correlation_subpixel(
    reference: torch.Tensor, target: torch.Tensor, upsample: int = 10
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dy, dx)`` float32 at ``1 / upsample`` pixel: the inverse DFT of
    the normalised cross-power spectrum evaluated on an upsampled grid of
    1.5 pixels around the integer peak by two small matrix products
    (Guizar-Sicairos), for one ``(H, W)`` pair."""
    a = reference.to(torch.float32)
    b = target.to(torch.float32)
    h, w = a.shape
    dy0, dx0, _ = _peak(_correlation(a, b))
    cross = torch.fft.fft2(a) * torch.fft.fft2(b).conj()
    cross = cross / cross.abs().clamp(min=1e-12)
    n = int(3 * upsample)
    offsets = (torch.arange(n, dtype=torch.float32, device=a.device) - n / 2.0) / upsample
    fy = torch.fft.fftfreq(h, dtype=torch.float32, device=a.device)
    fx = torch.fft.fftfreq(w, dtype=torch.float32, device=a.device)
    ey = torch.exp(2j * math.pi * (dy0.to(torch.float32) + offsets)[:, None] * fy[None, :])
    ex = torch.exp(2j * math.pi * (dx0.to(torch.float32) + offsets)[:, None] * fx[None, :])
    local = torch.einsum("kh,hw,lw->kl", ey, cross, ex).real
    pk = int(local.argmax())
    return dy0.to(torch.float32) + offsets[pk // n], dx0.to(torch.float32) + offsets[pk % n]


def batch_phase_correlation(
    reference_stack: torch.Tensor, target_stack: torch.Tensor
) -> torch.Tensor:
    """``(B, 2)`` int32 shifts of ``(B, H, W)`` pairs."""
    return torch.stack(phase_correlation(reference_stack, target_stack), dim=-1)


def batch_phase_correlation_quality(
    reference_stack: torch.Tensor, target_stack: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``((B, 2) int32 shifts, (B,) quality)`` of ``(B, H, W)`` pairs."""
    dy, dx, quality = phase_correlation_quality(reference_stack, target_stack)
    return torch.stack([dy, dx], dim=-1), quality


def filter_shifts(
    shifts: torch.Tensor, quality: torch.Tensor, max_shift: int = 50,
    min_quality: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The align step's failure rule: a site whose shift exceeds
    ``max_shift`` on either axis, or (``min_quality > 0``) whose quality
    falls below ``min_quality``, gets the shift ``(0, 0)``.  Returns the
    shifts and the ``(B,)`` bool mask of failed sites."""
    bad = shifts.abs().amax(dim=-1) > max_shift
    if min_quality > 0.0:
        bad = bad | (quality < min_quality)
    return torch.where(bad[..., None], torch.zeros_like(shifts), shifts), bad


def intersection_window(all_shifts) -> dict[str, int]:
    """Crop window covering the overlap of all cycles at all sites
    (reference ``SiteIntersection``), from the ``(N, 2)`` stored
    corrections: the top margin absorbs the largest positive dy, the
    bottom the largest negative, likewise left/right for dx (host ints
    for static crop shapes)."""
    if isinstance(all_shifts, torch.Tensor):
        all_shifts = all_shifts.cpu().numpy()
    s = np.asarray(all_shifts)
    if s.size == 0:
        return {"top": 0, "bottom": 0, "left": 0, "right": 0}
    return {
        "top": int(np.clip(s[:, 0].max(), 0, None)),
        "bottom": int(np.clip(-s[:, 0].min(), 0, None)),
        "left": int(np.clip(s[:, 1].max(), 0, None)),
        "right": int(np.clip(-s[:, 1].min(), 0, None)),
    }
