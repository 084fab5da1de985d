"""Exact fixed-bin histograms.

Counterpart: ``tmlibrary_tpu/ops/histogram.py:32``
(``histogram_fixed_bins``).  The JAX package left this to XLA (a one-hot
matmul on the TPU, a scatter on the CPU); here it is one integer
``scatter_add_`` per batch, exact and order-free on both devices.
"""

from __future__ import annotations

import torch


def histogram_counts(idx: torch.Tensor, bins: int) -> torch.Tensor:
    """Per-row histogram of int bin indices in ``[0, bins)``.

    ``idx`` is ``(B, ...)``; returns ``(B, bins)`` int32 counts.
    Out-of-range indices are dropped, like the reference's scatter."""
    flat = idx.reshape(idx.shape[0], -1).to(torch.int64)
    valid = (flat >= 0) & (flat < bins)
    counts = torch.zeros(
        (flat.shape[0], bins + 1), dtype=torch.int32, device=flat.device
    )
    counts.scatter_add_(
        1, torch.where(valid, flat, bins), torch.ones_like(flat, dtype=torch.int32)
    )
    return counts[:, :bins]


def histogram_fixed_bins(idx: torch.Tensor, bins: int) -> torch.Tensor:
    """:func:`histogram_counts` as float32 (the reference's dtype)."""
    return histogram_counts(idx, bins).to(torch.float32)
