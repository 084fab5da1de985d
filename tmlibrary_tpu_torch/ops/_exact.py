"""Arithmetic that rounds the same way on the CPU and on the card.

The label gate is bit-exact, so every float expression that decides a
mask (the Otsu cut, the gaussian, the watershed levels) must round the
same way on both devices and the same way as the JAX reference:

- PyTorch's CUDA ``div`` by a Python scalar multiplies by the scalar's
  reciprocal, which can differ by one ulp from a true division.
  :func:`div` always divides by a tensor on the dividend's device.
- ``torch.cumsum`` sums in a device-dependent order.
  :func:`cumsum_xla_cpu` reproduces the order XLA-CPU uses for a
  cumulative sum (``reduce_window`` rewritten into blocks of 16: a
  sequential scan inside each block, the block totals scanned the same
  way, then added), so the Otsu between-class variance is bit-identical
  to the reference and identical on both devices.
"""

from __future__ import annotations

import torch

_SCAN_BLOCK = 16


def div(a: torch.Tensor, b) -> torch.Tensor:
    """True IEEE division ``a / b`` with ``b`` as a tensor on ``a``'s device."""
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=a.dtype)
    return a / b.to(device=a.device, dtype=a.dtype)


def _scan_sequential(x: torch.Tensor) -> torch.Tensor:
    cols = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., i])
    return torch.stack(cols, dim=-1)


def cumsum_xla_cpu(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over the last axis in XLA-CPU's order."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return _scan_sequential(x)
    pad = (-n) % _SCAN_BLOCK
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    blocks = x.reshape(x.shape[:-1] + (-1, _SCAN_BLOCK))
    local = _scan_sequential(blocks)
    totals = cumsum_xla_cpu(local[..., -1])
    offset = torch.cat(
        [totals.new_zeros(totals.shape[:-1] + (1,)), totals[..., :-1]], dim=-1
    )
    # block 0 keeps its local scan (adding 0.0 is exact)
    out = local + offset[..., None]
    return out.reshape(x.shape)[..., :n]
