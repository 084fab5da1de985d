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
- PyTorch's vectorised CPU ``sqrt`` is one ulp off the correctly
  rounded root on some inputs (float32 and float64); the card's is
  correctly rounded (``chip_smoke.py``'s op trace of ``Intensity_std``
  and the ellipse axes).  :func:`sqrt` gives the correctly rounded
  float32 root on both devices.
"""

from __future__ import annotations

import torch

_SCAN_BLOCK = 16


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of float32 ``x`` on either device.
    The float64 root rounded to float32 is checked against the squares of
    its two rounding midpoints -- 25-bit numbers, so their squares are
    exact in float64 and no float32 ``x`` equals one -- and moved by one
    ulp where ``x`` lies beyond a midpoint."""
    xd = x.double()
    r = torch.sqrt(xd).to(torch.float32)
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    down = torch.nextafter(r, torch.zeros_like(r))
    rd = r.double()
    hi = (rd + up.double()) * 0.5
    lo = (rd + down.double()) * 0.5
    r = torch.where(hi * hi < xd, up, r)
    return torch.where(lo * lo > xd, down, r)


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
