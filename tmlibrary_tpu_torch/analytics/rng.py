"""JAX's threefry2x32 random draws, in PyTorch integer arithmetic.

Counterpart: the ``jax.random`` calls of the reference's analytics --
``normal(PRNGKey(seed), (F, k + 8))`` for PCA's test matrix,
``normal(PRNGKey(7), (N, n_components))`` for the embedding's start and
``randint(PRNGKey(seed), (), 0, n)`` for k-means' first seed.  PyTorch's
generators draw other numbers, and k-means would then start from another
row, so the port draws JAX's bits itself:

- a key is two uint32 words; :func:`prng_key` of an int32 seed is
  ``(0, seed)``;
- :func:`threefry2x32` is the 20-round Threefry-2x32 hash (rotations
  13 15 26 6 / 17 29 16 24, a key schedule word ``k0 ^ k1 ^ 0x1BD11BDA``
  injected every four rounds);
- the partitionable mode JAX runs (``jax_threefry_partitionable``): the
  element with flat index ``i`` hashes the counter pair ``(i >> 32,
  i & 0xFFFFFFFF)``; :func:`random_bits` is the xor of the two output
  words, and :func:`split` keeps both words as the new keys.

:func:`random_bits` and :func:`randint` are bit-exact with JAX.
:func:`normal` is ``sqrt(2) * erfinv(u)`` of a uniform on
``(nextafter(-1, 0), 1)``; ``erfinv`` is XLA's float32 expansion (M.
Giles' single-precision polynomial in ``w = -log1p(-u*u)``) with its
fused Horner steps and XLA's ``log1p`` (a Cephes rational form for
small arguments, reproduced bit for bit; ``log(1 + x)`` above, where
XLA's own ``log`` approximation is not reproduced and the correctly
rounded one stands in), so a few draws in a thousand differ from JAX's
by an ulp or two (``tests/test_torch_analytics.py`` holds the count).

Everything is drawn on the host in int64 tensors holding uint32 values
and moved to ``device`` at the end, so the card and the CPU draw the same
numbers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

#: XLA's float32 erf_inv coefficients (Giles), highest order first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


#: XLA's log1p below sqrt(2) - 1 (Cephes), highest order first
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for an int32 seed (JAX's default,
    64-bit integers off): the words ``(0, seed mod 2**32)``."""
    seed = int(seed)
    if not -(2 ** 31) <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} does not fit int32")
    return 0, seed & _MASK


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(key: tuple[int, int], x0: torch.Tensor, x1: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the counter words ``(x0, x1)`` (int64
    tensors holding uint32 values) under ``key``."""
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [(x0 + ks[0]) & _MASK, (x1 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def _counters(shape: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """The partitionable mode's counter words of a row-major ``shape``."""
    i = torch.arange(math.prod(shape), dtype=torch.int64).reshape(shape)
    return i >> 32, i & _MASK


def split(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(key, num)``: ``num`` new keys."""
    hi, lo = _counters((int(num),))
    b0, b1 = threefry2x32(key, hi, lo)
    return [(int(a), int(b)) for a, b in zip(b0.tolist(), b1.tolist())]


def random_bits(key: tuple[int, int], shape: tuple[int, ...]) -> torch.Tensor:
    """32 random bits an element (int64 holding uint32), JAX's
    ``random_bits(key, 32, shape)``."""
    hi, lo = _counters(tuple(int(s) for s in shape))
    b0, b1 = threefry2x32(key, hi, lo)
    return b0 ^ b1


def randint(key: tuple[int, int], shape: tuple[int, ...], minval: int, maxval: int,
            device: "str | torch.device" = "cpu") -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32): two
    32-bit draws folded modulo the span, as JAX folds them."""
    k_hi, k_lo = split(key, 2)
    higher, lower = random_bits(k_hi, shape), random_bits(k_lo, shape)
    minval, maxval = int(minval), int(maxval)
    span = 1 if maxval <= minval else (maxval - minval) & _MASK
    multiplier = (2 ** 16) % span
    multiplier = (multiplier * multiplier & _MASK) % span
    offset = ((higher % span) * multiplier & _MASK) + (lower % span)
    offset = (offset & _MASK) % span
    return (minval + offset).to(torch.int32).to(device)


def _fma_horner(coeffs, x: torch.Tensor) -> torch.Tensor:
    """``((c0 * x + c1) * x + ...)`` in float32, each step rounded once
    (a fused multiply-add: the float64 product of two float32 is exact)."""
    p = torch.zeros_like(x)
    for c in coeffs:
        p = (p.double() * x.double() + float(np.float32(c))).float()
    return p


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p``: below sqrt(2) - 1 in magnitude its Cephes
    rational form, bit for bit; above it ``log(1 + x)``, where XLA's own
    ``log`` approximation is replaced by the correctly rounded one."""
    x2 = x * x
    small = _fma_horner(_LOG1P_NUM, x) / _fma_horner(_LOG1P_DEN, x)
    small = x + (x2 * -0.5 + (x * x2) * small)
    large = torch.log((1.0 + x).double()).float()
    return torch.where(x.abs() < 0.41421356237309504880, small, large)


def _erfinv(u: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` expansion, each Horner step ``c + p * w``
    rounded once, as the fused multiply-add XLA's CPU code uses."""
    w = -_log1p(u * -u)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0).double()
    p = torch.where(lt, torch.tensor(_ERFINV_LT5[0]), torch.tensor(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, torch.tensor(a), torch.tensor(b)).double()
        p = (c + p.double() * w).float()
    out = p * u
    return torch.where(u.abs() == 1.0, u * float("inf"), out)


def uniform(key: tuple[int, int], shape: tuple[int, ...], minval: float,
            maxval: float) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa
    of a number in [1, 2), less one, scaled into [minval, maxval)."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def normal(key: tuple[int, int], shape: tuple[int, ...],
           device: "str | torch.device" = "cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32, drawn on the host and
    moved to ``device``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, tuple(int(s) for s in shape), lo, 1.0)
    return (torch.tensor(np.float32(np.sqrt(2.0))) * _erfinv(u)).to(device)
