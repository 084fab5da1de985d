"""The label-propagation fixpoints: CUDA kernels and their plain versions.

Counterpart: ``tmlibrary_tpu/ops/pallas_kernels.py`` — the TPU kernels
``fill_holes_flood`` (``_fill_kernel``), ``cc_min_propagate``
(``_cc_kernel``) and ``watershed_flood`` (``_watershed_kernel``).  The
Hopper kernels are in ``tmlibrary_tpu_torch/csrc/{fill_holes,
cc_min_propagate,watershed_flood}.cu`` (design and bounds in each
source's header).

Every function here takes a batch of sites ``(B, H, W)``.  The wrapper
dispatches on the tensor's device: a CPU tensor goes to the ``*_plain``
version (synchronous PyTorch steps to the same fixpoint), a CUDA tensor
to the kernel, which launches or raises — there is no fallback from one
to the other.  Each wrapper counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tmlibrary_tpu_torch.ops import _cuda
from tmlibrary_tpu_torch.ops._exact import div

#: sentinel for "no label yet" in min-propagation (same value as the JAX
#: package's ``pallas_kernels.BIG``)
BIG = 2**30

#: plain-version propagation steps between convergence checks (the
#: fixpoints are idempotent, so extra steps cannot change a label)
CHUNK = 8


def neighbor_shifts(connectivity: int) -> list[tuple[int, int]]:
    if connectivity == 4:
        return [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if connectivity == 8:
        return [
            (-1, -1), (-1, 0), (-1, 1),
            (0, -1), (0, 1),
            (1, -1), (1, 0), (1, 1),
        ]
    raise ValueError("connectivity must be 4 or 8")


def shift_with_fill(arr: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """``out[..., y, x] = arr[..., y + dy, x + dx]`` with ``fill`` at exposed
    borders, over the last two axes.  Pads by the shift's own reach (the
    reference pads by one pixel, so its shifts beyond 1 land short)."""
    h, w = arr.shape[-2:]
    if arr.dtype == torch.bool:
        return shift_with_fill(arr.to(torch.uint8), dy, dx, int(fill)).to(torch.bool)
    r = max(abs(dy), abs(dx), 1)
    padded = F.pad(arr, (r, r, r, r), value=fill)
    return padded[..., r + dy : r + dy + h, r + dx : r + dx + w]


def _fixpoint(step, state: torch.Tensor) -> torch.Tensor:
    """Run ``step`` until a chunk of steps changes nothing."""
    while True:
        new = state
        for _ in range(CHUNK):
            new = step(new)
        if torch.equal(new, state):
            return new
        state = new


def _check_sites(name: str, *tensors: torch.Tensor) -> None:
    shape = tensors[0].shape
    if len(shape) != 3:
        raise ValueError(f"{name}: expected (B, H, W) sites, got {tuple(shape)}")
    for t in tensors[1:]:
        if t.shape != shape:
            raise ValueError(f"{name}: shape mismatch {tuple(t.shape)} vs {tuple(shape)}")
    if shape[1] * shape[2] >= BIG:
        raise ValueError(f"{name}: site too large for int32 linear labels")


# -------------------------------------------------------------- fill holes
def fill_holes_flood_plain(mask: torch.Tensor, connectivity: int = 4) -> torch.Tensor:
    """Border flood through ``connectivity``-connected background; what the
    flood never reached is filled."""
    mask = mask.to(torch.bool)
    bg = ~mask
    border = torch.zeros_like(mask)
    border[..., 0, :] = True
    border[..., -1, :] = True
    border[..., :, 0] = True
    border[..., :, -1] = True
    shifts = neighbor_shifts(connectivity)

    def step(reach):
        new = reach
        for dy, dx in shifts:
            new = new | shift_with_fill(reach, dy, dx, False)
        return new & bg

    reach = _fixpoint(step, bg & border)
    return mask | (bg & ~reach)


def fill_holes_flood(mask: torch.Tensor, connectivity: int = 4) -> torch.Tensor:
    """Filled ``(B, H, W)`` bool masks (scipy ``binary_fill_holes`` at
    background connectivity 4)."""
    _check_sites("fill_holes_flood", mask)
    if connectivity not in (4, 8):
        raise ValueError("connectivity must be 4 or 8")
    if mask.device.type == "cpu":
        return fill_holes_flood_plain(mask, connectivity)
    mask = mask.to(torch.bool).contiguous()
    out = torch.empty_like(mask)
    reach = torch.empty(mask.shape, dtype=torch.uint8, device=mask.device)
    _cuda.require_cuda("fill_holes_flood", mask, out, reach)
    b, h, w = mask.shape
    fill_holes_flood.launches += 1
    _cuda.check("tm_fill_holes", _cuda.lib().tm_fill_holes(
        mask.data_ptr(), out.data_ptr(), reach.data_ptr(), b, h, w,
        connectivity, _cuda.stream()))
    return out


fill_holes_flood.launches = 0


# ------------------------------------------------------- CC min-propagate
def cc_min_propagate_plain(mask: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """Synchronous neighbour-min propagation of linear indices."""
    mask = mask.to(torch.bool)
    b, h, w = mask.shape
    linear = torch.arange(h * w, dtype=torch.int32, device=mask.device).reshape(h, w)
    big = torch.full((), BIG, dtype=torch.int32, device=mask.device)
    shifts = neighbor_shifts(connectivity)

    def step(lab):
        new = lab
        for dy, dx in shifts:
            new = torch.minimum(new, shift_with_fill(lab, dy, dx, BIG))
        return torch.where(mask, new, big)

    return _fixpoint(step, torch.where(mask, linear.expand(b, h, w), big))


def cc_min_propagate(mask: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """Converged min-linear-index labels of ``(B, H, W)`` masks; background
    holds ``BIG``."""
    _check_sites("cc_min_propagate", mask)
    if connectivity not in (4, 8):
        raise ValueError("connectivity must be 4 or 8")
    if mask.device.type == "cpu":
        return cc_min_propagate_plain(mask, connectivity)
    mask = mask.to(torch.bool).contiguous()
    out = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    _cuda.require_cuda("cc_min_propagate", mask, out)
    b, h, w = mask.shape
    cc_min_propagate.launches += 1
    _cuda.check("tm_cc_min_propagate", _cuda.lib().tm_cc_min_propagate(
        mask.data_ptr(), out.data_ptr(), b, h, w, connectivity, _cuda.stream()))
    return out


cc_min_propagate.launches = 0


# --------------------------------------------------------------- watershed
def watershed_levels(
    intensity: torch.Tensor, mask: torch.Tensor, n_levels: int
) -> torch.Tensor:
    """``(B, n_levels)`` descending thresholds ``hi - span * (i+1) / n``,
    float32 left to right, from the masked min/max of each site."""
    b = intensity.shape[0]
    inf = torch.full((), float("inf"), device=intensity.device)
    lo = torch.where(mask, intensity, inf).reshape(b, -1).amin(dim=1)
    hi = torch.where(mask, intensity, -inf).reshape(b, -1).amax(dim=1)
    span = torch.clamp(hi - lo, min=1e-6)
    steps = torch.arange(1, n_levels + 1, dtype=torch.float32, device=intensity.device)
    return hi[:, None] - div(span[:, None] * steps[None, :], n_levels)


def watershed_flood_plain(
    intensity: torch.Tensor,
    seeds: torch.Tensor,
    mask: torch.Tensor,
    n_levels: int = 32,
    connectivity: int = 8,
) -> torch.Tensor:
    """Level-ordered Jacobi flooding: unlabeled allowed pixels adopt the
    max neighbour label, each level to convergence, then a mop-up."""
    intensity = intensity.to(torch.float32)
    seeds = seeds.to(torch.int32)
    mask = mask.to(torch.bool) | (seeds > 0)
    levels = watershed_levels(intensity, mask, n_levels)
    shifts = neighbor_shifts(connectivity)

    def flood(labels, allowed):
        def step(lab):
            neigh = torch.zeros_like(lab)
            for dy, dx in shifts:
                neigh = torch.maximum(neigh, shift_with_fill(lab, dy, dx, 0))
            return torch.where((lab == 0) & allowed, neigh, lab)

        return _fixpoint(step, labels)

    labels = seeds
    for i in range(n_levels):
        labels = flood(labels, mask & (intensity >= levels[:, i, None, None]))
    labels = flood(labels, mask)  # mop up below the lowest level
    return torch.where(mask, labels, torch.zeros_like(labels))


def watershed_flood(
    intensity: torch.Tensor,
    seeds: torch.Tensor,
    mask: torch.Tensor,
    n_levels: int = 32,
    connectivity: int = 8,
) -> torch.Tensor:
    """Level-ordered watershed flooding of ``(B, H, W)`` sites; seeds keep
    their labels, output is zero outside ``mask | seeds > 0``."""
    _check_sites("watershed_flood", intensity, seeds, mask)
    if connectivity not in (4, 8):
        raise ValueError("connectivity must be 4 or 8")
    if n_levels < 1:
        raise ValueError("n_levels must be >= 1")
    if intensity.device.type == "cpu":
        return watershed_flood_plain(intensity, seeds, mask, n_levels, connectivity)
    intensity = intensity.to(torch.float32).contiguous()
    seeds = seeds.to(torch.int32).contiguous()
    mask = mask.to(torch.bool).contiguous()
    out = torch.empty_like(seeds)
    scratch = torch.empty_like(seeds)
    _cuda.require_cuda("watershed_flood", intensity, seeds, mask, out, scratch)
    b, h, w = intensity.shape
    watershed_flood.launches += 1
    _cuda.check("tm_watershed_flood", _cuda.lib().tm_watershed_flood(
        intensity.data_ptr(), seeds.data_ptr(), mask.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), b, h, w, n_levels, connectivity, _cuda.stream()))
    return out


watershed_flood.launches = 0
