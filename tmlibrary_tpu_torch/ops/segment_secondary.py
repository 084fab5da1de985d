"""Secondary segmentation: grow cell objects outward from primary seeds.

Counterpart: ``tmlibrary_tpu/ops/segment_secondary.py:24-68``
(``_adopt_step``, ``propagate_labels``, ``expand_labels``,
``watershed_from_seeds``).  Level-ordered flooding of seed labels
through a mask with 8-neighbour max-label adoption; the fixpoint runs in
:func:`tmlibrary_tpu_torch.ops.kernels.watershed_flood` (CUDA kernel on
the card, plain PyTorch on the CPU).
"""

from __future__ import annotations

import torch

from tmlibrary_tpu_torch.ops import kernels


def watershed_from_seeds(
    intensity: torch.Tensor,
    seeds: torch.Tensor,
    mask: torch.Tensor,
    n_levels: int = 32,
    connectivity: int = 8,
) -> torch.Tensor:
    """Level-ordered flooding of ``seeds`` through ``mask`` for
    ``(B, H, W)`` sites: brighter mask pixels are claimed before dimmer
    ones, seed pixels keep their label."""
    return kernels.watershed_flood(
        intensity.to(torch.float32), seeds.to(torch.int32), mask.to(torch.bool),
        n_levels=n_levels, connectivity=connectivity,
    )


def _adopt_step(labels: torch.Tensor, allowed: torch.Tensor, connectivity: int) -> torch.Tensor:
    """One step: each unlabeled allowed pixel adopts the largest label
    among its neighbours, all pixels at once."""
    neigh = torch.zeros_like(labels)
    for dy, dx in kernels.neighbor_shifts(connectivity):
        neigh = torch.maximum(neigh, kernels.shift_with_fill(labels, dy, dx, 0))
    return torch.where((labels == 0) & allowed, neigh, labels)


def propagate_labels(
    labels: torch.Tensor, allowed: torch.Tensor, connectivity: int = 8
) -> torch.Tensor:
    """Expand ``(B, H, W)`` labels into ``allowed`` by adopt steps until
    nothing changes.  The plain fixpoint that ``nn.decode_secondary``
    runs as a one-level watershed flood; kept to hold that route
    against."""
    allowed = allowed.to(torch.bool)
    return kernels._fixpoint(lambda lab: _adopt_step(lab, allowed, connectivity),
                             labels.to(torch.int32))


def expand_labels(
    labels: torch.Tensor, iterations: int = 1, connectivity: int = 8
) -> torch.Tensor:
    """Grow every object of ``(B, H, W)`` labels by ``iterations`` adopt
    steps into any pixel; ties between objects go to the larger label."""
    lab = labels.to(torch.int32)
    allowed = torch.ones(lab.shape, dtype=torch.bool, device=lab.device)
    for _ in range(iterations):
        lab = _adopt_step(lab, allowed, connectivity)
    return lab
