"""Secondary segmentation: grow cell objects outward from primary seeds.

Counterpart: ``tmlibrary_tpu/ops/segment_secondary.py:68``
(``watershed_from_seeds``).  Level-ordered flooding of seed labels
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
