"""Cross-rank corilla: the sharded Welford with an in-order merge.

Counterpart: ``tmlibrary_tpu/parallel/stats.py:32-112``
(``sharded_welford``, ``sharded_channel_stats``).  Each rank scans its
contiguous shard of the site axis
(:func:`~tmlibrary_tpu_torch.ops.stats.welford_scan`), every rank's state
is gathered, and the states are folded with
:func:`~tmlibrary_tpu_torch.ops.stats.welford_merge` in rank order
(:func:`merge_shard_states`): deterministic for a given mesh size, as
the reference's ``all_gather`` and in-order fold are.  A ragged batch
splits into the head that divides the mesh, scanned sharded, and the
tail, scanned on every rank and merged last, the reference's order.
"""

from __future__ import annotations

import torch

from tmlibrary_tpu_torch.ops.stats import (
    WelfordState,
    welford_finalize,
    welford_merge,
    welford_scan,
)
from tmlibrary_tpu_torch.parallel import distributed
from tmlibrary_tpu_torch.parallel.mesh import Mesh


def merge_shard_states(state: WelfordState, mesh: Mesh) -> WelfordState:
    """Every member rank's state folded in rank order, on every member."""
    if mesh.size == 1:
        return state
    gathered = [distributed.all_gather(field, mesh.group) for field in state]
    acc = WelfordState(*(parts[0] for parts in gathered))
    for i in range(1, mesh.size):
        acc = welford_merge(acc, WelfordState(*(parts[i] for parts in gathered)))
    return acc


def sharded_welford(stack: torch.Tensor, mesh: Mesh) -> WelfordState:
    """The merged state of a ``(B, H, W)`` stack (the same on every rank),
    each rank scanning its ``B // n`` sites of the head."""
    b = stack.shape[0]
    n = mesh.size
    head = (b // n) * n
    if head == 0:
        return welford_scan(stack)
    per = head // n
    state = merge_shard_states(welford_scan(stack[mesh.rank * per:(mesh.rank + 1) * per]), mesh)
    if head == b:
        return state
    return welford_merge(state, welford_scan(stack[head:]))


def sharded_channel_stats(stack: torch.Tensor, mesh: Mesh) -> dict[str, torch.Tensor]:
    """One channel's finalized illumination statistics over a sharded
    stack, on every rank."""
    return welford_finalize(sharded_welford(stack, mesh))
