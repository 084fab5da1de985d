"""Segmented-reduction conventions.

Counterpart: ``tmlibrary_tpu/ops/reduction.py``.  This slice needs only
the capacity → segment-count convention; the strategy layer of the JAX
package (onehot/sort/scatter/fused) has one member here, the fused
``grouped_stats`` kernel of :mod:`tmlibrary_tpu_torch.ops.fused_measure`.
"""

from __future__ import annotations


def capacity_segments(capacity: int) -> int:
    """Segment count for an object-capacity of ``capacity``: one row per
    object id plus row 0 for background.

    Capacity-invariance contract: every segment's row is computed
    independently of how many padded rows follow it, so for ids bounded
    by ``n``, any two capacities ``>= n`` yield bit-identical rows
    ``0..n``."""
    return int(capacity) + 1
