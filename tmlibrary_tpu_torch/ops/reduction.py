"""Segmented-reduction conventions and the strategy name.

Counterpart: ``tmlibrary_tpu/ops/reduction.py``.  The port needs the
capacity → segment-count convention and the strategy's resolution
chain; the strategy layer of the JAX package (onehot/sort/scatter/fused)
has one member here, the fused ``grouped_stats`` kernel of
:mod:`tmlibrary_tpu_torch.ops.fused_measure`, which every name runs.
The resolved name keys the perf store's programs
(:mod:`tmlibrary_tpu_torch.perf`), as the reference's does.
"""

from __future__ import annotations

#: the strategy names the reference accepts
STRATEGIES = ("onehot", "sort", "scatter", "fused")


def resolve_reduction_strategy(method: str = "auto", backend: str | None = None) -> str:
    """The strategy name: ``method`` unless ``"auto"``, else the
    ``reduction_strategy`` setting (``TM_REDUCTION_STRATEGY`` or the INI
    file), else the tuning verdict of ``backend`` (``cuda`` by default;
    one of another backend sets nothing), else ``"fused"``, the port's
    one member.  An unknown explicit or configured name raises
    ``ValueError``; a malformed verdict is ignored."""
    from tmlibrary_tpu_torch import config, tuning

    for value in (method, config.setting("reduction_strategy", "auto")):
        if value and value != "auto":
            if value not in STRATEGIES:
                raise ValueError(f"unknown reduction strategy '{value}' "
                                 f"(expected one of {STRATEGIES} or 'auto')")
            return value
    return tuning.tuned_reduction_strategy(backend) or "fused"


def capacity_segments(capacity: int) -> int:
    """Segment count for an object-capacity of ``capacity``: one row per
    object id plus row 0 for background.

    Capacity-invariance contract: every segment's row is computed
    independently of how many padded rows follow it, so for ids bounded
    by ``n``, any two capacities ``>= n`` yield bit-identical rows
    ``0..n``."""
    return int(capacity) + 1
