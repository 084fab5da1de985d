"""General utilities.

Counterpart: ``tmlibrary_tpu/utils/__init__.py`` (reference
``tmlib/utils.py``): the batching primitive every step's plan uses and
the power-of-two rounding of the capacity ladder.
"""

from __future__ import annotations

from typing import Any, Sequence


def create_partitions(items: Sequence[Any], size: int) -> list[list[Any]]:
    """Split ``items`` into consecutive chunks of at most ``size`` elements
    (reference ``tmlib.utils.create_partitions``)."""
    if size < 1:
        raise ValueError("partition size must be >= 1")
    items = list(items)
    return [items[i : i + size] for i in range(0, len(items), size)]


def next_power_of_two(n: int) -> int:
    """Smallest power of two >= n."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()
