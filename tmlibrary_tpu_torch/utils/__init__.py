"""General utilities.

Counterpart: ``tmlibrary_tpu/utils/__init__.py`` (reference
``tmlib/utils.py``): the batching primitive every step's plan uses, the
power-of-two rounding of the capacity ladder, ``flatten`` and the
type-assertion and padding helpers.  ``enable_compilation_cache`` (JAX's
persistent compilation cache) has no counterpart: the port compiles
nothing per program.
"""

from __future__ import annotations

import itertools
from typing import Any, Iterable, Sequence


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


def flatten(nested: Iterable[Iterable[Any]]) -> list[Any]:
    """Flatten one level of nesting."""
    return list(itertools.chain.from_iterable(nested))


def assert_type(value: Any, name: str, *types: type) -> None:
    """Raise ``TypeError`` unless ``value`` is an instance of one of ``types``."""
    if not isinstance(value, tuple(types)):
        expected = " or ".join(t.__name__ for t in types)
        raise TypeError(f"argument '{name}' must be of type {expected}, "
                        f"got {type(value).__name__}")


def pad_to(values: Sequence[Any], length: int, fill: Any) -> list[Any]:
    """Pad ``values`` with ``fill`` up to ``length``."""
    values = list(values)
    if len(values) > length:
        raise ValueError(f"got {len(values)} values, more than length={length}")
    return values + [fill] * (length - len(values))
