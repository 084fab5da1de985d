"""Segmented-reduction strategy layer.

Counterpart: ``tmlibrary_tpu/ops/reduction.py``.  Every per-object
measurement in :mod:`tmlibrary_tpu_torch.ops.measure` is a segmented
reduction over the label image; four strategies compute it:

``"fused"``
    The hand-written CUDA kernels of
    :mod:`tmlibrary_tpu_torch.ops.fused_measure` (``grouped_stats``,
    ``intensity_hist``, ``glcm_all``; their plain versions on the CPU):
    one pass over a site for every channel's sums, minima and maxima.
    The port's main path.
``"onehot"``
    A one-hot of the segment ids contracted against the values
    (``torch.matmul``/``bmm``, chunked over sites and pixels).  min/max
    have no matmul form, so there it is the masked broadcast reduce.  The
    one-hot forms live at their call sites in ``ops/measure.py``.
``"sort"``
    A stable sort by segment id (:func:`sort_by_segment`), then each
    sorted run reduced by ``torch.segment_reduce``, whose order over a
    run is fixed: bit-identical from run to run on either device.
``"scatter"``
    Direct ``index_add_``/``scatter_reduce_`` into the segments.  On the
    CPU it adds in pixel order, so it is bit-identical to ``"sort"``; on
    the card its atomics leave the order free.

``sort`` and ``scatter`` sum in float64 and round once to the values'
dtype, as the one-hot product does (the reference sums in float32).

Determinism contract (``tests/test_torch_reduction.py``): min/max agree
bit for bit across the strategies; counts and integer-valued sums below
2^24 are exact in float32 in any order and so bit-identical; other
float32 sums stay within 1e-6 relative of each other and of the
reference's; ``sort`` and ``scatter`` are bit-identical to each other on
the CPU.

Resolution of ``"auto"`` (highest first): a build-time pin
(:func:`strategy_scope`, how ``build_batch_fn`` freezes its choice), the
``reduction_strategy`` setting (``TM_REDUCTION_STRATEGY`` or the INI
file), the tuning verdict measured on the backend (``cuda`` by default;
a verdict of another backend sets nothing), then ``"fused"``.  The
reference resolves the last step to ``scatter`` on the CPU and
``onehot`` on accelerators; the port keeps its kernels (ROADMAP C).  The
port has no environment switch for the request: the CLI's
``--reduction-strategy`` is the jterator step's argument.
"""

from __future__ import annotations

import contextlib
import threading

import torch

#: the explicit strategies; "auto" resolves to one of these
STRATEGIES = ("onehot", "sort", "scatter", "fused")

_PIN = threading.local()
_UNSET = object()


def capacity_segments(capacity: int) -> int:
    """Segment count for an object-capacity of ``capacity``: one row per
    object id plus row 0 for background.

    Capacity-invariance contract: every segment's row is computed
    independently of how many padded rows follow it, so for ids bounded
    by ``n``, any two capacities ``>= n`` yield bit-identical rows
    ``0..n``."""
    return int(capacity) + 1


def _validate(strategy: str) -> None:
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown reduction strategy '{strategy}' "
                         f"(expected one of {STRATEGIES} or 'auto')")


@contextlib.contextmanager
def strategy_scope(strategy: "str | None"):
    """Pin the requested strategy for the block, in this thread.

    ``build_batch_fn`` resolves its request once and runs every call of
    the batch function in this scope, so what a program runs cannot move
    with the settings between its build and its calls.  ``None`` pins
    "no explicit request": inside the scope resolution goes straight to
    the default."""
    if strategy is not None:
        _validate(strategy)
    prev = getattr(_PIN, "value", _UNSET)
    _PIN.value = strategy
    try:
        yield
    finally:
        if prev is _UNSET:
            del _PIN.value
        else:
            _PIN.value = prev


def requested_reduction_strategy(backend: str | None = None) -> str | None:
    """The explicitly requested strategy, or None: the
    ``reduction_strategy`` setting, else the tuning verdict of
    ``backend`` (``cuda`` by default).  An unknown configured name
    raises ``ValueError``; a malformed verdict is ignored."""
    from tmlibrary_tpu_torch import config, tuning

    configured = config.setting("reduction_strategy", "auto")
    if configured and configured != "auto":
        _validate(configured)
        return configured
    return tuning.tuned_reduction_strategy(backend)


def explicit_reduction_request(backend: str | None = None) -> str | None:
    """The request in effect: inside :func:`strategy_scope` its pin
    (which may be None), else :func:`requested_reduction_strategy`."""
    pinned = getattr(_PIN, "value", _UNSET)
    if pinned is not _UNSET:
        return pinned
    return requested_reduction_strategy(backend)


def resolve_reduction_strategy(method: str = "auto", backend: str | None = None) -> str:
    """``method`` unless ``"auto"``, else the request in effect
    (:func:`explicit_reduction_request`), else ``"fused"``.  An unknown
    explicit or configured name raises ``ValueError``."""
    if method and method != "auto":
        _validate(method)
        return method
    requested = explicit_reduction_request(backend)
    return requested if requested is not None else "fused"


# ----------------------------------------------------------- sort machinery
def sort_by_segment(segment_ids: torch.Tensor, *values: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Stable-sort the rows of ``values`` by the flat ``segment_ids``:
    ``(sorted_ids, sorted_value0, ...)``.  Within a segment the rows keep
    their order, which fixes every sorted-run reduction's order."""
    flat = segment_ids.reshape(-1)
    sorted_ids, order = torch.sort(flat, stable=True)
    return (sorted_ids,) + tuple(v.index_select(0, order) for v in values)


def _segments(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    """Flat int64 ids with every id outside ``[0, num_segments)`` moved
    to ``num_segments`` (an extra segment the callers drop)."""
    ids = segment_ids.reshape(-1).to(torch.int64)
    if ids.shape[0] != values.shape[0]:
        raise ValueError(f"{values.shape[0]} value rows for {ids.shape[0]} segment ids")
    return torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)


_IDENTITY = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}
_SCATTER = {"min": "amin", "max": "amax"}


def _segmented(kind: str, values: torch.Tensor, segment_ids: torch.Tensor,
               num_segments: int, strategy: str) -> torch.Tensor:
    if strategy not in ("sort", "scatter"):
        raise ValueError(f"segmented_{kind} has no '{strategy}' path")
    ids = _segments(values, segment_ids, num_segments)
    n = int(num_segments)
    init = _IDENTITY[kind]
    # sums accumulate in float64 and round once, so their order (free
    # under the card's atomics) moves a float32 sum by a rounding at most
    acc_dtype = torch.float64 if kind == "sum" and values.is_floating_point() \
        else values.dtype
    if strategy == "sort":
        ids, vals = sort_by_segment(ids, values)
        lengths = torch.bincount(ids, minlength=n + 1)
        out = torch.segment_reduce(vals.to(acc_dtype), kind, lengths=lengths, axis=0,
                                   initial=init)
        return out[:n].to(values.dtype)
    if kind == "sum":
        # one channel at a time: a 1-D index_add_ adds in pixel order on
        # the CPU (the 2-D form walks the rows one slice call at a time)
        src = values.reshape(values.shape[0], -1).t().contiguous()
        acc = values.new_zeros((src.shape[0], n + 1), dtype=acc_dtype)
        for c in range(src.shape[0]):
            acc[c].index_add_(0, ids, src[c].to(acc_dtype))
        return acc.t().reshape((n + 1,) + tuple(values.shape[1:]))[:n].to(values.dtype)
    out = values.new_full((n + 1,) + tuple(values.shape[1:]), init)
    index = ids.reshape((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    return out.scatter_reduce_(0, index, values, _SCATTER[kind])[:n]


def segmented_sum(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                  strategy: str = "scatter") -> torch.Tensor:
    """Per-segment sums of ``values`` (``(P,)`` or ``(P, C)``) for the
    ``sort`` and ``scatter`` strategies (the one-hot forms stay at their
    call sites in ``ops/measure.py``); absent segments are 0 and ids
    outside ``[0, num_segments)`` count nowhere."""
    return _segmented("sum", values, segment_ids, num_segments, strategy)


def segmented_min(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                  strategy: str = "scatter") -> torch.Tensor:
    """Per-segment minima; absent segments are +inf (NaN propagates)."""
    return _segmented("min", values, segment_ids, num_segments, strategy)


def segmented_max(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                  strategy: str = "scatter") -> torch.Tensor:
    """Per-segment maxima; absent segments are -inf (NaN propagates)."""
    return _segmented("max", values, segment_ids, num_segments, strategy)
