"""Adaptive object-capacity bucketing.

Counterpart: ``tmlibrary_tpu/capacity.py``.  Every object-indexed output
is padded to a per-site capacity, so a sparse plate spends most of its
per-object work on empty slots.  The *bucket ladder* is a small family
of power-of-two capacities (:func:`tmlibrary_tpu_torch.utils.next_power_of_two`)
ending at the configured ``max_objects`` ceiling.  The jterator step
builds one pipeline per capacity it routes to and picks each batch's
capacity at launch from the object counts seen so far; a batch whose
counts reach its routed capacity is re-run one bucket up before anything
is persisted, and only saturation at the *ceiling* falls through to the
auto-resegmentation path.

Bit-identity contract: for a site with ``count`` objects, every capacity
``c > count`` gives identical labels, counts and measurement rows
``1..count``, so routing is a pure performance decision.

Spec grammar: ``"auto"`` (the pow2 ladder), ``"off"`` (single bucket at
the ceiling) or an explicit comma list of capacities (``"8,32"``; the
ceiling is always appended).  The JAX package lets a ``TMX_OBJECT_BUCKETS``
env or an install setting stand in for ``"auto"``, and a
``TMX_SCHEDULE_EWMA`` env replace the site-history smoothing; with neither
present it resolves ``"auto"`` to the pow2 ladder and smooths by
:data:`DEFAULT_SITE_EWMA_ALPHA`, which is all the port does: it has no
env switch of its own.
"""

from __future__ import annotations

import hashlib
import threading

from tmlibrary_tpu_torch.utils import next_power_of_two

#: smallest bucket the auto ladder starts at — below this the padded
#: program is too small for bucketing to pay for an extra compile
DEFAULT_MIN_BUCKET = 8

#: spec values that disable bucketing (single bucket at the ceiling)
_OFF_VALUES = ("off", "none", "0", "false", "no")


def resolve_bucket_ladder(
    max_objects: int, spec: "str | None" = None
) -> tuple[int, ...]:
    """The ascending capacity ladder for a ``max_objects`` ceiling.

    ``spec=None`` or ``"auto"`` is the pow2 ladder; the ladder always
    ends at the ceiling, so routing can never pick a capacity the
    configured cap does not allow.  Malformed explicit specs fail LOUD.
    """
    ceiling = int(max_objects)
    if ceiling < 1:
        raise ValueError(f"max_objects must be >= 1, got {max_objects}")
    text = "auto" if spec is None else str(spec).strip().lower()
    if text in _OFF_VALUES:
        return (ceiling,)
    if text in ("", "auto"):
        caps = []
        c = min(DEFAULT_MIN_BUCKET, ceiling)
        while c < ceiling:
            caps.append(c)
            c = next_power_of_two(c + 1)
        return tuple(caps) + (ceiling,)
    caps = set()
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            val = int(part)
        except ValueError:
            raise ValueError(
                f"object_buckets spec '{spec}' is not 'auto', 'off' or a "
                f"comma list of capacities"
            ) from None
        if val < 1:
            raise ValueError(
                f"object_buckets capacity must be >= 1, got {val}"
            )
        if val < ceiling:
            caps.add(val)
    return tuple(sorted(caps)) + (ceiling,)


def select_capacity(observed: int, ladder: tuple[int, ...]) -> int:
    """The smallest ladder capacity that holds ``observed`` objects
    *without saturating* (``observed < capacity`` — a count AT the cap
    may have been clipped there), falling back to the ceiling."""
    for cap in ladder:
        if observed < cap:
            return cap
    return ladder[-1]


def likely_next_rungs(current: int, ladder: tuple[int, ...],
                      observed: "int | None" = None,
                      count: int = 1) -> tuple[int, ...]:
    """The capacity rungs escalation would reach next from ``current`` —
    the compile-ahead speculation targets (aotstore/perf): warming them
    during prefetch idle means a saturated batch re-runs one bucket up
    without paying compile on the critical path.

    When the ``observed`` peak already demands a higher rung than
    ``current`` (routing history from a peer job, or a count recorded
    after this program compiled), speculation jumps straight to the
    rung that peak selects instead of the literal next one.  Returns up
    to ``count`` ascending rungs strictly above ``current``; empty at
    the ceiling — there is nothing left to warm."""
    current = int(current)
    rungs = [int(c) for c in ladder if int(c) > current]
    if observed is not None:
        target = select_capacity(int(observed), ladder)
        if target > current:
            rungs = [c for c in rungs if c >= target]
    return tuple(rungs[: max(0, int(count))])


def slot_occupancy(total_objects: float, n_slots: float) -> float:
    """Fraction of padded object slots actually used (0 when there are
    no slots) — the padding-waste signal carried by bench records and
    the ``tmx_jterator_slot_occupancy`` gauge."""
    return float(total_objects) / n_slots if n_slots else 0.0


def ceiling_slots(slots: int, cap: int, ceiling: int) -> int:
    """Slot count the same batches would have carried at the unbucketed
    ``ceiling`` capacity.  ``1 - slots / ceiling_slots`` is the
    padded-FLOPs-avoided fraction (per-object measure FLOPs scale with
    the capacity), shared by the live ``tmx_jterator_padded_flops_avoided_frac``
    gauge and ``telemetry.registry_from_ledger``'s post-hoc derivation."""
    return (int(slots) // int(cap)) * int(ceiling) if cap else 0


# --------------------------------------------------------------- routing
# Peak-object-count history, scoped PER COMPILED-PROGRAM KEY.  A single
# ``tmx workflow submit`` only ever ran one pipeline, so the jterator
# step could keep the peak as an instance attribute — but a long-lived
# ``tmx serve`` process interleaves many experiments, and a shared (or
# instance-reset-per-job) history makes tenants with different object
# densities thrash each other's capacity-rung choices.  Keying the
# history by (description digest, ceiling, ladder) means: jobs running
# the SAME compiled-program family warm-start each other's routing,
# while unrelated pipelines never interact.  Routing is purely a
# performance decision (bit-identity contract above), so sharing can
# never change results.

_ROUTING_LOCK = threading.Lock()
_ROUTING_HISTORY: dict[str, int] = {}

#: per-site observed-count EWMA, scoped by the same routing key — the
#: work-aware scheduler's cost model (workflow/schedule.py) consumes it
#: to pack rung-homogeneous batches; fed from the identical persist-side
#: stream note_observed_peak already rides
_SITE_HISTORY: dict[str, dict[int, float]] = {}

#: EWMA smoothing for per-site counts: high enough that one completed
#: run dominates stale history, low enough that a single noisy batch
#: does not whipsaw the packing plan
DEFAULT_SITE_EWMA_ALPHA = 0.5


def routing_key(description_key: str, ceiling: int,
                ladder: tuple[int, ...]) -> str:
    """Stable digest naming one compiled-program family for routing
    purposes: the pipeline-description content key (see
    ``jterator.pipeline.description_digest``) plus the capacity ceiling
    and the resolved ladder (two runs of one description with different
    bucket specs route independently)."""
    blob = f"{description_key}|{int(ceiling)}|{tuple(int(c) for c in ladder)}"
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def observed_peak(key: str) -> "int | None":
    """Highest per-site object count recorded for ``key`` so far, or
    None when no batch of this program family has persisted yet."""
    with _ROUTING_LOCK:
        return _ROUTING_HISTORY.get(key)


def note_observed_peak(key: str, count: int) -> int:
    """Max-merge ``count`` into ``key``'s history (persist workers call
    this concurrently with the engine thread's routing reads); returns
    the new peak."""
    count = int(count)
    with _ROUTING_LOCK:
        prior = _ROUTING_HISTORY.get(key)
        peak = count if prior is None else max(prior, count)
        _ROUTING_HISTORY[key] = peak
        return peak


def note_site_counts(key: str, counts: "dict[int, float]",
                     alpha: "float | None" = None) -> None:
    """EWMA-merge one completed batch's per-site observed object counts
    into ``key``'s site history (persist workers call this concurrently
    with the scheduler's plan-time reads, same discipline as
    :func:`note_observed_peak`).  First observation of a site seeds the
    EWMA directly."""
    if not counts:
        return
    a = DEFAULT_SITE_EWMA_ALPHA if alpha is None else float(alpha)
    a = min(1.0, max(0.0, a))
    with _ROUTING_LOCK:
        table = _SITE_HISTORY.setdefault(key, {})
        for site, count in counts.items():
            site = int(site)
            prior = table.get(site)
            value = float(count)
            table[site] = value if prior is None else (
                a * value + (1.0 - a) * prior
            )


def seed_site_counts(key: str, counts: "dict[int, float]") -> int:
    """Fill ``key``'s site history from persisted prior-run evidence
    (feature shards harvested before ``delete_previous_output`` wipes
    them) WITHOUT disturbing live EWMA state — only sites with no entry
    yet are seeded.  Returns the number of sites newly seeded."""
    seeded = 0
    with _ROUTING_LOCK:
        table = _SITE_HISTORY.setdefault(key, {})
        for site, count in counts.items():
            site = int(site)
            if site not in table:
                table[site] = float(count)
                seeded += 1
    return seeded


def site_count_snapshot(key: str) -> "dict[int, float]":
    """Copy of ``key``'s per-site EWMA table — the scheduler's plan is a
    pure function of this snapshot plus the site list (determinism
    contract, tests/test_schedule.py)."""
    with _ROUTING_LOCK:
        return dict(_SITE_HISTORY.get(key, {}))


def routing_history_snapshot() -> dict[str, int]:
    """A copy of the per-program peak table (status and debug surfaces)."""
    with _ROUTING_LOCK:
        return dict(_ROUTING_HISTORY)


def reset_routing_history() -> None:
    """Drop all routing history (tests, fresh benchmarking runs)."""
    with _ROUTING_LOCK:
        _ROUTING_HISTORY.clear()
        _SITE_HISTORY.clear()
