"""Unified telemetry: metrics registry, span tracing, resource sampling.

Counterpart: ``tmlibrary_tpu/telemetry.py`` (the port keeps its own copy;
the reference's module imports JAX in three places, translated here):

* a process-wide :class:`MetricsRegistry` -- counters, gauges and
  bounded-reservoir histograms (p50/p95/max) -- fed by the workflow
  engine, the pipelined executor, ``resilience.py``, the serve daemon and
  the throughput-critical steps (corilla/illuminati/jterator);
* nested **spans** (run -> step -> batch -> phase) recorded as ``span``
  events in the run ledger; while :func:`set_trace_bridge` is on, each
  span is also an NVTX range (``torch.cuda.nvtx.range_push``/
  ``range_pop``), so host spans line up with an Nsight Systems trace of
  the card (the reference's ``jax.profiler.TraceAnnotation``);
* a :class:`ResourceSampler` daemon thread (RSS, open file handles and
  ``torch.cuda.memory_allocated`` summed over the visible cards, read
  only once CUDA is initialised: the sampler never initialises the card;
  ``None`` on a CPU run) that also keeps a heartbeat file fresh;
* per-device completion times (:func:`device_wall_times`): at one rank
  there is nothing sharded and the list is empty, as in the reference;
  under a process group of several ranks the jterator step records one
  CUDA event per rank and gathers the times on rank 0
  (:func:`tmlibrary_tpu_torch.parallel.distributed.rank_wall_times`);
* export surfaces: Prometheus textfile format and JSON, renderable from
  the live registry or derived post hoc from any ledger
  (:func:`registry_from_ledger`), plus a span-tree builder with
  critical-path annotation for ``trace``.

The Prometheus text, snapshots, merges and span trees equal the
reference's on the same inputs, byte for byte
(``tests/test_torch_telemetry.py``).  Telemetry costs nothing when
disabled: a disabled registry hands out shared null instruments whose
methods are no-ops, and :func:`span` yields without reading a clock.
Nothing here may perturb numeric results: a telemetry-on run stays
bit-identical to a telemetry-off run.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable, Iterable, Iterator

from tmlibrary_tpu_torch.errors import FaultInjected
from tmlibrary_tpu_torch.log import warn_once

logger = logging.getLogger(__name__)

#: cap on per-histogram reservoir samples; bounds memory for long runs
RESERVOIR_SIZE = 512

HEARTBEAT_FILENAME = "heartbeat.json"


# ---------------------------------------------------------------------------
# instruments


def _label_key(labels: dict[str, str]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-written instantaneous value."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Bounded-reservoir distribution: exact count/sum/max, sampled quantiles.

    The reservoir keeps the most recent :data:`RESERVOIR_SIZE` observations
    (ring buffer) — enough for stable p50/p95 on per-batch timings while
    bounding memory on runs with hundreds of thousands of batches.
    """

    __slots__ = ("name", "labels", "_lock", "_count", "_sum", "_max",
                 "_reservoir", "_next")

    def __init__(self, name: str, labels: dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._reservoir: list[float] = []
        self._next = 0

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._count += 1
            self._sum += value
            if value > self._max:
                self._max = value
            if len(self._reservoir) < RESERVOIR_SIZE:
                self._reservoir.append(value)
            else:
                self._reservoir[self._next] = value
                self._next = (self._next + 1) % RESERVOIR_SIZE

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def max(self) -> float:
        with self._lock:
            return self._max

    def quantile(self, q: float) -> float:
        with self._lock:
            sample = sorted(self._reservoir)
        if not sample:
            return 0.0
        idx = min(len(sample) - 1, max(0, int(round(q * (len(sample) - 1)))))
        return sample[idx]

    def summary(self) -> dict:
        with self._lock:
            sample = sorted(self._reservoir)
            count, total, vmax = self._count, self._sum, self._max
        out = {"count": count, "sum": round(total, 6), "max": round(vmax, 6)}
        if sample:
            def _q(q: float) -> float:
                idx = min(len(sample) - 1,
                          max(0, int(round(q * (len(sample) - 1)))))
                return round(sample[idx], 6)
            out["p50"] = _q(0.5)
            out["p95"] = _q(0.95)
        return out


class ThroughputTracker:
    """Units/sec gauge: units of work over ``time.perf_counter`` wall time.

    Call sites measure each batch with ``perf_counter`` and :meth:`add`
    ``(units, seconds)``; the gauge is cumulative units over cumulative
    seconds.
    """

    __slots__ = ("_gauge", "_counter", "_lock", "_seconds", "_units")

    def __init__(self, gauge: "Gauge | _NullGauge",
                 counter: "Counter | _NullCounter"):
        self._gauge = gauge
        self._counter = counter
        self._lock = threading.Lock()
        self._seconds = 0.0
        self._units = 0.0

    def add(self, units: float, seconds: float) -> None:
        with self._lock:
            self._units += units
            self._seconds += seconds
            rate = self._units / self._seconds if self._seconds > 0 else 0.0
        self._counter.inc(units)
        self._gauge.set(rate)


class _NullInstrument:
    """Shared no-op instrument for the disabled registry."""

    __slots__ = ()
    name = ""
    labels: dict[str, str] = {}
    value = 0.0
    count = 0
    sum = 0.0
    max = 0.0

    def inc(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def add(self, units: float, seconds: float = 0.0) -> None:
        pass

    def quantile(self, q: float) -> float:
        return 0.0

    def summary(self) -> dict:
        return {"count": 0, "sum": 0.0, "max": 0.0}


_NullCounter = _NullGauge = _NullHistogram = _NullInstrument
_NULL = _NullInstrument()


class MetricsRegistry:
    """Thread-safe, process-wide instrument store.

    When ``enabled`` is False every accessor returns the shared null
    instrument, so instrumented call sites cost one attribute lookup and a
    no-op method call — nothing allocates and no lock is taken.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._instruments: dict[tuple, Any] = {}
        self._trackers: dict[str, ThroughputTracker] = {}
        #: monotonic snapshot counter — with ``captured_at`` it makes
        #: every snapshot self-describing about its age, so the fleet
        #: merge can prefer the newer capture on gauge collisions
        self._sequence = 0

    def _get(self, cls, name: str, labels: dict[str, str]):
        if not self.enabled:
            return _NULL
        key = (cls.__name__, name, _label_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, labels)
                self._instruments[key] = inst
            return inst

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels: str) -> Histogram:
        return self._get(Histogram, name, labels)

    def throughput(self, name: str, **labels: str) -> ThroughputTracker:
        """Units/sec gauge ``<name>`` backed by counter ``<name>_units_total``."""
        if not self.enabled:
            return _NULL
        key = f"{name}|{_label_key(labels)}"
        with self._lock:
            tracker = self._trackers.get(key)
        if tracker is None:
            tracker = ThroughputTracker(
                self.gauge(name, **labels),
                self.counter(name + "_units_total", **labels),
            )
            with self._lock:
                tracker = self._trackers.setdefault(key, tracker)
        return tracker

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()
            self._trackers.clear()

    def snapshot(self) -> dict:
        """JSON-ready dump of every instrument, stable ordering.

        Stamped with ``captured_at`` (wall time) and a monotonic
        ``sequence`` so downstream consumers — the fleet merge's
        newer-capture-wins gauge fold, the time-series flush hook — can
        order captures without trusting file mtimes.  A disabled
        registry keeps the bare unstamped shape: it records nothing, so
        there is no capture to order."""
        out: dict[str, Any] = {"counters": [], "gauges": [], "histograms": []}
        if not self.enabled:
            return out
        with self._lock:
            instruments = sorted(self._instruments.items())
            self._sequence += 1
            seq = self._sequence
        out["captured_at"] = round(time.time(), 6)
        out["sequence"] = seq
        for (kind, _name, _labels), inst in instruments:
            entry = {"name": inst.name, "labels": dict(inst.labels)}
            if kind == "Counter":
                entry["value"] = inst.value
                out["counters"].append(entry)
            elif kind == "Gauge":
                entry["value"] = round(inst.value, 6)
                out["gauges"].append(entry)
            else:
                entry.update(inst.summary())
                out["histograms"].append(entry)
        return out


# ---------------------------------------------------------------------------
# module-level registry

_registry: MetricsRegistry | None = None
_registry_lock = threading.Lock()


def _default_enabled() -> bool:
    from tmlibrary_tpu_torch.config import cfg

    return bool(getattr(cfg, "telemetry", True))


def get_registry() -> MetricsRegistry:
    global _registry
    reg = _registry
    if reg is None:
        with _registry_lock:
            reg = _registry
            if reg is None:
                reg = _registry = MetricsRegistry(enabled=_default_enabled())
    return reg


def enabled() -> bool:
    return get_registry().enabled


def set_enabled(flag: bool) -> None:
    get_registry().enabled = bool(flag)


def reset_registry(enabled: bool | None = None) -> MetricsRegistry:
    """Replace the process registry (tests, fresh CLI runs)."""
    global _registry
    with _registry_lock:
        _registry = MetricsRegistry(
            enabled=_default_enabled() if enabled is None else enabled
        )
    return _registry


# ---------------------------------------------------------------------------
# fleet identity (multi-host label semantics)
#
# Label conventions for fleet-scope series (DESIGN.md §17):
#   host   — one value per process in the run ("host0", "host1", ...)
#   device — a local device id within a host ("0".."7")
#   step   — the workflow step that produced the observation
# The labels ride the existing instrument kwargs, so a disabled registry
# still hands out the shared null instrument: labeled metrics cost nothing
# when telemetry is off.


def host_id() -> str:
    """Stable identity of this process within a (possibly multi-host) run.

    Resolution order: explicit ``TMX_HOST_ID`` (the simulated-fleet knob
    CI uses), the standard ``JAX_PROCESS_ID`` a pod launcher exports
    (``parallel.distributed.initialize`` mirrors its resolved process id
    into the env), else ``host0``.  The port's ranks of one process group
    share one ledger, written by rank 0, so a rank is not a host here:
    a serve fleet names its hosts with ``TMX_HOST_ID`` (``serve run
    --host``).  Env-only on purpose: telemetry must never be the thing
    that initialises a device or a process group.
    """
    return os.environ.get("TMX_HOST_ID") or "host0"


def fleet_active() -> bool:
    """True when this process is one of several hosts of a fleet
    (``TMX_HOST_ID`` set).  Gates the per-event ``host`` field in the run
    ledger so single-host ledgers keep their seed-era shape."""
    return bool(os.environ.get("TMX_HOST_ID"))


@contextlib.contextmanager
def collective_span(name: str, **labels: str) -> Iterator[None]:
    """Bracket the host-side call that launches a collective (all-gather,
    all-reduce, halo exchange, reshard).

    Dispatch is async, so this times what the host actually pays to get
    the collective in flight — observed into
    ``tmx_collective_seconds{collective=...,host=...}``.  Zero-cost when
    telemetry is disabled: no clock is read and no instrument allocated.
    """
    if not enabled():
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        get_registry().histogram(
            "tmx_collective_seconds", collective=name, host=host_id(),
            **labels,
        ).observe(time.perf_counter() - t0)


def device_wall_times(t0: float, device: Any = None) -> list[tuple[str, float]]:
    """Per-device wall time (seconds since ``t0``, a ``perf_counter``
    reading taken at launch) until each rank's share of a batch is ready.

    At one rank nothing is sharded and this returns ``[]``, as the
    reference does for an unsharded program, so call sites fall through
    to a plain block.  Under a process group of several ranks each rank
    waits on a CUDA event recorded after its launches (on the CPU it
    reads the clock when its work has returned), and rank 0 gathers
    every rank's time, keyed by rank in rank order
    (:func:`tmlibrary_tpu_torch.parallel.distributed.rank_wall_times`);
    the other ranks get ``[]``.
    """
    from tmlibrary_tpu_torch.parallel import distributed

    if distributed.world_size() < 2:
        return []
    return distributed.rank_wall_times(t0, device)


def straggler_threshold(slowest: float) -> float:
    """Skew above which a batch counts as straggling: the larger of an
    absolute floor (``TMX_STRAGGLER_MIN_S``, default 0.05 s — CPU-sim
    noise stays below it) and a fraction of the slowest device's wall
    time (``TMX_STRAGGLER_REL``, default 0.25)."""
    try:
        floor = float(os.environ.get("TMX_STRAGGLER_MIN_S", "0.05"))
    except ValueError:
        floor = 0.05
    try:
        rel = float(os.environ.get("TMX_STRAGGLER_REL", "0.25"))
    except ValueError:
        rel = 0.25
    return max(floor, rel * float(slowest))


def record_device_times(times: list[tuple[str, float]], step: str = "",
                        batch: Any = None,
                        predicted: "list[float] | None" = None) -> float:
    """Feed per-device batch wall times into the labeled registry series
    and return the straggler skew (max − min over devices).

    Sets ``tmx_device_batch_seconds{device=,host=,step=}`` per device
    (plus a ``_hist`` histogram so p50/p95 survive the last-write gauge)
    and ``tmx_straggler_skew_seconds{host=,step=}``; bumps
    ``tmx_stragglers_total`` when the skew clears
    :func:`straggler_threshold`.  When the scheduler's ``predicted``
    per-shard work rides along (same order as ``times``), each device's
    prediction is published as
    ``tmx_device_predicted_work{device=,host=,step=}`` plus a predicted
    skew gauge — the pair lets the anomaly plane tell data skew
    (predicted AND actual both skewed) from a slow device (actual only).
    The *ledger* ``straggler`` event is the caller's job (the engine
    appends it on its own thread from the batch summary) — this function
    only touches the thread-safe registry, so it is safe from executor
    worker threads.
    """
    if not enabled() or not times:
        return 0.0
    reg = get_registry()
    h = host_id()
    step = step or "unknown"
    vals = [float(t) for _, t in times]
    skew = max(vals) - min(vals)
    pred = None
    if predicted is not None and len(predicted) == len(times):
        pred = [float(p) for p in predicted]
    for i, (dev, t) in enumerate(times):
        reg.gauge("tmx_device_batch_seconds", device=str(dev), host=h,
                  step=step).set(float(t))
        reg.histogram("tmx_device_batch_seconds_hist", device=str(dev),
                      host=h, step=step).observe(float(t))
        if pred is not None:
            reg.gauge("tmx_device_predicted_work", device=str(dev), host=h,
                      step=step).set(pred[i])
    reg.gauge("tmx_straggler_skew_seconds", host=h, step=step).set(skew)
    if pred is not None:
        reg.gauge("tmx_predicted_work_skew", host=h, step=step).set(
            max(pred) - min(pred)
        )
    if skew > straggler_threshold(max(vals)):
        reg.counter("tmx_stragglers_total", host=h, step=step).inc()
    return skew


# ---------------------------------------------------------------------------
# span tracing

_trace_bridge = threading.Event()


def set_trace_bridge(active: bool) -> None:
    """While on, every span is also an NVTX range
    (``torch.cuda.nvtx.range_push``/``range_pop``), so host spans line up
    with an Nsight Systems trace of the card; off (the default), a span
    touches no NVTX call."""
    if active:
        _trace_bridge.set()
    else:
        _trace_bridge.clear()


_span_local = threading.local()


def _span_stack() -> list[str]:
    stack = getattr(_span_local, "stack", None)
    if stack is None:
        stack = _span_local.stack = []
    return stack


@contextlib.contextmanager
def span(name: str, emit: Callable[..., Any] | None = None,
         **attrs: Any) -> Iterator[None]:
    """Nested host span; records a ``span`` ledger event via ``emit``.

    ``emit`` is typically ``RunLedger.append`` partial-applied with the
    step/batch context.  Zero-cost when telemetry is disabled.
    """
    if not enabled():
        yield
        return
    stack = _span_stack()
    stack.append(name)
    path = "/".join(stack)
    nvtx = None
    if _trace_bridge.is_set():
        import torch

        if torch.cuda.is_available():
            nvtx = torch.cuda.nvtx
            nvtx.range_push(path)
    t0 = time.time()
    p0 = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - p0
        if nvtx is not None:
            nvtx.range_pop()
        stack.pop()
        # a fatal injected fault simulates hard process death — a dead
        # process writes nothing, so the span must not land either (the
        # chaos suite pins that the torn ledger line stays trailing)
        exc = sys.exc_info()[1]
        if isinstance(exc, FaultInjected) and exc.fatal:
            emit = None
        if emit is not None:
            # a failed emit raises, as the ledger append it is (the
            # reference logs it at debug level and goes on)
            emit(event="span", span=name, path=path, t0=round(t0, 6),
                 elapsed=round(elapsed, 6), **attrs)


# ---------------------------------------------------------------------------
# trace context (request-scoped labels for the serving path)
#
# `tmx enqueue` stamps a trace_id into the job spec; the serve daemon opens
# a trace scope around each job execution, and RunLedger.append stamps the
# scope's labels onto every event it seals — so one trace id covers
# enqueue → admission → queue wait → run → step → batch → phase without
# threading job identity through every engine call site.  Process-level on
# purpose (not thread-local): the daemon executes one job at a time, while
# span events surface from executor worker threads that must inherit the
# job's identity.

_trace_ctx: dict[str, Any] = {}


def trace_context() -> dict[str, Any]:
    """The active trace labels (``trace_id``/``job``/``tenant``); empty
    outside a job scope."""
    return dict(_trace_ctx)


def set_trace_context(**labels: Any) -> None:
    """Replace the process trace labels (None values dropped; no labels
    clears the context)."""
    global _trace_ctx
    _trace_ctx = {k: v for k, v in labels.items() if v is not None}


@contextlib.contextmanager
def trace_scope(**labels: Any) -> Iterator[None]:
    """Install trace labels for the duration of one job execution,
    restoring the previous scope on exit (exception-safe)."""
    global _trace_ctx
    prev = _trace_ctx
    _trace_ctx = {**prev,
                  **{k: v for k, v in labels.items() if v is not None}}
    try:
        yield
    finally:
        _trace_ctx = prev


# ---------------------------------------------------------------------------
# flight recorder (bounded ring of the last N ledger events per process)
#
# Fed by RunLedger.append, dumped on watchdog fire / preemption drain /
# shed storm / unhandled crash so a post-mortem sees the exact event tail
# that preceded the incident even when the process died before sealing a
# snapshot.  Zero-cost when telemetry is disabled: no ring is allocated,
# no event is copied (shared null-instrument discipline).

_FLIGHT_DEFAULT_N = 256
_flight: "Any | None" = None  # collections.deque, lazily allocated
_flight_lock = threading.Lock()


def _flight_capacity() -> int:
    try:
        n = int(os.environ.get("TMX_FLIGHTREC_N", "") or _FLIGHT_DEFAULT_N)
    except ValueError:
        return _FLIGHT_DEFAULT_N
    return max(8, n)


def flight_record(event: dict) -> None:
    """Append one event to the flight-recorder ring (no-op when telemetry
    is disabled)."""
    if not enabled():
        return
    global _flight
    ring = _flight
    if ring is None:
        with _flight_lock:
            ring = _flight
            if ring is None:
                import collections

                ring = _flight = collections.deque(
                    maxlen=_flight_capacity()
                )
    ring.append(event)


def flight_events() -> list[dict]:
    """The ring's current contents, oldest first (tests/inspection)."""
    ring = _flight
    return list(ring) if ring else []


def reset_flight_recorder() -> None:
    """Drop the ring (tests, fresh daemon starts)."""
    global _flight
    with _flight_lock:
        _flight = None


def flight_dump(path: Path | str, reason: str = "",
                extra: dict | None = None) -> str | None:
    """Dump the ring to ``path`` via an atomic write; returns the path, or
    None when the ring is empty/unallocated.  A failed write raises (the
    reference logs it and returns None)."""
    ring = _flight
    if not ring:
        return None
    payload = {
        "host": host_id(),
        "pid": os.getpid(),
        "reason": reason or "manual",
        "dumped_at": round(time.time(), 6),
        "capacity": ring.maxlen,
        "events": list(ring),
    }
    if extra:
        payload.update(extra)
    from tmlibrary_tpu_torch.atomicio import atomic_write_json

    atomic_write_json(Path(path), payload)
    return str(path)


def flightrec_path(directory: Path | str) -> Path:
    """Canonical per-host dump location under a workflow/serve dir."""
    return Path(directory) / f"flightrec.{host_id()}.json"


# ---------------------------------------------------------------------------
# resource sampler


def _rss_bytes() -> int | None:
    try:
        with open("/proc/self/statm") as fh:
            fields = fh.read().split()
        return int(fields[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        try:
            import resource

            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        except Exception:  # pragma: no cover - non-POSIX
            return None


def _open_fds() -> int | None:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:  # pragma: no cover - non-Linux
        return None


def _device_memory_bytes() -> int | None:
    """``torch.cuda.memory_allocated`` summed over the visible cards;
    None on a CPU run.  Only read once CUDA is initialised: the sampler
    must never be the thing that initialises the card."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return sum(int(torch.cuda.memory_allocated(i))
               for i in range(torch.cuda.device_count()))


def heartbeat_path(workflow_dir: Path, host: str | None = None) -> Path:
    """Where this host's heartbeat lives: the legacy single-host name for
    ``host0`` (so existing status/watcher consumers keep working), a
    per-host ``heartbeat.<host>.json`` for every other fleet member."""
    h = host or host_id()
    if h == "host0":
        return Path(workflow_dir) / HEARTBEAT_FILENAME
    return Path(workflow_dir) / f"heartbeat.{h}.json"


def snapshot_path(workflow_dir: Path, host: str | None = None) -> Path:
    """This host's registry-snapshot file (``metrics.<host>.json``)."""
    return Path(workflow_dir) / f"metrics.{host or host_id()}.json"


def write_heartbeat(path: Path, period: float,
                    extra: dict | None = None) -> None:
    """Atomically write the heartbeat timestamp file (``atomicio`` —
    the PID-suffixed tmp name keeps concurrent writers from clobbering
    each other's staging file)."""
    from tmlibrary_tpu_torch.atomicio import atomic_write_json

    payload = {"ts": time.time(), "pid": os.getpid(), "period": period,
               "host": host_id()}
    if extra:
        payload.update(extra)
    atomic_write_json(path, payload)


def read_heartbeat(path: Path) -> dict | None:
    try:
        return json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return None


def heartbeat_age(path: Path, now: float | None = None) -> float | None:
    """Seconds since the heartbeat was last refreshed.

    Uses the fresher of the embedded writer timestamp and the file's
    mtime: on a shared filesystem the mtime comes from one clock while
    the embedded ``ts`` comes from the writing host's, so cross-host
    clock skew can make either look stale on its own — a LIVE run must
    never be flagged hung because two clocks disagree.  Both stale means
    genuinely stale.  Clamped at zero (a writer clock ahead of the
    reader's would otherwise go negative)."""
    hb = read_heartbeat(path)
    if hb is None or "ts" not in hb:
        return None
    now = time.time() if now is None else now
    age = now - float(hb["ts"])
    try:
        age = min(age, now - Path(path).stat().st_mtime)
    except OSError:
        pass
    return max(0.0, age)


class ResourceSampler:
    """Daemon thread sampling process/device resources on a fixed period.

    Each tick sets gauges (``tmx_process_rss_bytes``,
    ``tmx_process_open_fds``, ``tmx_device_bytes_in_use``) and refreshes the
    heartbeat file so ``workflow status`` and ``top``
    can tell a hung run from a slow one.
    """

    def __init__(self, period: float, heartbeat_path: Path | None = None,
                 registry: MetricsRegistry | None = None):
        self.period = max(float(period), 0.1)
        self.heartbeat_path = (
            Path(heartbeat_path) if heartbeat_path is not None else None
        )
        self.registry = registry if registry is not None else get_registry()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def sample_once(self) -> dict:
        sample: dict[str, Any] = {}
        rss = _rss_bytes()
        if rss is not None:
            sample["rss_bytes"] = rss
            self.registry.gauge("tmx_process_rss_bytes").set(rss)
        fds = _open_fds()
        if fds is not None:
            sample["open_fds"] = fds
            self.registry.gauge("tmx_process_open_fds").set(fds)
        dev = _device_memory_bytes()
        if dev is not None:
            sample["device_bytes_in_use"] = dev
            self.registry.gauge("tmx_device_bytes_in_use").set(dev)
        elif "torch" in sys.modules:
            # a CPU run has no card memory to report — say so once, not
            # every sample period (log.reset_warned clears the
            # suppression between tests)
            warn_once(
                logger, "resource-sampler-device-memory",
                "resource sampler: no card in use by this process (CPU "
                "run?) — tmx_device_bytes_in_use will not be exported",
            )
        if self.heartbeat_path is not None:
            try:
                write_heartbeat(self.heartbeat_path, self.period, extra=sample)
            except OSError:
                logger.debug("heartbeat write failed", exc_info=True)
        return sample

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.sample_once()
            except Exception:  # pragma: no cover - defensive
                logger.debug("resource sample failed", exc_info=True)
            self._stop.wait(self.period)

    def start(self) -> "ResourceSampler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="tmx-resource-sampler", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def __enter__(self) -> "ResourceSampler":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# export: Prometheus textfile + JSON


def _prom_escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_line(name: str, labels: dict[str, str], value: float,
               extra_labels: dict[str, str] | None = None) -> str:
    merged = dict(labels)
    if extra_labels:
        merged.update(extra_labels)
    if merged:
        inner = ",".join(
            f'{k}="{_prom_escape(str(v))}"' for k, v in sorted(merged.items())
        )
        return f"{name}{{{inner}}} {value:g}"
    return f"{name} {value:g}"


def render_prometheus(snapshot: dict) -> str:
    """Render a :meth:`MetricsRegistry.snapshot` as Prometheus textfile
    exposition format (counters, gauges, histograms-as-summaries)."""
    lines: list[str] = []
    seen_types: set[str] = set()

    def _header(name: str, kind: str) -> None:
        if name not in seen_types:
            seen_types.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for entry in snapshot.get("counters", []):
        _header(entry["name"], "counter")
        lines.append(_prom_line(entry["name"], entry["labels"], entry["value"]))
    for entry in snapshot.get("gauges", []):
        _header(entry["name"], "gauge")
        lines.append(_prom_line(entry["name"], entry["labels"], entry["value"]))
    for entry in snapshot.get("histograms", []):
        name = entry["name"]
        _header(name, "summary")
        labels = entry["labels"]
        for q_key, q in (("p50", "0.5"), ("p95", "0.95")):
            if q_key in entry:
                lines.append(
                    _prom_line(name, labels, entry[q_key], {"quantile": q})
                )
        lines.append(_prom_line(name + "_sum", labels, entry["sum"]))
        lines.append(_prom_line(name + "_count", labels, entry["count"]))
        lines.append(_prom_line(name + "_max", labels, entry["max"]))
    return "\n".join(lines) + "\n"


def render_json(snapshot: dict) -> str:
    return json.dumps(snapshot, indent=2, sort_keys=True)


def _prom_unescape(value: str) -> str:
    """Inverse of :func:`_prom_escape` (``\\\\``, ``\\"``, ``\\n``)."""
    out: list[str] = []
    i = 0
    while i < len(value):
        ch = value[i]
        if ch == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt in ('"', "\\"):
                out.append(nxt)
                i += 2
                continue
        out.append(ch)
        i += 1
    return "".join(out)


def _parse_label_body(body: str, lineno: int) -> dict[str, str]:
    """Escape-aware label-body scanner for :func:`parse_prometheus`.

    A naive ``split(",")`` mis-tokenizes any label *value* containing a
    comma, ``=`` or an escaped quote — all of which :func:`_prom_escape`
    legitimately produces — so rendered output would fail its own
    parser.  This scanner walks the quoted strings honoring the text
    format's three escapes (``\\\\``, ``\\"``, ``\\n``), making
    every rendered exposition round-trip exactly."""
    labels: dict[str, str] = {}
    i, n = 0, len(body)
    while i < n:
        if body[i] == ",":
            i += 1
            continue
        eq = body.find("=", i)
        if eq < 0:
            raise ValueError(f"line {lineno}: bad label body {body!r}")
        key = body[i:eq].strip()
        if not key:
            raise ValueError(f"line {lineno}: empty label name in {body!r}")
        i = eq + 1
        if i >= n or body[i] != '"':
            raise ValueError(f"line {lineno}: unquoted value for {key!r}")
        i += 1
        buf: list[str] = []
        closed = False
        while i < n:
            ch = body[i]
            if ch == "\\" and i + 1 < n:
                nxt = body[i + 1]
                if nxt == "n":
                    buf.append("\n")
                    i += 2
                    continue
                if nxt in ('"', "\\"):
                    buf.append(nxt)
                    i += 2
                    continue
                buf.append(ch)
                i += 1
                continue
            if ch == '"':
                closed = True
                i += 1
                break
            buf.append(ch)
            i += 1
        if not closed:
            raise ValueError(
                f"line {lineno}: unterminated value for {key!r}")
        if i < n and body[i] != ",":
            raise ValueError(
                f"line {lineno}: junk after value for {key!r}")
        labels[key] = "".join(buf)
    return labels


def parse_prometheus(text: str) -> list[tuple[str, dict[str, str], float]]:
    """Minimal exposition-format parser (used by tests to validate output).

    Returns ``(name, labels, value)`` samples; raises ``ValueError`` on any
    malformed line so tests can assert validity of the rendered output.
    """
    samples: list[tuple[str, dict[str, str], float]] = []
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) < 4 or parts[1] not in ("TYPE", "HELP"):
                raise ValueError(f"line {lineno}: bad comment {line!r}")
            continue
        name, labels, rest = line, {}, None
        if "{" in line:
            name, _, tail = line.partition("{")
            body, _, rest = tail.rpartition("}")
            if not rest or not rest.strip():
                raise ValueError(f"line {lineno}: bad sample {line!r}")
            labels = _parse_label_body(body, lineno)
        else:
            name, _, rest = line.partition(" ")
        if not name or not name.replace("_", "").replace(":", "").isalnum():
            raise ValueError(f"line {lineno}: bad metric name {name!r}")
        try:
            value = float(rest.strip().split()[0])
        except (ValueError, IndexError, AttributeError):
            raise ValueError(f"line {lineno}: bad value in {line!r}")
        samples.append((name, labels, value))
    return samples


# ---------------------------------------------------------------------------
# multi-host aggregation: per-host snapshots → one fleet view


def load_fleet_snapshots(run_root: Path) -> list[tuple[str, dict]]:
    """Discover per-host registry snapshots under a run root.

    Accepts the experiment-store root or its ``workflow/`` directory and
    returns sorted ``(host, snapshot)`` pairs from every readable
    ``metrics.<host>.json``.  The legacy single-host ``metrics.json``
    maps to ``host0`` and is skipped when a per-host host0 snapshot also
    exists (each host0 run writes both with identical content)."""
    root = Path(run_root)
    if (root / "workflow").is_dir():
        root = root / "workflow"
    hosts: dict[str, dict] = {}
    legacy: dict | None = None
    for path in sorted(root.glob("metrics*.json")):
        stem = path.name[len("metrics"):-len(".json")].strip(".")
        try:
            snap = json.loads(path.read_text())
        except (OSError, ValueError):
            logger.warning("skipping unreadable snapshot %s", path)
            continue
        if not isinstance(snap, dict):
            continue
        if stem:
            hosts[stem] = snap
        else:
            legacy = snap
    if legacy is not None and "host0" not in hosts:
        hosts["host0"] = legacy
    return sorted(hosts.items())


def merge_snapshots(
    host_snapshots: Iterable[tuple[str, dict]]
) -> dict:
    """Merge per-host :meth:`MetricsRegistry.snapshot` dumps into one
    fleet view.

    Every series gains a ``host`` label (a host label the series already
    carries wins, so device series recorded with explicit host labels
    are not re-tagged).  Series that still collide on (kind, name,
    labels) — the same host contributing twice — are folded: counters
    and histogram count/sum add, gauges keep the last value, max keeps
    the max, and histogram quantiles follow the larger sample.  The
    result renders through :func:`render_prometheus` /
    :func:`render_json` unchanged.

    Gauge collisions resolve by capture recency: snapshots stamp
    ``captured_at``/``sequence`` (:meth:`MetricsRegistry.snapshot`), and
    the newer capture's value wins regardless of the order the snapshot
    files were globbed in.  Un-stamped (pre-stamp-era) snapshots fall
    back to the old last-write-wins behavior."""
    out: dict[str, list] = {"counters": [], "gauges": [], "histograms": []}
    index: dict[tuple, dict] = {}
    stamps: dict[tuple, tuple] = {}
    for host, snap in host_snapshots:
        stamp = None
        if snap.get("captured_at") is not None:
            try:
                stamp = (float(snap["captured_at"]),
                         float(snap.get("sequence", 0) or 0))
            except (TypeError, ValueError):
                stamp = None
        for kind in ("counters", "gauges", "histograms"):
            for entry in snap.get(kind, []) or []:
                labels = dict(entry.get("labels") or {})
                labels.setdefault("host", str(host))
                key = (kind, entry.get("name"), _label_key(labels))
                merged = index.get(key)
                if merged is None:
                    merged = dict(entry)
                    merged["labels"] = labels
                    index[key] = merged
                    out[kind].append(merged)
                    if stamp is not None:
                        stamps[key] = stamp
                elif kind == "counters":
                    merged["value"] = (merged.get("value", 0.0)
                                       + entry.get("value", 0.0))
                elif kind == "gauges":
                    prev = stamps.get(key)
                    if stamp is None or prev is None or stamp >= prev:
                        merged["value"] = entry.get(
                            "value", merged.get("value", 0.0))
                        if stamp is None:
                            stamps.pop(key, None)
                        else:
                            stamps[key] = stamp
                else:
                    if entry.get("count", 0) > merged.get("count", 0):
                        for q in ("p50", "p95"):
                            if q in entry:
                                merged[q] = entry[q]
                    merged["count"] = (merged.get("count", 0)
                                       + entry.get("count", 0))
                    merged["sum"] = round(
                        merged.get("sum", 0.0) + entry.get("sum", 0.0), 6
                    )
                    merged["max"] = max(merged.get("max", 0.0),
                                        entry.get("max", 0.0))
    for kind in out:
        out[kind].sort(
            key=lambda e: (e.get("name", ""), sorted(e["labels"].items()))
        )
    return out


# ---------------------------------------------------------------------------
# ledger → metrics derivation (post-hoc inspection of any run, incl. seed-era)


def _observe_slo(reg: MetricsRegistry, tenant: str, outcome: str,
                 elapsed_s, hl: dict) -> None:
    """Feed the ``tmx_slo_*`` series from one job-completion event — the
    single definition both the live daemon and ledger replay use, so a
    replayed registry matches what the daemon showed (slo.py owns the
    objective/burn math; these are just the raw series)."""
    from tmlibrary_tpu_torch import slo

    slo.observe_job(reg, tenant, outcome, elapsed_s, **hl)


def registry_from_ledger(events: Iterable[dict]) -> MetricsRegistry:
    """Derive a metrics registry from run-ledger events.

    Works on seed-era ledgers (``batch_done``/``step_done`` only) as well
    as telemetry-era ledgers carrying ``span`` events — old runs stay
    inspectable with the same ``tmx metrics`` surface.  Fleet-era events
    carry a ``host`` field; those series gain a ``host`` label so
    interleaved multi-host ledgers aggregate without collisions, and
    exact-duplicate records (the same host's ledger read twice, or one
    physical event copied into several per-host ledgers) are dropped.
    """
    reg = MetricsRegistry(enabled=True)
    step_units: dict[tuple[str, str], dict[str, float]] = {}
    occ_acc = [0.0, 0.0]  # running (sum, n) of per-batch slot occupancy
    # running (routed capacity, ladder ceiling) sums: per batch the slot
    # ratio cap/ceiling is the padded-work fraction kept, so the sums
    # reconstruct padded-FLOPs-avoided from the ledger alone (batches
    # predating the bucket_ceiling field simply don't contribute)
    pad_acc = [0.0, 0.0]
    seen: set[tuple] = set()
    for ev in events:
        kind = ev.get("event")
        step = str(ev.get("step", "")) or "unknown"
        host = str(ev.get("host", "")) if ev.get("host") else ""
        if host:
            # dedup only host-attributed events: seed-era ledgers have no
            # host field and legitimately repeat (event, step) shapes
            fp = (host, ev.get("ts"), kind, step, ev.get("batch"),
                  ev.get("span"), ev.get("job"))
            if fp in seen:
                continue
            seen.add(fp)
        hl = {"host": host} if host else {}
        if kind == "run_started":
            reg.counter("tmx_runs_total", **hl).inc()
        elif kind == "batch_done":
            reg.counter("tmx_batches_done_total", step=step, **hl).inc()
            if "elapsed" in ev:
                reg.histogram("tmx_batch_seconds", step=step, **hl).observe(
                    float(ev["elapsed"])
                )
            attempts = int(ev.get("attempts", 1) or 1)
            if attempts > 1:
                reg.counter("tmx_batch_retries_total", step=step, **hl).inc(
                    attempts - 1
                )
            result = ev.get("result") or {}
            if isinstance(result, dict):
                acc = step_units.setdefault(
                    (step, host), {"units": 0.0, "seconds": 0.0}
                )
                acc["seconds"] += float(ev.get("elapsed", 0.0) or 0.0)
                for key in ("n_sites", "n_tiles"):
                    if key in result:
                        acc["units"] += float(result[key])
                        break
                else:
                    acc["units"] += 1.0
                # object-capacity bucket routing (capacity.py): batch
                # summaries self-describe their routed capacity + slot
                # occupancy, so ledger-derived metrics expose the same
                # gauges the live registry does
                cap = result.get("bucket_capacity")
                if cap is not None:
                    reg.counter(
                        "tmx_jterator_bucket_routed_total",
                        capacity=str(cap),
                    ).inc()
                    esc = int(result.get("bucket_escalations", 0) or 0)
                    if esc:
                        reg.counter(
                            "tmx_jterator_bucket_saturated_total"
                        ).inc(esc)
                    occ = result.get("slot_occupancy")
                    if occ is not None:
                        occ_acc[0] += float(occ)
                        occ_acc[1] += 1.0
                        reg.gauge("tmx_jterator_slot_occupancy").set(
                            occ_acc[0] / occ_acc[1]
                        )
                    ceiling = result.get("bucket_ceiling")
                    if ceiling:
                        pad_acc[0] += float(cap)
                        pad_acc[1] += float(ceiling)
                        reg.gauge(
                            "tmx_jterator_padded_flops_avoided_frac"
                        ).set(1.0 - pad_acc[0] / pad_acc[1])
                # fleet-era batch summaries embed per-device wall times
                # measured at block time, so ledger-derived metrics carry
                # the same device series the live registry does
                dev_times = result.get("device_wall_times")
                if isinstance(dev_times, dict) and dev_times:
                    for dev, secs in sorted(dev_times.items()):
                        reg.gauge(
                            "tmx_device_batch_seconds",
                            device=str(dev), step=step, **hl,
                        ).set(float(secs))
                skew = result.get("straggler_skew_s")
                if skew is not None:
                    reg.gauge(
                        "tmx_straggler_skew_seconds", step=step, **hl
                    ).set(float(skew))
        elif kind == "straggler":
            reg.counter("tmx_stragglers_total", step=step, **hl).inc()
            if "skew_s" in ev:
                reg.gauge(
                    "tmx_straggler_skew_seconds", step=step, **hl
                ).set(float(ev["skew_s"]))
        elif kind == "batch_failed":
            reg.counter("tmx_batches_failed_total", step=step, **hl).inc()
        elif kind in ("step_done", "step_partial"):
            if kind == "step_partial":
                reg.counter("tmx_steps_partial_total", step=step, **hl).inc()
            else:
                reg.counter("tmx_steps_done_total", step=step, **hl).inc()
            if "elapsed" in ev:
                reg.histogram("tmx_step_seconds", step=step, **hl).observe(
                    float(ev["elapsed"])
                )
            quarantined = ev.get("quarantined") or []
            if quarantined:
                reg.counter(
                    "tmx_batches_quarantined_total", step=step, **hl
                ).inc(len(quarantined))
            ps = ev.get("pipeline_stats")
            if isinstance(ps, dict):
                reg.gauge("tmx_pipeline_depth", step=step).set(
                    ps.get("depth", 0)
                )
                for phase, vals in (ps.get("phases") or {}).items():
                    reg.gauge(
                        "tmx_pipeline_phase_seconds_total",
                        step=step, phase=phase,
                    ).set(vals.get("total_s", 0.0))
                    reg.gauge(
                        "tmx_pipeline_phase_seconds_max",
                        step=step, phase=phase,
                    ).set(vals.get("max_s", 0.0))
        elif kind == "step_failed":
            reg.counter("tmx_steps_failed_total", step=step, **hl).inc()
        elif kind == "depth_clamped":
            reg.counter("tmx_depth_clamps_total", step=step, **hl).inc()
        elif kind == "backend_degraded":
            reg.counter("tmx_backend_degradations_total", **hl).inc()
        elif kind == "span":
            name = str(ev.get("span", "")) or "unknown"
            if "elapsed" in ev:
                reg.histogram("tmx_span_seconds", span=name, **hl).observe(
                    float(ev["elapsed"])
                )
        elif kind == "qc_batch":
            # QC summary gauge fields are run-cumulative at append time
            # (qc.QCSession.observe_batch), so replaying them with
            # last-write-wins gauge semantics reconstructs exactly what
            # the live registry showed
            s = ev.get("summary") or {}
            if isinstance(s, dict):
                for ch, entry in sorted((s.get("channels") or {}).items()):
                    if "focus_min" in entry:
                        reg.gauge("tmx_qc_worst_focus",
                                  channel=str(ch), **hl).set(
                            float(entry["focus_min"]))
                    if "saturation_max" in entry:
                        reg.gauge("tmx_qc_max_saturation_frac",
                                  channel=str(ch), **hl).set(
                            float(entry["saturation_max"]))
                    if "background_mean" in entry:
                        reg.gauge("tmx_qc_background_mean",
                                  channel=str(ch), **hl).set(
                            float(entry["background_mean"]))
                if "nan_columns" in s:
                    reg.gauge("tmx_qc_nan_columns", **hl).set(
                        float(s.get("nan_columns") or 0))
                bad = (int(s.get("nan_values") or 0)
                       + int(s.get("inf_values") or 0))
                if bad:
                    reg.counter("tmx_qc_nan_values_total", **hl).inc(bad)
                if "count_z_max" in s:
                    reg.gauge("tmx_qc_count_z_max", **hl).set(
                        float(s.get("count_z_max") or 0.0))
        elif kind == "qc_site":
            reg.counter("tmx_qc_sites_flagged_total", step=step, **hl).inc()
        elif kind == "qc_budget_exceeded":
            reg.counter("tmx_qc_budget_exceeded_total",
                        step=step, **hl).inc()
        elif kind == "first_batch":
            # cold-start attribution (engine.py): wall seconds from
            # run_started to the first persisted batch — the number the
            # aotstore warm path exists to shrink
            if "time_to_first_batch_s" in ev:
                reg.gauge("tmx_time_to_first_batch_seconds", **hl).set(
                    float(ev["time_to_first_batch_s"]))
        elif kind == "run_preempted":
            reg.counter("tmx_preemptions_total", **hl).inc()
        elif kind == "watchdog":
            reg.counter(
                "tmx_watchdog_fired_total", step=step,
                phase=str(ev.get("phase", "")) or "unknown", **hl,
            ).inc()
        elif kind in ("job_admitted", "job_rejected", "job_done",
                      "job_failed", "job_expired", "job_requeued",
                      "job_reclaimed", "stale_claim",
                      "job_started", "serve_preempted", "slo_burn",
                      "query_fused"):
            # serve-ledger events (serve.py): per-tenant admission /
            # outcome series, mirroring the daemon's live tmx_serve_*
            # and tmx_slo_* metrics so a serve ledger alone reconstructs
            # them (order-independent, like the fleet merge)
            if ev.get("kind") == "canary":
                # canary probes (canary.py) are invisible to tenants:
                # they feed their own tmx_canary_* series — never the
                # per-tenant serve counters and never the SLO series —
                # exactly as the live daemon records them
                if kind == "job_admitted":
                    reg.counter("tmx_canary_probes_total", **hl).inc()
                elif kind == "job_done":
                    reg.counter("tmx_canary_ok_total", **hl).inc()
                    if "elapsed_s" in ev:
                        reg.histogram("tmx_canary_latency_seconds",
                                      **hl).observe(float(ev["elapsed_s"]))
                    if ev.get("degraded"):
                        reg.counter("tmx_canary_degraded_total",
                                    **hl).inc()
                elif kind == "job_failed":
                    reg.counter("tmx_canary_failed_total", **hl).inc()
                continue
            tenant = str(ev.get("tenant", "")) or "unknown"
            if kind == "job_admitted":
                reg.counter("tmx_serve_admitted_total",
                            tenant=tenant, **hl).inc()
                if "queue_wait_s" in ev:
                    reg.histogram("tmx_serve_queue_wait_seconds",
                                  tenant=tenant, **hl).observe(
                        float(ev["queue_wait_s"]))
                if ev.get("affinity") == "hit":
                    # fleet affinity routing (serve.py): the claiming
                    # host's compiled-program cache was already warm
                    reg.counter("tmx_serve_affinity_hits_total",
                                tenant=tenant, **hl).inc()
            elif kind == "job_started":
                if "sched_delay_s" in ev:
                    reg.histogram("tmx_serve_sched_delay_seconds",
                                  tenant=tenant, **hl).observe(
                        float(ev["sched_delay_s"]))
            elif kind == "slo_burn":
                # warn-only breach events (slo.py) — same contract as QC
                reg.counter(
                    "tmx_slo_burn_total", tenant=tenant,
                    window=str(ev.get("window", "")) or "unknown", **hl,
                ).inc()
            elif kind == "job_rejected":
                reason = str(ev.get("reason", "")) or "unknown"
                reg.counter("tmx_serve_rejected_total", tenant=tenant,
                            reason=reason, **hl).inc()
                from tmlibrary_tpu_torch.workflow.admission import SHED_REASONS

                if reason in SHED_REASONS:
                    reg.counter("tmx_serve_shed_total",
                                tenant=tenant, **hl).inc()
            elif kind == "job_done":
                reg.counter("tmx_serve_jobs_done_total",
                            tenant=tenant, **hl).inc()
                if "elapsed_s" in ev:
                    reg.histogram("tmx_serve_job_seconds",
                                  tenant=tenant, **hl).observe(
                        float(ev["elapsed_s"]))
                _observe_slo(reg, tenant, "ok", ev.get("elapsed_s"), hl)
                # warm-start provenance (aotstore): done events carry the
                # job's cold-compile / store-import deltas; replayed
                # totals match the live ones summed across programs (the
                # live series carry a program label the ledger does not)
                if ev.get("compiles_cold"):
                    reg.counter("tmx_compile_cold_total", **hl).inc(
                        int(ev["compiles_cold"]))
                if ev.get("compile_imports"):
                    reg.counter("tmx_compile_import_hit_total", **hl).inc(
                        int(ev["compile_imports"]))
                if ev.get("kind") == "query" and ev.get("tool"):
                    # analytics query jobs (serve.py _run_query): replay
                    # the tmx_analytics_* series run_query fed live —
                    # the event carries the exact observed values
                    tool = str(ev["tool"])
                    cache = str(ev.get("cache", "")) or "unknown"
                    reg.counter("tmx_analytics_queries_total",
                                tool=tool, cache=cache, **hl).inc()
                    if cache == "hit":
                        reg.counter("tmx_analytics_cache_hits_total",
                                    tool=tool, **hl).inc()
                    if ev.get("query_elapsed_s") is not None:
                        reg.histogram("tmx_analytics_query_seconds",
                                      tool=tool, **hl).observe(
                            float(ev["query_elapsed_s"]))
                    reg.counter("tmx_analytics_jobs_total",
                                tenant=tenant, tool=tool, **hl).inc()
                    # index lifecycle: only miss events carry these (the
                    # one path that drove an index ensure), so replayed
                    # build/hit/fallback counts equal the live ones
                    if ev.get("index_cache") == "build":
                        reg.counter(
                            "tmx_analytics_index_builds_total").inc()
                    elif ev.get("index_cache") == "hit":
                        reg.counter(
                            "tmx_analytics_index_hits_total").inc()
                    if ev.get("index_fallback"):
                        reg.counter(
                            "tmx_analytics_index_fallbacks_total").inc()
            elif kind == "job_failed":
                reg.counter("tmx_serve_jobs_failed_total",
                            tenant=tenant, **hl).inc()
                _observe_slo(reg, tenant, "failed", None, hl)
            elif kind == "job_expired":
                reg.counter("tmx_serve_deadline_expired_total",
                            tenant=tenant, **hl).inc()
                _observe_slo(reg, tenant, "expired", None, hl)
            elif kind == "job_requeued":
                reg.counter("tmx_serve_requeued_total",
                            tenant=tenant, **hl).inc()
            elif kind == "job_reclaimed":
                # the reaper swept a dead host's leased job back to
                # incoming/ (serve.py _reclaim) — attempt preserved, so
                # no retry-budget series moves here
                reg.counter("tmx_serve_reclaims_total",
                            tenant=tenant, **hl).inc()
            elif kind == "stale_claim":
                # a fenced terminal transition: the claim epoch check
                # stopped a reclaimed job's first owner from publishing
                reg.counter("tmx_serve_stale_claims_total",
                            tenant=tenant, **hl).inc()
            elif kind == "query_fused":
                # one batched sweep served `window` query jobs (serve.py
                # _run_query fusion) — same series the daemon fed live
                window = float(ev.get("window") or 0)
                reg.counter("tmx_serve_query_fused_total",
                            **hl).inc(window)
                reg.histogram("tmx_serve_fusion_window",
                              **hl).observe(window)
            elif kind == "serve_preempted":
                reg.counter("tmx_serve_preemptions_total", **hl).inc()
        elif kind == "anomaly":
            # latched warn-only detector events (canary.py): same
            # counter the live daemon ticks, keyed by the degraded
            # signal stream
            reg.counter(
                "tmx_anomalies_total",
                metric=str(ev.get("metric", "")) or "unknown", **hl,
            ).inc()
        elif kind in ("init_done", "description_drift",
                      "serve_started"):
            pass  # known structural events with no metric series
        elif kind:
            # forward compatibility: a newer writer's ledger may carry
            # event kinds this checkout has never heard of — surface it
            # once per kind and keep deriving, never raise (an old
            # checkout must stay able to read a new ledger)
            warn_once(
                logger, f"ledger-kind:{kind}",
                "ignoring unknown ledger event kind '%s' (written by a "
                "newer version?)", kind,
            )
    for (step, host), acc in sorted(step_units.items()):
        if acc["seconds"] > 0:
            hl = {"host": host} if host else {}
            reg.gauge("tmx_step_units_per_sec", step=step, **hl).set(
                acc["units"] / acc["seconds"]
            )
    return reg


# ---------------------------------------------------------------------------
# span tree + critical path (tmx trace)


def build_span_tree(events: Iterable[dict]) -> dict:
    """Assemble the run → step → batch → phase tree from ledger events.

    Structure comes from event fields (``step``/``batch``/``span``), not
    from span nesting paths, so phase spans recorded on executor worker
    threads land under the right batch.  Ledgers without ``span`` events
    (seed-era) still produce a tree from ``batch_done``/``step_done``
    timing.
    """
    root: dict[str, Any] = {"name": "run", "elapsed": 0.0, "children": []}
    steps: dict[str, dict] = {}
    batches: dict[tuple[str, Any], dict] = {}

    def _step_node(step: str) -> dict:
        node = steps.get(step)
        if node is None:
            node = {"name": f"step:{step}", "elapsed": 0.0, "children": []}
            steps[step] = node
            root["children"].append(node)
        return node

    def _batch_node(step: str, batch: Any) -> dict:
        key = (step, batch)
        node = batches.get(key)
        if node is None:
            node = {"name": f"batch:{batch}", "elapsed": 0.0, "children": []}
            batches[key] = node
            _step_node(step)["children"].append(node)
        return node

    for ev in events:
        kind = ev.get("event")
        step = str(ev.get("step", "")) or "unknown"
        if kind == "span":
            name = str(ev.get("span", ""))
            elapsed = float(ev.get("elapsed", 0.0) or 0.0)
            if name == "run":
                root["elapsed"] = elapsed
            elif name == "step":
                _step_node(step)["elapsed"] = elapsed
            elif name == "batch":
                node = _batch_node(step, ev.get("batch"))
                node["elapsed"] = elapsed
            else:  # phase span (prefetch_wait/dispatch/device_block/persist)
                # batch-less phase spans (e.g. a compile attributed to
                # the step, not to one batch) stay OUT of the tree:
                # fabricating a "batch:None" node would miscount
                # batches, and nesting under the step would outweigh
                # every real batch on the critical path.  Compile cost
                # keeps its own surfaces (perf profiles, `tmx trace`
                # raw spans, the WARM row).
                if ev.get("batch") is None:
                    continue
                parent = _batch_node(step, ev["batch"])
                parent["children"].append(
                    {"name": f"phase:{name}", "elapsed": elapsed,
                     "children": []}
                )
        elif kind == "batch_done":
            node = _batch_node(step, ev.get("batch"))
            if not node["elapsed"]:
                node["elapsed"] = float(ev.get("elapsed", 0.0) or 0.0)
        elif kind in ("step_done", "step_partial"):
            node = _step_node(step)
            if not node["elapsed"]:
                node["elapsed"] = float(ev.get("elapsed", 0.0) or 0.0)
    if not root["elapsed"]:
        root["elapsed"] = round(
            sum(c["elapsed"] for c in root["children"]), 6
        )
    return root


def annotate_critical_path(node: dict) -> dict:
    """Mark the longest child at every level with ``critical: True``.

    The chain of critical nodes is the dominant cost path — for a
    pipelined step it identifies the phase the window spends its time in
    (matching the largest ``total_s`` in ``pipeline_stats``).
    """
    node.setdefault("critical", True)
    children = node.get("children") or []
    if children:
        longest = max(children, key=lambda c: c.get("elapsed", 0.0))
        for child in children:
            child["critical"] = child is longest
            if child is longest:
                annotate_critical_path(child)
            else:
                _clear_critical(child)
    return node


def _clear_critical(node: dict) -> None:
    node["critical"] = False
    for child in node.get("children") or []:
        _clear_critical(child)


def render_span_tree(node: dict, indent: int = 0) -> str:
    marker = "*" if node.get("critical") else " "
    lines = [
        f"{marker} {'  ' * indent}{node['name']:<24} "
        f"{node.get('elapsed', 0.0):10.4f}s"
    ]
    for child in node.get("children") or []:
        lines.append(render_span_tree(child, indent + 1))
    return "\n".join(lines)


def phase_totals(events: Iterable[dict]) -> dict[str, float]:
    """Sum phase-span durations per phase name (critical-path accounting
    cross-checkable against ``pipeline_stats`` totals)."""
    totals: dict[str, float] = {}
    for ev in events:
        if ev.get("event") != "span":
            continue
        name = str(ev.get("span", ""))
        if name in ("run", "step", "batch"):
            continue
        totals[name] = totals.get(name, 0.0) + float(ev.get("elapsed", 0.0))
    return totals
