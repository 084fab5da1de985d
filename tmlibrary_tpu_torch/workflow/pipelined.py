"""Pipelined batch executor: a bounded window of launched batches with
threaded prefetch and persist.

Counterpart: ``tmlibrary_tpu/workflow/pipelined.py``.  A CUDA launch
returns before the card is done, so keeping a window of launched batches
in flight hides the store IO of one batch behind the device work of
another.  A step opts in through the launch/persist split:

- ``prefetch_batch(batch)`` (optional): host-side input loading only
  (store reads, illumination statistics, shift tables), safe on a worker
  thread ahead of dispatch.
- ``launch_batch(batch, prefetched=None) -> (effective_batch, ctx)``:
  dispatch on the calling thread; ``ctx`` holds the un-fetched results.
- ``block_batch(ctx)`` (optional): wait until the launched work is done,
  so the device-block phase is timed apart from the writes.
- ``persist_batch(effective_batch, ctx) -> result``: fetch and write.

Semantics (the same as the reference's):

- **Ordering**: ``run()`` yields ``(batch, result)`` strictly in
  submission order.
- **Window drain**: a launch failure first persists and yields every
  already-launched batch, then propagates.
- **Depth auto-clamp**: an out-of-memory failure at depth > 1 drains the
  window, halves the depth, records the clamp in the stats, reports a
  ``depth_clamped`` event through ``on_event`` (the engine appends it
  to the run ledger) and retries the failed batch at the lower depth.
- **Bit-identity**: dispatch happens on the calling thread in batch
  order and one persist worker drains in submission order.

- **Graceful drain**: ``should_stop`` is polled before each launch;
  when it trips, every launched batch persists and yields, then
  :class:`PreemptedError` carries the drain summary out.
- **Telemetry and faults**: with telemetry on, each batch's phases are
  ``span`` events (emitted through ``on_event`` on the calling thread,
  just before the batch is yielded), ``tmx_pipeline_phase_seconds``
  histograms and the ``tmx_pipeline_inflight`` gauge; the phase
  statistics are :class:`~tmlibrary_tpu_torch.profiling.PipelineStats`;
  the ``persist`` fault site fires inside the persist phase; a
  ``watchdog`` (:class:`~tmlibrary_tpu_torch.resilience.PhaseWatchdog`)
  arms the launch, block and persist phases.  While a device trace runs,
  each dispatch is a ``batch:<index>`` range
  (:func:`~tmlibrary_tpu_torch.telemetry.trace_range`).
- **Several ranks** (``agree``, the engine's rank agreement): the
  window persists on the calling thread, so every collective of a
  launch and of a persist (the escalation's re-launch) is issued from
  one thread in submission order on every rank.  The ``persist`` fault
  site's outcome goes through ``agree`` before the persist's first
  collective, so every rank persists the batch or none does; and a
  batch whose launch or persist raises is yielded as
  ``(batch, BatchFailure)`` in its turn instead of ending the window, so
  rank 0 can decide its retry for every rank.  There is no depth clamp
  then: an out-of-memory batch is a failure like any other.

The depth is an explicit request, else the cuda-scoped tuning verdict
(:func:`tmlibrary_tpu_torch.tuning.tuned_pipeline_depth`), else the
per-device default.  Not ported: the reference's compile-ahead warming
(the port compiles nothing per capacity rung).
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import logging
import time
from typing import Any, Callable, Iterable, Iterator

import torch

from tmlibrary_tpu_torch import faults, telemetry, tuning
from tmlibrary_tpu_torch.errors import FaultInjected, PreemptedError
from tmlibrary_tpu_torch.profiling import (  # noqa: F401 — the executor's stats, here too
    PHASE_RESOURCE,
    PIPELINE_PHASES,
    PipelineStats,
)

logger = logging.getLogger(__name__)


_NULL_CM = contextlib.nullcontext()

#: messages that signal memory pressure from too-deep pipelining
_RESOURCE_PATTERNS = (
    "resource_exhausted",
    "resource exhausted",
    "out of memory",
)


def is_resource_exhausted(exc: BaseException) -> bool:
    """True when the error is memory pressure: the one failure class
    where reducing the in-flight depth is the fix, not a retry."""
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    msg = str(exc).lower()
    return any(p in msg for p in _RESOURCE_PATTERNS)


def supports_pipelining(step) -> bool:
    """A step drives through :class:`PipelinedExecutor` when it exposes
    the launch/persist split."""
    return hasattr(step, "launch_batch") and hasattr(step, "persist_batch")


def resolve_pipeline_depth(
    explicit: int | None = None, device: "str | torch.device | None" = None
) -> tuple[int, str]:
    """The in-flight depth and where it came from: an explicit request
    (``"cli"``), else on the card the tuning verdict measured on the card
    (``"tuning"``; a verdict of another backend sets nothing), else the
    per-device default (``"default"``): 8 on the card, 2 on the CPU, the
    reference's two defaults.  The port has no install setting for it."""
    if explicit is not None and int(explicit) > 0:
        return max(1, int(explicit)), "cli"
    kind = torch.device(device).type if device is not None else "cuda"
    if kind != "cpu":
        tuned = tuning.tuned_pipeline_depth(kind)
        if tuned:
            return tuned, "tuning"
    return (8 if kind == "cuda" else 2), "default"


def prefetch_iter(
    items: Iterable[Any],
    load: Callable[[Any], Any],
    depth: int = 2,
) -> Iterator[Any]:
    """Yield ``load(item)`` for every item IN ORDER, with up to ``depth``
    loads running ahead on worker threads (corilla reads its site chunks
    through it).  A loader exception surfaces at the failing item."""
    items = list(items)
    depth = max(1, int(depth))
    if len(items) <= 1:
        for item in items:
            yield load(item)
        return
    pool = concurrent.futures.ThreadPoolExecutor(
        max_workers=min(depth, len(items)), thread_name_prefix="tmx-prefetch"
    )
    futures: collections.deque = collections.deque()
    try:
        pos = 0
        while pos < len(items) or futures:
            while pos < len(items) and len(futures) < depth:
                futures.append(pool.submit(load, items[pos]))
                pos += 1
            yield futures.popleft().result()
    finally:
        for f in futures:
            f.cancel()
        pool.shutdown(wait=True)


class BatchFailure:
    """A launch or persist that raised, yielded in the batch's turn when
    the executor captures errors (several ranks)."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


class _Deferred:
    """A persist run on the calling thread when its batch is popped (the
    inline window of several ranks), with a future's ``result()``."""

    def __init__(self, fn, *args):
        self._fn, self._args = fn, args

    def result(self):
        return self._fn(*self._args)


class PipelinedExecutor:
    """Bounded in-flight window over a step's launch/persist split.

    ``run(batches)`` is a generator of ``(batch, result)`` in submission
    order; ``stats`` is an optional :class:`PipelineStats`;
    ``on_event(**event)`` receives ``depth_clamped`` and ``span`` events.
    ``should_stop`` is polled before each launch; ``watchdog`` arms the
    launch/block/persist phases.  One persist worker drains the window
    in submission order.  With ``agree`` (several ranks: ``agree(err)``
    raises on every rank when the ``persist`` fault site fired on any)
    the calling thread persists each batch as it pops it, and a batch
    whose launch or persist raises is yielded with a
    :class:`BatchFailure`."""

    def __init__(
        self,
        step,
        depth: int | None = None,
        stats: PipelineStats | None = None,
        on_event: Callable[..., None] | None = None,
        should_stop: Callable[[], bool] | None = None,
        watchdog=None,
        agree: Callable[[BaseException | None], None] | None = None,
    ):
        if depth is None:
            depth, _ = resolve_pipeline_depth(None, getattr(step, "device", None))
        self.step = step
        self.depth = max(1, int(depth))
        self.stats = stats
        self.on_event = on_event
        self.should_stop = should_stop
        self.watchdog = watchdog
        self.agree = agree

    # ------------------------------------------------------------------ run
    def run(self, batches: Iterable[dict]) -> Iterator[tuple[dict, dict]]:
        batches = list(batches)
        pos = 0
        while pos < len(batches):
            try:
                for out in self._run_window(batches[pos:]):
                    pos += 1
                    yield out
                return
            except Exception as exc:  # noqa: BLE001 — classified below
                if self.depth > 1 and is_resource_exhausted(exc):
                    new_depth = max(1, self.depth // 2)
                    failing = batches[pos]["index"] if pos < len(batches) else None
                    logger.warning(
                        "pipelined executor: %s at depth %d — clamping to "
                        "depth %d and retrying batch %s",
                        exc, self.depth, new_depth, failing,
                    )
                    if self.on_event is not None:
                        self.on_event(event="depth_clamped", from_depth=self.depth,
                                      to_depth=new_depth, batch=failing, error=str(exc))
                    if self.stats is not None:
                        self.stats.record_clamp(self.depth, new_depth)
                    self.depth = new_depth
                    continue  # _run_window drained: pos is the failed batch
                raise

    # ---------------------------------------------------------------- spans
    def _flush_spans(self, batch: dict) -> None:
        """The buffered phase times of a finished batch as ``span``
        events, on the calling thread, before the batch is yielded."""
        if self.stats is None or self.on_event is None:
            return
        idx = batch.get("index")
        if idx is None:
            return
        for phase, seconds, t0 in self.stats.pop_batch_spans(idx):
            self.on_event(event="span", span=phase, batch=idx, t0=round(t0, 6),
                          elapsed=round(seconds, 6),
                          resource=PHASE_RESOURCE.get(phase, "host"))

    # --------------------------------------------------------------- window
    def _run_window(self, batches: list[dict]) -> Iterator[tuple[dict, dict]]:
        step = self.step
        stats = self.stats
        step_name = getattr(step, "name", "") or "unknown"
        watchdog = self.watchdog

        def armed(phase: str, idx):
            return _NULL_CM if watchdog is None else watchdog.arm(phase, step=step_name,
                                                                   batch=idx)

        def timed(phase: str, idx, fn, *args, arm: str | None = None):
            w0 = time.time()
            t0 = time.perf_counter()
            with armed(arm, idx) if arm else _NULL_CM:
                out = fn(*args)
            if stats is not None:
                stats.record(phase, time.perf_counter() - t0, idx, t0=w0)
            return out

        prefetcher = None
        if hasattr(step, "prefetch_batch") and len(batches) > 1:
            prefetcher = concurrent.futures.ThreadPoolExecutor(
                max_workers=min(self.depth, 4, len(batches)),
                thread_name_prefix="tmx-prefetch",
            )
        capture = self.agree is not None
        persister = None if capture else concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="tmx-persist")
        submit = _Deferred if persister is None else persister.submit

        def captured(exc: Exception):
            if not capture or (isinstance(exc, FaultInjected) and exc.fatal):
                raise exc
            return BatchFailure(exc)
        # launched-but-not-yet-yielded batches, in submission order
        window: collections.deque = collections.deque()
        prefetched: dict[int, concurrent.futures.Future] = {}

        def persist(eff: dict, ctx, idx) -> dict:
            # a fault after the device work, before the outputs are durable
            if not capture:
                faults.maybe_fire("persist", step=step_name, batch=idx)
                return step.persist_batch(eff, ctx)
            # agreed before the persist's collectives, which a rank that
            # failed here would leave the others waiting in
            err = None
            try:
                faults.maybe_fire("persist", step=step_name, batch=idx)
            except Exception as exc:
                if isinstance(exc, FaultInjected) and exc.fatal:
                    raise
                err = exc
            self.agree(err)
            return step.persist_batch(eff, ctx)

        def persist_task(eff: dict, ctx, idx) -> dict:
            try:
                if hasattr(step, "block_batch"):
                    timed("device_block", idx, step.block_batch, ctx, arm="block")
                result = timed("persist", idx, persist, eff, ctx, idx, arm="persist")
            except Exception as exc:
                return captured(exc)
            if stats is not None:
                stats.batch_done()
            return result

        def note_inflight() -> None:
            if telemetry.enabled():
                telemetry.get_registry().gauge("tmx_pipeline_inflight",
                                               step=step_name).set(len(window))

        def pop_one() -> tuple[dict, dict]:
            batch, fut = window.popleft()
            note_inflight()
            result = fut.result()
            self._flush_spans(batch)
            return batch, result

        try:
            for i, batch in enumerate(batches):
                if self.should_stop is not None and self.should_stop():
                    # drain: every launched batch persists and yields
                    # (the caller ledgers each), then the summary
                    n0 = len(window)
                    drained = 0
                    while window:
                        yield pop_one()
                        drained += 1
                    raise PreemptedError(
                        f"preempted before batch {batch.get('index', i)}: drained "
                        f"{drained}/{n0} in-flight, abandoned {len(batches) - i} un-launched",
                        step=step_name, in_flight=n0, drained=drained,
                        abandoned=len(batches) - i)
                if prefetcher is not None:
                    # keep up to `depth` loads ahead of the dispatch point
                    for j in range(i, min(i + self.depth, len(batches))):
                        if j not in prefetched:
                            prefetched[j] = prefetcher.submit(
                                step.prefetch_batch, batches[j]
                            )
                idx = batch.get("index", i)
                try:
                    pre = None
                    if i in prefetched:
                        pre = timed("prefetch_wait", idx, prefetched.pop(i).result)
                    with telemetry.trace_range(f"batch:{idx}"):
                        eff, ctx = timed("dispatch", idx, step.launch_batch, batch, pre,
                                         arm="launch")
                except Exception as exc:
                    if capture and not (isinstance(exc, FaultInjected) and exc.fatal):
                        # yielded in its turn: the caller decides its retry
                        window.append((batch, _Deferred(BatchFailure, exc)))
                        note_inflight()
                        while len(window) > self.depth:
                            yield pop_one()
                        continue
                    # drain the WHOLE window before the failure propagates
                    while window:
                        yield pop_one()
                    raise
                window.append((batch, submit(
                    persist_task, batch if eff is None else eff, ctx, idx
                )))
                note_inflight()
                while len(window) > self.depth:
                    yield pop_one()
            while window:
                yield pop_one()
        finally:
            for f in prefetched.values():
                f.cancel()
            if prefetcher is not None:
                prefetcher.shutdown(wait=False)
            # no persist worker may still be writing when the caller
            # re-runs the failed batch
            if persister is not None:
                persister.shutdown(wait=True)
