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

The reference also emits spans, telemetry gauges, fault-injection
hooks, a phase watchdog, a graceful drain on preemption and
compile-ahead warming; the port keeps plain per-phase wall times
(:class:`PipelineStats`) and none of the rest yet (ROADMAP A item 11).
"""

from __future__ import annotations

import collections
import concurrent.futures
import logging
import threading
import time
from typing import Any, Callable, Iterable, Iterator

import torch

logger = logging.getLogger(__name__)

#: the executor's phases, in the order a batch passes them
PIPELINE_PHASES = ("prefetch_wait", "dispatch", "device_block", "persist")

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
    (``"cli"``), else the per-device default (``"default"``): 8 on the
    card, 2 on the CPU, the reference's two defaults.  The port has no
    install setting and no tuning sweep of the card yet."""
    if explicit is not None and int(explicit) > 0:
        return max(1, int(explicit)), "cli"
    kind = torch.device(device).type if device is not None else "cuda"
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


class PipelineStats:
    """Wall times of the executor's phases, summed over batches
    (``summary()`` has the reference's ``pipeline_stats`` keys: ``depth``,
    ``source``, ``n_batches``, ``phases`` with ``total_s``/``max_s``/
    ``count``, ``depth_clamps``) and per batch (``per_batch()``).
    Thread-safe: dispatch is timed on the calling thread, device block
    and persist on the persist worker."""

    def __init__(self, depth: int, source: str = "explicit"):
        self.depth = int(depth)
        self.source = source
        self._lock = threading.Lock()
        self._phases = {p: [0.0, 0.0, 0] for p in PIPELINE_PHASES}
        self._batches = 0
        self._clamps: list[dict] = []
        self._per_batch: dict = {}

    def record(self, phase: str, seconds: float, batch=None) -> None:
        with self._lock:
            acc = self._phases[phase]
            acc[0] += seconds
            acc[1] = max(acc[1], seconds)
            acc[2] += 1
            if batch is not None:
                times = self._per_batch.setdefault(batch, {})
                times[phase] = times.get(phase, 0.0) + seconds

    def per_batch(self) -> dict:
        """``{batch index: {phase: seconds}}`` in the order batches began."""
        with self._lock:
            return {b: dict(t) for b, t in self._per_batch.items()}

    def batch_done(self) -> None:
        with self._lock:
            self._batches += 1

    def record_clamp(self, from_depth: int, to_depth: int) -> None:
        with self._lock:
            self._clamps.append({"from": int(from_depth), "to": int(to_depth)})
            self.depth = int(to_depth)

    def summary(self) -> dict:
        with self._lock:
            return {
                "depth": self.depth,
                "source": self.source,
                "n_batches": self._batches,
                "phases": {
                    p: {"total_s": total, "max_s": peak, "count": n}
                    for p, (total, peak, n) in self._phases.items() if n
                },
                "depth_clamps": list(self._clamps),
            }


class PipelinedExecutor:
    """Bounded in-flight window over a step's launch/persist split.

    ``run(batches)`` is a generator of ``(batch, result)`` in submission
    order; ``stats`` is an optional :class:`PipelineStats`;
    ``on_event(**event)`` receives ``depth_clamped`` events.  One persist
    worker drains the window in submission order."""

    def __init__(
        self,
        step,
        depth: int | None = None,
        stats: PipelineStats | None = None,
        on_event: Callable[..., None] | None = None,
    ):
        if depth is None:
            depth, _ = resolve_pipeline_depth(None, getattr(step, "device", None))
        self.step = step
        self.depth = max(1, int(depth))
        self.stats = stats
        self.on_event = on_event

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

    # --------------------------------------------------------------- window
    def _run_window(self, batches: list[dict]) -> Iterator[tuple[dict, dict]]:
        step = self.step
        stats = self.stats

        def timed(phase: str, idx, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            if stats is not None:
                stats.record(phase, time.perf_counter() - t0, idx)
            return out

        prefetcher = None
        if hasattr(step, "prefetch_batch") and len(batches) > 1:
            prefetcher = concurrent.futures.ThreadPoolExecutor(
                max_workers=min(self.depth, 4, len(batches)),
                thread_name_prefix="tmx-prefetch",
            )
        persister = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="tmx-persist"
        )
        # launched-but-not-yet-yielded batches, in submission order
        window: collections.deque = collections.deque()
        prefetched: dict[int, concurrent.futures.Future] = {}

        def persist_task(eff: dict, ctx, idx) -> dict:
            if hasattr(step, "block_batch"):
                timed("device_block", idx, step.block_batch, ctx)
            result = timed("persist", idx, step.persist_batch, eff, ctx)
            if stats is not None:
                stats.batch_done()
            return result

        def pop_one() -> tuple[dict, dict]:
            batch, fut = window.popleft()
            return batch, fut.result()

        try:
            for i, batch in enumerate(batches):
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
                    eff, ctx = timed("dispatch", idx, step.launch_batch, batch, pre)
                except Exception:
                    # drain the WHOLE window before the failure propagates
                    while window:
                        yield pop_one()
                    raise
                window.append((batch, persister.submit(
                    persist_task, batch if eff is None else eff, ctx, idx
                )))
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
            persister.shutdown(wait=True)
