"""Profiling and tracing: the executor's phase statistics and device traces.

Counterpart: ``tmlibrary_tpu/profiling.py``.  The run ledger records
per-step and per-batch wall times (``workflow/engine.py``); this module
adds the pipelined executor's phase statistics and a device trace of a
block of work.

- :class:`PipelineStats` holds each phase's times in bounded-reservoir
  histograms (:class:`~tmlibrary_tpu_torch.telemetry.Histogram`, whose
  quantiles are the reference's), so ``summary()`` has the reference's
  keys: ``total_s``/``max_s``/``p50_s``/``p95_s``/``count`` per phase,
  rounded to 4 decimals, and ``device_s``/``host_s`` by
  :data:`PHASE_RESOURCE`, mirrored into the
  ``tmx_perf_{device,host}_seconds_total`` and ``tmx_perf_device_frac``
  gauges.  The port adds :meth:`PipelineStats.per_batch` and always
  reports ``depth_clamps`` (empty without a clamp).
- :func:`device_trace` runs ``torch.profiler`` where the reference runs
  ``jax.profiler``: CPU activities and, on a CUDA device, CUDA ones
  (CUPTI), written as a Chrome trace (``*.pt.trace.json``, for
  Perfetto, ``chrome://tracing`` or TensorBoard's profiler plugin) into
  the directory.  While it is active every telemetry span is also a
  ``torch.profiler.record_function`` range and, on the card, an NVTX
  range (:func:`~tmlibrary_tpu_torch.telemetry.set_trace_bridge`), so
  host spans line up with the device's kernels in the trace, and each
  program's first call in it is counted for the perf store's FLOPs and
  bytes (:func:`tmlibrary_tpu_torch.perf.counting`).
"""

from __future__ import annotations

import contextlib
import threading
from pathlib import Path

from tmlibrary_tpu_torch import telemetry

#: pipeline phases in execution order; keys of ``PipelineStats.summary()``
PIPELINE_PHASES = ("prefetch_wait", "dispatch", "device_block", "persist")

#: the resource each phase spends: the device/host split of ``tmx-torch
#: perf`` and of the ``tmx_perf_{device,host}_seconds_total`` gauges
PHASE_RESOURCE = {
    "prefetch_wait": "host",
    "dispatch": "device",
    "device_block": "device",
    "persist": "host",
}


class PipelineStats:
    """Per-batch phase timers of the pipelined batch executor.

    Each batch passes up to four phases (waiting on its prefetch, the
    dispatch on the calling thread, the wait on its device work, the
    writes) and the executor records each duration here.  The summary
    lands in the ``step_done`` ledger event as ``pipeline_stats`` and in
    ``workflow status``.  With telemetry on, the observations are
    mirrored into ``tmx_pipeline_phase_seconds`` histograms and each
    batch's (phase, seconds, t0) records are buffered for the executor to
    emit as ``span`` events.  Thread-safe: dispatch is timed on the
    calling thread, device block and persist on the persist worker."""

    def __init__(self, depth: int, source: str = "explicit", step: str = ""):
        self.depth = int(depth)
        self.source = source
        self.step = step
        self._lock = threading.Lock()
        self._hist = {p: telemetry.Histogram(p, {}) for p in PIPELINE_PHASES}
        reg = telemetry.get_registry()
        self._reg_hist = {p: reg.histogram("tmx_pipeline_phase_seconds",
                                           step=step or "unknown", phase=p)
                          for p in PIPELINE_PHASES}
        self._batches = 0
        self._clamps: list[dict] = []
        self._per_batch: dict = {}
        #: batch index -> [(phase, seconds, wall t0)], drained by the
        #: executor on the calling thread as ``span`` events
        self._batch_spans: dict = {}

    def record(self, phase: str, seconds: float, batch=None, t0: float | None = None) -> None:
        self._hist[phase].observe(seconds)
        self._reg_hist[phase].observe(seconds)
        if batch is None:
            return
        with self._lock:
            times = self._per_batch.setdefault(batch, {})
            times[phase] = times.get(phase, 0.0) + seconds
            if telemetry.enabled():
                self._batch_spans.setdefault(batch, []).append(
                    (phase, seconds, t0 if t0 is not None else 0.0))

    def pop_batch_spans(self, batch) -> list[tuple[str, float, float]]:
        """Drain the buffered phase records of ``batch``."""
        with self._lock:
            return self._batch_spans.pop(batch, [])

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
        """JSON-ready roll-up for the run ledger, with the reference's keys
        and rounding."""
        with self._lock:
            batches = self._batches
            clamps = list(self._clamps)
        phases = {}
        for phase in PIPELINE_PHASES:
            hist = self._hist[phase]
            if not hist.count:
                continue
            phases[phase] = {
                "total_s": round(hist.sum, 4),
                "max_s": round(hist.max, 4),
                "p50_s": round(hist.quantile(0.5), 4),
                "p95_s": round(hist.quantile(0.95), 4),
                "count": hist.count,
            }
        out = {"depth": self.depth, "source": self.source, "n_batches": batches,
               "phases": phases}
        split = {kind: sum(p["total_s"] for ph, p in phases.items()
                           if PHASE_RESOURCE.get(ph) == kind)
                 for kind in ("device", "host")}
        if phases:
            out["device_s"] = round(split["device"], 4)
            out["host_s"] = round(split["host"], 4)
            if telemetry.enabled():
                reg = telemetry.get_registry()
                label = self.step or "unknown"
                reg.gauge("tmx_perf_device_seconds_total", step=label).set(out["device_s"])
                reg.gauge("tmx_perf_host_seconds_total", step=label).set(out["host_s"])
                total = split["device"] + split["host"]
                if total > 0:
                    reg.gauge("tmx_perf_device_frac", step=label).set(
                        round(split["device"] / total, 4))
        out["depth_clamps"] = clamps
        return out


@contextlib.contextmanager
def device_trace(log_dir: "str | Path | None", device="cuda"):
    """Trace the block with ``torch.profiler`` when ``log_dir`` is set.

    A no-op (yielding None) when ``log_dir`` is None, so call sites pass
    the CLI flag straight through.  Otherwise it records CPU activities
    and, when ``device`` is a CUDA device, CUDA activities through CUPTI,
    and writes one Chrome trace ``<host>_<pid>.<ms>.pt.trace.json`` into
    ``log_dir`` when the block ends (also when it raises).  While the
    trace is active each telemetry span is a ``record_function`` range
    (and an NVTX range on the card) and first calls are counted
    (:func:`tmlibrary_tpu_torch.perf.counting`).  Yields the
    ``torch.profiler.profile`` (``key_averages()`` for a table)."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    from tmlibrary_tpu_torch import perf

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    telemetry.set_trace_bridge(True)
    try:
        with perf.counting(), profile(
                activities=activities,
                on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
            yield prof
    finally:
        telemetry.set_trace_bridge(False)
