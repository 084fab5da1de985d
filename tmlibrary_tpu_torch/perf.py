"""Performance attribution: the card's roofline, per-program costs, history.

Counterpart: ``tmlibrary_tpu/perf.py``.  Throughput alone cannot say
where the gap to the card's ceiling lives; this module is the one place
the port's cost model is read and judged.

- **Peaks** (:data:`CARD_PEAKS`, :func:`card_peaks`, :func:`backend_peaks`,
  :func:`ridge_point`): the published peaks of the card the process runs
  on, by its name (NVIDIA data sheets), where the reference holds v5e's.
  H100 SXM: 3.35 TB/s of HBM3, 67 TFLOP/s in float32 (no tensor cores)
  and 989 TFLOP/s dense in bf16.  The pipeline computes in float32, so
  the ridge (FLOPs a byte, 20 on H100 SXM) uses the float32 peak.
  :func:`card_peaks` records the card's power limit beside them
  (``nvidia-smi``), since a card set below its maximum runs slower.
- **The per-program store** (:func:`record_compile`,
  :func:`perf_profiles`, :func:`perf_snapshot`,
  :func:`pop_compile_spans`, :func:`reset_profiles`), keyed as the
  reference keys it: (program, step, capacity, strategy).  The port
  compiles nothing per program, so a "compile" is the first call of a
  program in the process (:func:`instrument_call`) and
  ``compile_seconds`` that call's host wall: it covers the kernel
  library's build or load (``ops/_cuda.py``), CUDA's lazy module loads
  and cuDNN's autotune of the DL configurations, and the device work
  only as far as the call waits for it.  The kernel library's own build
  or load is recorded as the program ``cuda_kernels`` of no step (no
  ledger span).  The first call is not wrapped: the cost is counted only
  when asked (:func:`counting`, which ``workflow submit --profile`` turns
  on), on the first call of each key while counting is on:

  - ``flops`` are counted by ``torch.utils.flop_counter.FlopCounterMode``'s
    formulas: the matmuls, convolutions and attention of the call,
    nothing else;
  - ``bytes`` are the input and output tensor bytes of each aten op on
    the program's device (views move nothing and count nothing), plus
    each hand-written kernel's modelled bytes (:func:`kernel_bytes`, the
    bytes behind PERF.md's ``bound_ms``: each input read once, each
    output written once) launched on the counting thread;

  both in one ``TorchDispatchMode`` (:func:`measure_call`), which waits
  for the device at the end of the call.

  The count leaves out the L2's reuse (every op's bytes count as if they
  came from HBM), the kernels' scratch beyond their model, and host
  copies.  Every other call takes the unwrapped path: with telemetry off
  the call is never wrapped at all.  ``bound_by`` is judged against the
  card's ridge, the mirrored ``tmx_perf_*`` series are the reference's,
  and the engine writes :func:`perf_snapshot` as ``workflow/perf.json``.
- **History** (:func:`bench_record_staleness`,
  :func:`set_bench_staleness_gauges`, :func:`compare_history` with exit
  codes 0-3 and the reference's backend and methodology classes,
  :func:`load_recapture`/:func:`write_recapture`/:func:`clear_recapture`),
  as the reference's; ``<backend>_cached`` records class with their
  backend (the reference knows only ``tpu_cached``).

Not ported, by decision: ``instrument_batch_fn``'s AOT
``lower().compile()``, ``cost_from_compiled``, ``speculate_compile``,
``adopt_executable`` and ``abstract_args``.  They read XLA's compiled
executables and compile capacity rungs ahead on a background thread;
the port has no compiled executable per program and nothing to compile
ahead, so there is nothing for them to do.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import re
import subprocess
import threading
import time
from typing import Any, Callable

import torch

from tmlibrary_tpu_torch import tuning
from tmlibrary_tpu_torch.atomicio import atomic_write_text

# ---------------------------------------------------------------------------
# Peaks

#: (name fragment, HBM bytes/s, float32 FLOP/s, dense bf16 FLOP/s) by card,
#: from NVIDIA's data sheets; the first match wins, and the SXM part is the
#: default for an unknown H100 name
CARD_PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H100 NVL", 3.9e12, 60e12, 835e12),
    ("H100", 3.35e12, 67e12, 989e12),
)
H100_SXM_HBM_BPS = CARD_PEAKS[-1][1]
H100_SXM_FP32_FLOPS = CARD_PEAKS[-1][2]

#: per-backend (peak FLOP/s, peak bytes/s) of the default card; the CPU has
#: no modelled roofline
BACKEND_PEAKS: dict[str, tuple[float, float]] = {
    "cuda": (H100_SXM_FP32_FLOPS, H100_SXM_HBM_BPS),
}


def backend_peaks(backend: str | None) -> tuple[float | None, float | None]:
    """(peak FLOP/s, peak bytes/s) for ``backend``; (None, None) where the
    backend has no modelled roofline (cpu, unknown)."""
    return BACKEND_PEAKS.get(str(backend).lower(), (None, None))


def ridge_point(peak_flops: float = H100_SXM_FP32_FLOPS,
                peak_bps: float = H100_SXM_HBM_BPS) -> float:
    """Arithmetic intensity (FLOPs a byte) where the roofline turns from
    memory- to compute-bound."""
    return peak_flops / peak_bps


@functools.lru_cache(maxsize=1)
def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reports it (``"700.00
    W"``), or None without ``nvidia-smi``; asked once a process (each
    run's ``perf.json`` carries it, and ``nvidia-smi`` takes a noticeable
    part of a second)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def card_peaks(name: str | None = None) -> dict:
    """The peaks of the card named ``name`` (default: card 0, when there
    is one) with the ridge in float32 and the power limit."""
    if name is None:
        name = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "H100"
    row = next((r for r in CARD_PEAKS if r[0] in name), CARD_PEAKS[-1])
    return {"name": name, "power_limit": power_limit(), "peak_hbm_bps": row[1],
            "peak_fp32_flops": row[2], "peak_bf16_flops": row[3],
            "ridge_flops_per_byte": ridge_point(row[2], row[1])}


# ---------------------------------------------------------------------------
# Cost model

@dataclasses.dataclass
class ProgramCost:
    """FLOPs and bytes of one program call; None where nothing was
    counted."""

    flops: float | None = None
    bytes: float | None = None

    @property
    def arithmetic_intensity(self) -> float | None:
        if self.flops is not None and self.bytes:
            return self.flops / self.bytes
        return None

    def bound_by(self, peak_flops: float = H100_SXM_FP32_FLOPS,
                 peak_bps: float = H100_SXM_HBM_BPS) -> str | None:
        """"memory" below the ridge, "compute" above, None without a
        count."""
        ai = self.arithmetic_intensity
        if ai is None:
            return None
        return "memory" if ai < peak_flops / peak_bps else "compute"


def kernel_bytes(name: str, tensors: tuple) -> int:
    """The modelled bytes of one launch of the hand-written kernel
    ``name`` on the tensors its launcher binds (inputs, then the output):
    rows 1-4 by PERF.md's model (``shootout.py``'s ``*_bytes``), the
    others as the bytes of the tensors bound."""
    first = tensors[0]
    if name == "fill_holes_flood":
        return first.numel() * (1 + 1)
    if name == "cc_min_propagate":
        return first.numel() * (1 + 4)
    if name == "watershed_flood":
        return first.numel() * (4 + 4 + 1 + 4)
    if name == "grouped_stats":
        labels, sums = tensors[0], tensors[2]
        k, c = sums.shape[-2], sums.shape[-1]
        kept = int(((labels >= 1) & (labels <= k)).sum())
        return labels.numel() * 4 + kept * c * 4 + 3 * labels.shape[0] * k * c * 4
    return sum(t.numel() * t.element_size() for t in tensors)


#: the kernel launches of the call each thread counts: ``launches`` is a
#: list of (name, tensors) while :func:`measure_call` runs on the thread
_COUNTING = threading.local()


def note_kernel_launch(name: str, tensors: tuple) -> None:
    """Called by :func:`tmlibrary_tpu_torch.ops._cuda.bind_launch` at each
    counted launch; keeps the launch while the calling thread counts a
    call (a launch on another thread belongs to another program)."""
    launches = getattr(_COUNTING, "launches", None)
    if launches is not None:
        launches.append((name, tensors))


def _tensor_bytes(values, dev_type: str) -> int:
    """Bytes of the tensors among ``values`` (and in lists among them) on
    devices of type ``dev_type``."""
    total = 0
    for v in values:
        for t in (v if isinstance(v, (list, tuple)) else (v,)):
            if isinstance(t, torch.Tensor) and t.device.type == dev_type:
                total += t.numel() * t.element_size()
    return total


def measure_call(fn: Callable, *args, device="cuda", **kwargs) -> tuple[Any, ProgramCost, float]:
    """``fn(*args, **kwargs)`` once under one counting dispatch mode: its
    result, its :class:`ProgramCost` and its wall seconds (on the card,
    until its device work is done).  FLOPs are ``FlopCounterMode``'s
    formulas (``torch.utils.flop_counter.flop_registry``) applied in the
    same mode that counts the bytes (``FlopCounterMode`` itself, a
    second mode, costs several times as much a call); every op passes
    through, so the result is the one an uncounted call gives."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    dev_type = torch.device(device).type
    counts = {"flops": 0, "bytes": 0}

    def count(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            counts["flops"] += formula(*args, **kwargs, out_val=out)
        if not func.is_view:
            counts["bytes"] += _tensor_bytes((*args, *kwargs.values(), out), dev_type)
        return out

    class _Count(TorchDispatchMode):
        pass

    # set after the class is made: TorchDispatchMode wraps a subclass's
    # __torch_dispatch__ in torch._disable_dynamo, whose first call imports
    # torch._dynamo (8-9 s in a fresh process on the card) and which adds a
    # frame to every op
    _Count.__torch_dispatch__ = count

    _COUNTING.launches = launches = []
    t0 = time.perf_counter()
    try:
        with _Count():
            out = fn(*args, **kwargs)
        if dev_type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        _COUNTING.launches = None
    total = counts["bytes"] + sum(kernel_bytes(name, t) for name, t in launches)
    return out, ProgramCost(float(counts["flops"]), float(total) or None), seconds


# ---------------------------------------------------------------------------
# Per-program attribution store + compile telemetry

_LOCK = threading.Lock()
#: (program, step, capacity, strategy) -> serializable profile dict
_PROFILES: dict[tuple, dict] = {}
#: keys whose first call has been taken
_SEEN: set[tuple] = set()
#: keys whose cost has been counted
_COUNTED: set[tuple] = set()
#: whether first calls are counted now (:func:`counting`)
_COUNT_ON = [False]
#: compile spans buffered for the engine thread, the only thread that
#: appends to the run ledger (record_compile can run on persist workers)
_COMPILE_SPANS: list[dict] = []


def pop_compile_spans() -> list[dict]:
    """Drain buffered compile spans (engine thread): dicts of step,
    program, t0, elapsed and recompile, ready for a ledger ``span`` event
    with ``span="compile"``."""
    with _LOCK:
        spans = list(_COMPILE_SPANS)
        _COMPILE_SPANS.clear()
    return spans


def reset_profiles() -> None:
    """Drop every recorded profile (tests, fresh runs)."""
    with _LOCK:
        _PROFILES.clear()
        _SEEN.clear()
        _COUNTED.clear()
        _COMPILE_SPANS.clear()


def perf_profiles() -> list[dict]:
    """Recorded program profiles, costliest (by FLOPs) first."""
    with _LOCK:
        entries = [dict(e) for e in _PROFILES.values()]
    entries.sort(key=lambda e: (e.get("flops") or 0.0), reverse=True)
    return entries


def perf_snapshot() -> dict:
    """Serializable snapshot for ``workflow/perf.json`` / ``tmx-torch
    perf``; the port adds ``card`` (:func:`card_peaks`) when a program ran
    on the card."""
    programs = perf_profiles()
    snap = {"generated_at_unix": time.time(), "programs": programs}
    if any(p.get("backend") == "cuda" for p in programs):
        snap["card"] = card_peaks()
    return snap


def _new_entry(program, step, capacity, strategy, backend) -> dict:
    return {"program": program, "step": step, "capacity": capacity, "strategy": strategy,
            "backend": backend, "flops": None, "bytes": None,
            "arithmetic_intensity": None, "bound_by": None, "compiles": 0,
            "recompiles": 0, "compile_seconds_total": 0.0, "last_compile_s": None}


def _note_cost(entry: dict, cost: ProgramCost) -> None:
    if cost.flops is not None:
        entry["flops"] = cost.flops
    if cost.bytes is not None:
        entry["bytes"] = cost.bytes
    ai = cost.arithmetic_intensity
    if ai is not None:
        entry["arithmetic_intensity"] = round(ai, 3)
        entry["bound_by"] = cost.bound_by()


def _cost_gauges(labels: dict, cost: ProgramCost) -> None:
    from tmlibrary_tpu_torch import telemetry

    reg = telemetry.get_registry()
    if cost.flops:
        reg.gauge("tmx_perf_program_flops", **labels).set(cost.flops)
    if cost.bytes:
        reg.gauge("tmx_perf_program_bytes", **labels).set(cost.bytes)
    if cost.arithmetic_intensity:
        reg.gauge("tmx_perf_program_arithmetic_intensity",
                  **labels).set(cost.arithmetic_intensity)


def _labels(program, step, capacity, strategy) -> dict:
    return {"program": str(program), "step": str(step) if step else "none",
            "capacity": str(capacity) if capacity else "none",
            "strategy": str(strategy) if strategy else "auto"}


def record_compile(*, program: str, step: str | None = "jterator",
                   capacity: int | None = None, strategy: str | None = None,
                   backend: str = "unknown", compile_s: float | None = None,
                   cost: ProgramCost | None = None, recompile: bool = False) -> dict:
    """Record one compile (a first call) of a program variant: update the
    store and mirror the reference's ``tmx_perf_*`` series (compile and
    recompile counters, the compile-seconds histogram per capacity, the
    cost gauges) and, with telemetry on, buffer a compile span for the
    engine's ledger, unless ``step`` is None (the kernel library's build
    or load belongs to no step)."""
    from tmlibrary_tpu_torch import telemetry

    cost = cost or ProgramCost()
    key = (program, step, capacity, strategy)
    with _LOCK:
        entry = _PROFILES.setdefault(key, _new_entry(program, step, capacity, strategy,
                                                     backend))
        entry["backend"] = backend
        entry["compiles"] += 1
        if recompile:
            entry["recompiles"] += 1
        if compile_s is not None:
            entry["compile_seconds_total"] += compile_s
            entry["last_compile_s"] = round(compile_s, 4)
        _note_cost(entry, cost)
        result = dict(entry)
    if telemetry.enabled():
        reg = telemetry.get_registry()
        labels = _labels(program, step, capacity, strategy)
        reg.counter("tmx_perf_compiles_total", **labels).inc()
        if recompile:
            reg.counter("tmx_perf_recompiles_total", **labels).inc()
        if compile_s is not None:
            reg.histogram("tmx_perf_compile_seconds",
                          capacity=labels["capacity"]).observe(compile_s)
        if compile_s is not None and step is not None:
            with _LOCK:
                _COMPILE_SPANS.append({"step": str(step), "program": str(program),
                                       "t0": round(time.time() - compile_s, 6),
                                       "elapsed": round(compile_s, 6),
                                       "recompile": bool(recompile)})
        _cost_gauges(labels, cost)
    return result


@contextlib.contextmanager
def counting():
    """Count the FLOPs and bytes of each program's first call in the
    block (``workflow submit --profile``); outside it no call is
    wrapped."""
    with _LOCK:
        before, _COUNT_ON[0] = _COUNT_ON[0], True
    try:
        yield
    finally:
        with _LOCK:
            _COUNT_ON[0] = before


def instrument_call(fn: Callable, *args, program: str, step: str = "jterator",
                    capacity: int | None = None, strategy: str | None = None,
                    device="cuda", **kwargs):
    """``fn(*args, **kwargs)``; the first call of the key (program, step,
    capacity, strategy) in the process lands in the store as a compile
    with its host wall, and, while :func:`counting` is on, the first call
    of the key in it runs under :func:`measure_call` for its cost.  Every
    other call (and every call with telemetry off) runs ``fn`` as it is.
    Any call may raise; a call that raises records nothing."""
    from tmlibrary_tpu_torch import telemetry

    if not telemetry.enabled():
        return fn(*args, **kwargs)
    key = (program, step, capacity, strategy)
    with _LOCK:
        first = key not in _SEEN
        count = _COUNT_ON[0] and key not in _COUNTED
        _SEEN.add(key)
        if count:
            _COUNTED.add(key)
    if not (first or count):
        return fn(*args, **kwargs)
    try:
        if count:
            out, cost, seconds = measure_call(fn, *args, device=device, **kwargs)
        else:
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            cost, seconds = ProgramCost(), time.perf_counter() - t0
    except BaseException:
        with _LOCK:
            if first:
                _SEEN.discard(key)
            if count:
                _COUNTED.discard(key)
        raise
    backend = torch.device(device).type
    if first:
        record_compile(program=program, step=step, capacity=capacity, strategy=strategy,
                       backend=backend, compile_s=seconds, cost=cost)
    else:
        with _LOCK:
            entry = _PROFILES.setdefault(key, _new_entry(program, step, capacity, strategy,
                                                         backend))
            _note_cost(entry, cost)
        _cost_gauges(_labels(program, step, capacity, strategy), cost)
    return out


# ---------------------------------------------------------------------------
# Bench-record staleness (live gauges for metrics / workflow status)

#: hours after which a cached on-hardware bench record stops being evidence
STALE_HOURS_DEFAULT = 72.0


def stale_hours() -> float:
    try:
        return float(os.environ.get("BENCH_STALE_HOURS", STALE_HOURS_DEFAULT))
    except ValueError:
        return STALE_HOURS_DEFAULT


def bench_record_staleness(now: float | None = None,
                           backend: str | None = None) -> list[dict]:
    """Age of every cached on-hardware bench record
    (:func:`tuning.bench_cache_path`): ``[{config, metric, age_hours,
    stale, measured_at}, ...]``; empty without a cache; never raises.
    With ``backend``, only the records of that backend class (the port's
    ``workflow status`` asks for its own device's)."""
    try:
        with open(tuning.bench_cache_path()) as f:
            cache = json.load(f)
        records = cache.get("records", {})
        if not isinstance(records, dict):
            return []
    except (OSError, ValueError, AttributeError):
        return []
    now = time.time() if now is None else now
    threshold = stale_hours()
    out = []
    for config, entry in sorted(records.items()):
        if not isinstance(entry, dict):
            continue
        measured = entry.get("measured_at_unix")
        if not isinstance(measured, (int, float)):
            continue
        rec = entry.get("record")
        if backend is not None and _backend_class(
                rec.get("backend") if isinstance(rec, dict) else None) != backend:
            continue
        age_h = max(0.0, (now - float(measured)) / 3600.0)
        out.append({
            "config": str(config),
            "metric": str(entry.get("record", {}).get("metric", "")),
            "age_hours": round(age_h, 1),
            "stale": age_h > threshold,
            "measured_at": entry.get("measured_at"),
        })
    return out


def set_bench_staleness_gauges(registry=None, now: float | None = None) -> list[dict]:
    """Mirror :func:`bench_record_staleness` into
    ``tmx_bench_record_age_hours`` and ``tmx_bench_record_stale``."""
    from tmlibrary_tpu_torch import telemetry

    rows = bench_record_staleness(now=now)
    reg = registry if registry is not None else telemetry.get_registry()
    for row in rows:
        reg.gauge("tmx_bench_record_age_hours", config=row["config"]).set(row["age_hours"])
        reg.gauge("tmx_bench_record_stale", config=row["config"]).set(
            1.0 if row["stale"] else 0.0)
    return rows


# ---------------------------------------------------------------------------
# Bench history sentinel

EXIT_OK = 0           # latest matches or improves on the baseline
EXIT_REGRESSION = 1   # latest below baseline by more than the threshold
EXIT_STALE = 2        # latest is fine but older than the staleness budget
EXIT_NO_BASELINE = 3  # nothing comparable to judge against


def _backend_class(backend) -> str:
    """Comparable backend classes: ``cpu_forced``/``cpu_fallback`` are CPU
    numbers, ``<backend>_cached`` is that backend's hardware evidence."""
    b = str(backend or "unknown").lower()
    if b.startswith("cpu"):
        return "cpu"
    if b.endswith("_cached"):
        return b[: -len("_cached")]
    return b


def _record_time(rec: dict) -> float | None:
    for field in ("recorded_at_unix", "measured_at_unix"):
        value = rec.get(field)
        if isinstance(value, (int, float)):
            return float(value)
    return None


def _comparable(rec: dict) -> bool:
    if not isinstance(rec, dict) or rec.get("error"):
        return False
    value = rec.get("value")
    return isinstance(value, (int, float)) and value > 0


def _methodology_class(rec: dict) -> str:
    """Timing-methodology family, as the reference's: pipelined against
    host-synchronous, bucketed, fused, the schedule and the model digest
    stay apart; a recall value collapses; no methodology is ``legacy``."""
    m = str(rec.get("timing_methodology") or "")
    if not m:
        return "legacy"
    if m.startswith("pipelined"):
        cls = "pipelined+bucketed" if "bucketed" in m else "pipelined"
        if "strategy=fused" in m:
            cls += "+fused"
        sched = re.search(r"schedule=([a-z]+)", m)
        if sched:
            cls += f"+schedule={sched.group(1)}"
        model = re.search(r"model=([0-9a-f]+)", m)
        if model:
            cls += f"+model={model.group(1)}"
        return cls
    if m.startswith("analytics-tools"):
        return re.sub(r"\+recall=[0-9.]+", "", m)
    return m


def _history_key(rec: dict) -> tuple:
    return (str(rec.get("metric", "")), str(rec.get("config", "")),
            _backend_class(rec.get("backend")), _methodology_class(rec))


def compare_history(history: list[dict], *, baseline: list[dict] | None = None,
                    config: str | None = None, metric: str | None = None,
                    threshold: float = 0.05, stale_hours: float = STALE_HOURS_DEFAULT,
                    now: float | None = None) -> dict:
    """Judge the latest bench record against the best comparable one, as
    the reference does: ``status`` (improvement/ok/regression/stale/
    no_baseline), ``exit_code`` (a regression outranks staleness),
    ``latest``, ``baseline``, ``delta_frac``, ``age_hours`` and the
    ``recapture`` labels.  Records compare when they share (metric,
    config, backend class, methodology class) and carry a positive
    error-free value; ``baseline`` supplies the pool from another file."""
    now = time.time() if now is None else now

    def matches(rec):
        if not _comparable(rec):
            return False
        if config is not None and str(rec.get("config", "")) != str(config):
            return False
        return metric is None or rec.get("metric") == metric

    pool = [r for r in history if matches(r)]
    if not pool:
        return {"status": "no_baseline", "exit_code": EXIT_NO_BASELINE,
                "reason": "no comparable records in history", "latest": None,
                "baseline": None, "delta_frac": None, "age_hours": None, "recapture": []}
    latest = pool[-1]
    key = _history_key(latest)
    if baseline is not None:
        candidates = [r for r in baseline if _comparable(r) and _history_key(r) == key]
    else:
        candidates = [r for r in pool[:-1] if _history_key(r) == key]
    age_hours = None
    ts = _record_time(latest)
    if ts is not None:
        age_hours = round(max(0.0, (now - ts) / 3600.0), 1)
    is_stale = age_hours is not None and age_hours > stale_hours
    label = (f"sweep:{latest.get('config')}" if latest.get("sweep")
             else f"bench:{latest.get('config')}")
    if not candidates:
        return {"status": "no_baseline", "exit_code": EXIT_NO_BASELINE,
                "reason": f"no baseline for {key}", "latest": latest, "baseline": None,
                "delta_frac": None, "age_hours": age_hours,
                "recapture": [label] if is_stale else []}
    best = max(candidates, key=lambda r: r["value"])
    delta = (latest["value"] - best["value"]) / best["value"]
    if delta < -threshold:
        status, code = "regression", EXIT_REGRESSION
    elif is_stale:
        status, code = "stale", EXIT_STALE
    elif delta > threshold:
        status, code = "improvement", EXIT_OK
    else:
        status, code = "ok", EXIT_OK
    return {"status": status, "exit_code": code, "latest": latest, "baseline": best,
            "delta_frac": round(delta, 4), "age_hours": age_hours,
            "recapture": [label] if code in (EXIT_REGRESSION, EXIT_STALE) else []}


# ---------------------------------------------------------------------------
# Re-capture queue

def load_recapture(path: str | None = None) -> list[str]:
    """Pending re-capture labels; unknown shapes and unreadable files are
    an empty list."""
    path = path or tuning.recapture_path()
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return []
    items = doc.get("items") if isinstance(doc, dict) else doc
    if not isinstance(items, list):
        return []
    return [str(i) for i in items if isinstance(i, str) and i]


def write_recapture(labels: list[str], path: str | None = None, reason: str = "") -> str:
    """Merge ``labels`` into the queue (deduplicated, in order); returns
    the path written."""
    path = path or tuning.recapture_path()
    existing = load_recapture(path)
    merged = existing + [label for label in labels if label not in existing]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    atomic_write_text(path, json.dumps({"items": merged, "reason": reason,
                                        "written_at_unix": time.time()}, indent=2) + "\n")
    return path


def clear_recapture(label: str, path: str | None = None) -> None:
    """Drop one satisfied label; the file goes when the queue empties."""
    path = path or tuning.recapture_path()
    remaining = [item for item in load_recapture(path) if item != label]
    try:
        if remaining:
            atomic_write_text(path, json.dumps({"items": remaining,
                                                "written_at_unix": time.time()},
                                               indent=2) + "\n")
        elif os.path.exists(path):
            os.remove(path)
    except OSError:
        pass
