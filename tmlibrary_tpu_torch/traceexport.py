"""Chrome-trace export for run and serve ledgers (``tmx trace --export``).

Counterpart: ``tmlibrary_tpu/traceexport.py``, which imports no JAX; the port keeps
its own copy, held equal to it on the same inputs by
``tests/test_torch_telemetry.py``.

Renders a span tree — reconstructed purely from CRC-sealed ledger events,
the same replay discipline as ``registry_from_ledger`` — as Trace Event
Format JSON (the ``chrome://tracing`` / Perfetto interchange format):

* one **process row per host** (fleet ledgers interleave hosts; each gets
  its own ``pid`` plus a ``process_name`` metadata record);
* one **thread row per tenant/job** (``tid``), so a multi-tenant serve
  window reads as parallel lanes and a single run as one lane;
* every span event (``queue_wait``/``sched_delay``/``job`` from the serve
  ledger, ``run``/``step``/``batch``/phase/``compile`` from the engine)
  becomes a complete ``"X"`` slice with micro-second ``ts``/``dur``;
* **flow arrows** link enqueue → admit → execute for each ``trace_id``,
  so one job's whole life reads as a connected chain across lanes;
* seed-era ledgers (no ``span`` events) still export: slices are
  synthesized from ``batch_done``/``step_done`` timing, exactly like
  ``telemetry.build_span_tree``'s fallback.

For a serve root, :func:`collect_events` merges the serve ledger with
every experiment ledger the spooled job specs reference, so the export covers the full
enqueue→result path without the daemon's help.
"""

from __future__ import annotations

import json
import zlib
from pathlib import Path
from typing import Any, Iterable

#: Trace Event Format phase codes this exporter emits
_PH_COMPLETE = "X"
_PH_INSTANT = "i"
_PH_METADATA = "M"
_PH_FLOW_START = "s"
_PH_FLOW_STEP = "t"
_PH_FLOW_END = "f"

_KNOWN_PH = {_PH_COMPLETE, _PH_INSTANT, _PH_METADATA,
             _PH_FLOW_START, _PH_FLOW_STEP, _PH_FLOW_END}

#: job-lifecycle ledger kinds rendered as instant markers
_INSTANT_KINDS = ("job_admitted", "job_rejected", "job_started",
                  "job_done", "job_failed", "job_expired", "job_requeued",
                  "slo_burn", "anomaly", "run_preempted",
                  "serve_preempted", "watchdog")


# ------------------------------------------------------------- collection
def _read_ledger(path: Path) -> list[dict]:
    if not Path(path).exists():
        return []
    from tmlibrary_tpu_torch.workflow.engine import RunLedger

    return list(RunLedger(Path(path)).events())


def _spooled_experiment_roots(serve_root: Path) -> list[Path]:
    """Experiment roots referenced by spooled job specs, every state —
    done/failed envelopes wrap the spec under ``"job"``."""
    from tmlibrary_tpu_torch import serve

    roots: list[Path] = []
    seen: set[str] = set()
    for state in serve.SPOOL_STATES:
        d = serve.spool_dir(Path(serve_root), state)
        if not d.is_dir():
            continue
        for f in sorted(d.glob("*.json")):
            try:
                payload = json.loads(f.read_text())
            except Exception:
                continue
            spec = payload.get("job", payload)
            root = spec.get("root") if isinstance(spec, dict) else None
            if root and root not in seen:
                seen.add(root)
                roots.append(Path(root))
    return roots


def collect_events(root: Path) -> list[dict]:
    """Every ledger event reachable from ``root``, ts-sorted.

    ``root`` may be an experiment root (``workflow/ledger.jsonl``), a
    serve root (serve ledger + all spooled experiments' ledgers), or a
    ledger file directly.  Duplicate events from multi-host merged
    ledgers are fine — the renderer dedups by host fingerprint.
    """
    root = Path(root)
    events: list[dict] = []
    if root.is_file():
        events = _read_ledger(root)
    else:
        from tmlibrary_tpu_torch import serve

        if serve.is_serve_root(root):
            for lp in serve.serve_ledger_paths(root):
                events.extend(_read_ledger(lp))  # every fleet host
            for exp_root in _spooled_experiment_roots(root):
                events.extend(
                    _read_ledger(exp_root / "workflow" / "ledger.jsonl"))
        else:
            events.extend(_read_ledger(root / "workflow" / "ledger.jsonl"))
    events.sort(key=lambda ev: float(ev.get("ts", 0.0) or 0.0))
    return events


# -------------------------------------------------------------- rendering
def _flow_id(ev: dict) -> int | None:
    """Stable numeric flow id for a job's enqueue→execute chain."""
    key = ev.get("trace_id") or ev.get("job")
    if not key:
        return None
    return zlib.crc32(str(key).encode("utf-8"))


def _span_args(ev: dict) -> dict:
    return {k: ev[k] for k in
            ("step", "batch", "trace_id", "job", "tenant", "attempt",
             "program", "recompile", "path")
            if ev.get(k) is not None}


class _Rows:
    """pid/tid allocation + name metadata records."""

    def __init__(self) -> None:
        self._pids: dict[str, int] = {}
        self._tids: dict[tuple[int, str], int] = {}
        self.meta: list[dict] = []

    def pid(self, host: str) -> int:
        if host not in self._pids:
            self._pids[host] = len(self._pids) + 1
            self.meta.append({
                "name": "process_name", "ph": _PH_METADATA,
                "pid": self._pids[host], "tid": 0,
                "args": {"name": host},
            })
        return self._pids[host]

    def tid(self, pid: int, lane: str) -> int:
        key = (pid, lane)
        if key not in self._tids:
            self._tids[key] = len(self._tids) + 1
            self.meta.append({
                "name": "thread_name", "ph": _PH_METADATA,
                "pid": pid, "tid": self._tids[key],
                "args": {"name": lane},
            })
        return self._tids[key]


def _lane(ev: dict) -> str:
    """Thread-row label: tenant/job for traced jobs, the step for plain
    runs, ``serve`` for daemon housekeeping."""
    job = ev.get("job")
    if job:
        tenant = ev.get("tenant") or "default"
        return f"{tenant}/{job}"
    if ev.get("step"):
        return "run"
    return "run" if ev.get("event") == "span" else "serve"


def chrome_trace(events: Iterable[dict],
                 trace_id: str | None = None) -> dict:
    """Render ledger events as a Trace Event Format document.

    ``trace_id`` restricts the export to one job's trace (events carrying
    a different trace_id drop; unlabeled events drop too, since they
    cannot belong to the requested trace).
    """
    rows = _Rows()
    out: list[dict] = []
    seen: set[tuple] = set()
    spanned_steps: set[tuple[str, str]] = set()
    flows: dict[int, list[tuple[str, float, int, int]]] = {}

    evs = []
    for ev in events:
        if trace_id is not None and ev.get("trace_id") != trace_id:
            continue
        host = str(ev.get("host", "")) or "host"
        fp = (host, ev.get("ts"), ev.get("event"), ev.get("span"),
              ev.get("step"), ev.get("batch"), ev.get("job"))
        if fp in seen:
            continue  # multi-host merged ledgers repeat events
        seen.add(fp)
        evs.append(ev)
        if ev.get("event") == "span" and ev.get("span") in ("step", "batch"):
            spanned_steps.add((host, str(ev.get("step", ""))))

    for ev in evs:
        kind = ev.get("event")
        host = str(ev.get("host", "")) or "host"
        pid = rows.pid(host)
        tid = rows.tid(pid, _lane(ev))
        if kind == "span":
            name = str(ev.get("span", "span"))
            t0 = ev.get("t0")
            elapsed = float(ev.get("elapsed", 0.0) or 0.0)
            if t0 is None:
                # span recorded without a start → anchor on the seal ts
                t0 = float(ev.get("ts", 0.0) or 0.0) - elapsed
            ts_us = float(t0) * 1e6
            slice_ev = {
                "name": name, "ph": _PH_COMPLETE, "cat": "span",
                "ts": round(ts_us, 3), "dur": round(elapsed * 1e6, 3),
                "pid": pid, "tid": tid, "args": _span_args(ev),
            }
            out.append(slice_ev)
            if name in ("queue_wait", "sched_delay", "job"):
                fid = _flow_id(ev)
                if fid is not None:
                    flows.setdefault(fid, []).append(
                        (name, ts_us, pid, tid))
        elif kind == "batch_done":
            step = str(ev.get("step", "")) or "unknown"
            if (host, step) in spanned_steps:
                continue  # real spans cover this step
            elapsed = float(ev.get("elapsed", 0.0) or 0.0)
            ts_us = (float(ev.get("ts", 0.0) or 0.0) - elapsed) * 1e6
            out.append({
                "name": f"batch:{ev.get('batch')}", "ph": _PH_COMPLETE,
                "cat": "span", "ts": round(ts_us, 3),
                "dur": round(elapsed * 1e6, 3), "pid": pid, "tid": tid,
                "args": _span_args(ev),
            })
        elif kind in ("step_done", "step_partial"):
            step = str(ev.get("step", "")) or "unknown"
            if (host, step) in spanned_steps:
                continue
            elapsed = float(ev.get("elapsed", 0.0) or 0.0)
            ts_us = (float(ev.get("ts", 0.0) or 0.0) - elapsed) * 1e6
            out.append({
                "name": f"step:{step}", "ph": _PH_COMPLETE, "cat": "span",
                "ts": round(ts_us, 3), "dur": round(elapsed * 1e6, 3),
                "pid": pid, "tid": tid, "args": _span_args(ev),
            })
        elif kind in _INSTANT_KINDS:
            out.append({
                "name": str(kind), "ph": _PH_INSTANT, "cat": "event",
                "s": "t", "ts": round(float(ev.get("ts", 0.0)) * 1e6, 3),
                "pid": pid, "tid": tid, "args": _span_args(ev),
            })

    # flow arrows: enqueue (queue_wait) → admit (sched_delay) → execute
    # (job), bound to each anchor slice's start instant
    order = {"queue_wait": 0, "sched_delay": 1, "job": 2}
    for fid, anchors in sorted(flows.items()):
        chain = sorted(anchors, key=lambda a: (order[a[0]], a[1]))
        if len(chain) < 2:
            continue
        for i, (name, ts_us, pid, tid) in enumerate(chain):
            ph = (_PH_FLOW_START if i == 0 else
                  _PH_FLOW_END if i == len(chain) - 1 else _PH_FLOW_STEP)
            flow = {
                "name": "job_flow", "cat": "flow", "ph": ph, "id": fid,
                "ts": round(ts_us, 3), "pid": pid, "tid": tid,
            }
            if ph == _PH_FLOW_END:
                flow["bp"] = "e"  # bind to the enclosing slice
            out.append(flow)

    out.sort(key=lambda e: (e.get("ts", 0.0), e.get("ph") != _PH_METADATA))
    return {
        "traceEvents": rows.meta + out,
        "displayTimeUnit": "ms",
        "otherData": {
            # the trace format's name, shared with the reference's
            # exporter so either package's traces read as one format
            "exporter": "tmlibrary_tpu.traceexport",
            "trace_id": trace_id,
        },
    }


# ------------------------------------------------------------- validation
def validate_chrome_trace(doc: Any) -> list[str]:
    """Schema check for an exported document; returns a list of problems
    (empty == valid).  Pins the invariants the tests (and any Perfetto
    load) rely on: phase codes, numeric µs timestamps, non-negative
    durations, named slices, matched flow chains."""
    errors: list[str] = []
    if not isinstance(doc, dict):
        return ["document is not an object"]
    evts = doc.get("traceEvents")
    if not isinstance(evts, list):
        return ["traceEvents missing or not a list"]
    flow_phs: dict[Any, list[str]] = {}
    for i, ev in enumerate(evts):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _KNOWN_PH:
            errors.append(f"{where}: unknown ph {ph!r}")
            continue
        if not isinstance(ev.get("pid"), int):
            errors.append(f"{where}: pid missing or not an int")
        if not isinstance(ev.get("tid"), int):
            errors.append(f"{where}: tid missing or not an int")
        if ph == _PH_METADATA:
            if ev.get("name") not in ("process_name", "thread_name"):
                errors.append(f"{where}: unexpected metadata {ev.get('name')!r}")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"{where}: ts missing/negative")
        if not ev.get("name"):
            errors.append(f"{where}: unnamed event")
        if ph == _PH_COMPLETE:
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: X slice needs dur >= 0")
        if ph in (_PH_FLOW_START, _PH_FLOW_STEP, _PH_FLOW_END):
            if "id" not in ev:
                errors.append(f"{where}: flow event without id")
            else:
                flow_phs.setdefault(ev["id"], []).append(ph)
    for fid, phs in flow_phs.items():
        if phs.count(_PH_FLOW_START) != 1 or phs.count(_PH_FLOW_END) != 1:
            errors.append(
                f"flow {fid}: needs exactly one start and one finish "
                f"(got {phs})")
    return errors


def export_chrome_trace(root: Path, out_path: Path,
                        trace_id: str | None = None) -> dict:
    """``tmx trace --export chrome`` backend: collect, render, validate,
    write.  Raises ``ValueError`` when the rendered document fails its
    own schema (a broken export must never land silently)."""
    from tmlibrary_tpu_torch.atomicio import atomic_write_json

    doc = chrome_trace(collect_events(Path(root)), trace_id=trace_id)
    problems = validate_chrome_trace(doc)
    if problems:
        raise ValueError(
            "chrome trace failed schema validation: "
            + "; ".join(problems[:5]))
    atomic_write_json(Path(out_path), doc)
    return doc
