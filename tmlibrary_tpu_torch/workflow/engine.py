"""Workflow engine: stage/step execution with a ledger-backed resume.

Counterpart: ``tmlibrary_tpu/workflow/engine.py`` (reference
``tmlib/workflow/workflow.py``, ``description.py``, ``dependencies.py``
and ``manager.py``): a :class:`WorkflowDescription` lists stages of
steps with their arguments; :class:`Workflow` runs each active step
(``init`` -> batches -> ``collect``) in one process on ``device`` and
appends every event to a :class:`RunLedger`, which ``resume`` replays
to skip completed steps and batches.

The ledger's lines are sealed with a CRC-32 exactly as the reference
seals them, and the engine appends the same events in the same order as
the reference's does with telemetry off (``run_started``, ``init_done``,
``schedule_plan``, ``batch_done``, ``first_batch``, ``batch_failed``,
``step_partial``/``step_done``/``step_failed``, ``depth_clamped``,
``description_drift``, the QC events), so either package's ``status``
reads the other's ledger.  Where the port differs:

- **YAML without PyYAML.**  The card's machine has no ``yaml``;
  :meth:`WorkflowDescription.load` and :meth:`~WorkflowDescription.save`
  go through :mod:`tmlibrary_tpu_torch.yamlio`, whose writer gives the
  reference's bytes.
- **No CPU fallback.**  Every step runs on the engine's ``device``
  (``"cuda"`` unless the caller passes ``"cpu"``); a missing card raises
  :class:`DeviceError`.  The reference's device health guard, which pins
  the backend to the CPU when probes fail, is not ported.
- **Telemetry, faults, preemption** as the reference's: every ledger
  event carries the ambient trace context (``trace_id``/``job``/
  ``tenant`` of a served job) and lands in the flight recorder; the
  ``ledger_append``, ``batch_run`` and ``persist`` fault sites fire as
  the reference's; with telemetry on, ``run``/``step``/``batch`` spans
  and the executor's phase spans are ledgered, ``tmx_*`` series counted
  and ``metrics.<host>.json``, the heartbeat and the tsdb segment
  written.  ``should_stop``/``stop_reason`` (default: the process's
  preemption flag) are polled before each step and batch; a stop drains
  the pipelined window and records ``run_preempted``
  (:class:`PreemptedError`, exit 75 from the CLI).  The phase watchdog
  arms per phase when on.  A fleet host (``TMX_HOST_ID``) stamps
  ``host`` on each event.
- **Compile spans and ``perf.json``.**  The port compiles nothing per
  program; :mod:`tmlibrary_tpu_torch.perf` records the first call of
  each program (and the kernel library's build or load) as its compile,
  and the engine drains those records as ``span`` events with
  ``span="compile"`` after each batch and step and at the end of the run
  (:meth:`Workflow._drain_compile_spans`, the reference's ``:700-710``),
  dropping at its start those recorded before it;
  with telemetry on it writes :func:`~tmlibrary_tpu_torch.perf.perf_snapshot`
  to ``workflow/perf.json`` at the end of the run (``:772-781``), and a
  failed write raises.  The step span is named ``step:<name>`` and each
  batch ``batch:<index>`` in a device trace
  (:func:`~tmlibrary_tpu_torch.profiling.device_trace`).

**Several ranks.**  Under a process group of more than one rank
(``torchrun``, :func:`tmlibrary_tpu_torch.parallel.distributed.initialize`)
rank 0 runs the engine as above: it plans, appends to the ledger and
collects.  For each step it sends the other ranks the indices of the
batches it is about to run, in order; they run the same batches of the
steps that shard over ranks (``collective = True``: corilla, illuminati,
jterator), whose collectives pair with rank 0's, and skip the others.
The ranks meet at a barrier after each step's batches; a step with a
``collective_collect`` (jterator's re-segmentation of saturated batches)
then runs it on every rank while rank 0 collects.

Rank 0 decides every retry, quarantine and stop of a sharding step and
broadcasts the decision, so every rank retries the same batch, or
raises the same :class:`PreemptedError`, at the same boundary and none
waits alone in a collective.  Before each attempt of a batch every rank
sends rank 0 its stop flag and whether the ``batch_run`` fault site
fired on it; after the attempt, whether it raised.  Rank 0 judges the
reports under its retry policy (``_verdict``: retry after the policy's
delay, quarantine, fail the step past the quarantine budget, or stop)
and every rank follows.  One rank runs the same attempts and verdicts
with itself as rank 0 (``_agreed_attempts``), so there is one retry
path.  The pipelined executor runs at several ranks too: its persists,
whose escalation re-launches are collectives, run on the calling thread
in submission order on every rank.  The ``persist`` fault site's
outcome is agreed before a persist begins (``_agree_persist``), and the
mesh's members agree on each escalation (one saturated member re-runs
them all; a fetch that raised on one fails the batch on all), so a
failure there fails the batch on every rank with the failing rank's
error judged.  A failed batch is yielded in its turn and its outcome
agreed the same way, and the executor's ``should_stop`` is the same
collective poll, before each launch.  The depth is rank 0's, sent with
the batch order and the quarantine budget.  A batch that raises on one
rank inside a collective's span (a launch) cannot be agreed: the other
ranks wait in the collective until NCCL's or gloo's timeout ends the
run.  A step that does not shard runs on rank 0 alone, with its own
retries and no stop poll inside it; the ranks then agree on a stop at
the next step boundary.

At the end of a run, finished or failed, the engine writes the QC
session's profile (:mod:`tmlibrary_tpu_torch.qc`) to
``workflow/qc.<host>.json`` and, on ``host0``, ``workflow/qc.json``, as
the reference does (``:783-802``); with QC off it writes nothing.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import inspect
import json
import logging
import os
import sys
import time
import zlib
from pathlib import Path
from typing import Any

import torch

from tmlibrary_tpu_torch import faults, perf, telemetry, timeseries, yamlio
from tmlibrary_tpu_torch import qc as qc_mod
from tmlibrary_tpu_torch.atomicio import atomic_write_text
from tmlibrary_tpu_torch.config import LibraryConfig
from tmlibrary_tpu_torch.device import resolve_device
from tmlibrary_tpu_torch.errors import (
    FaultInjected,
    PeerFailed,
    PreemptedError,
    WorkflowError,
)
from tmlibrary_tpu_torch.models.store import ExperimentStore
from tmlibrary_tpu_torch.parallel import distributed
from tmlibrary_tpu_torch.resilience import (
    PERMANENT,
    TRANSIENT,
    ResilienceConfig,
    RetryOutcome,
    RetryPolicy,
    classify,
    preemption_reason,
    preemption_requested,
    watchdog_from_config,
)
from tmlibrary_tpu_torch.workflow.pipelined import (
    BatchFailure,
    PipelinedExecutor,
    PipelineStats,
    resolve_pipeline_depth,
    supports_pipelining,
)
from tmlibrary_tpu_torch.workflow.registry import get_step, list_steps

logger = logging.getLogger(__name__)

#: workflow-type stage DAGs (reference ``tmlib/workflow/dependencies.py``):
#: conversion -> preprocessing -> pyramid -> analysis; the multiplexing
#: type adds inter-cycle registration (``align``) to preprocessing
WORKFLOW_TYPES: dict[str, list[tuple[str, list[str]]]] = {
    "canonical": [
        ("image_conversion", ["metaconfig", "imextract"]),
        ("image_preprocessing", ["corilla"]),
        ("pyramid_creation", ["illuminati"]),
        ("image_analysis", ["jterator"]),
    ],
    "multiplexing": [
        ("image_conversion", ["metaconfig", "imextract"]),
        ("image_preprocessing", ["corilla", "align"]),
        ("pyramid_creation", ["illuminati"]),
        ("image_analysis", ["jterator"]),
    ],
}

@dataclasses.dataclass
class WorkflowStepDescription:
    name: str
    args: dict[str, Any] = dataclasses.field(default_factory=dict)
    active: bool = True


@dataclasses.dataclass
class WorkflowStageDescription:
    name: str
    steps: list[WorkflowStepDescription]


@dataclasses.dataclass
class WorkflowDescription:
    """Serializable workflow plan (reference ``WorkflowDescription``)."""

    stages: list[WorkflowStageDescription]

    def validate(self) -> None:
        known = set(list_steps())
        for stage in self.stages:
            for step in stage.steps:
                if step.name not in known:
                    raise WorkflowError(
                        f"workflow references unknown step '{step.name}' "
                        f"(registered: {sorted(known)})")

    # ------------------------------------------------------------- serialize
    def to_dict(self) -> dict:
        return {
            "stages": [
                {"name": st.name,
                 "steps": [{"name": s.name, "args": s.args, "active": s.active}
                           for s in st.steps]}
                for st in self.stages
            ]
        }

    @classmethod
    def from_dict(cls, d: dict) -> "WorkflowDescription":
        return cls(stages=[
            WorkflowStageDescription(
                name=st["name"],
                steps=[WorkflowStepDescription(name=s["name"], args=s.get("args", {}) or {},
                                               active=bool(s.get("active", True)))
                       for s in st.get("steps", [])],
            )
            for st in d.get("stages", [])
        ])

    @classmethod
    def load(cls, path: Path) -> "WorkflowDescription":
        """Read a description written as YAML (or JSON, which is YAML)."""
        return cls.from_dict(yamlio.load(path))

    def save(self, path: Path) -> None:
        """Write the description as YAML, with the bytes of the
        reference's ``yaml.safe_dump(..., sort_keys=False)``."""
        atomic_write_text(path, yamlio.safe_dump(self.to_dict()))

    @classmethod
    def for_type(cls, workflow_type: str,
                 step_args: dict[str, dict] | None = None) -> "WorkflowDescription":
        """A description of a registered workflow type (``canonical`` |
        ``multiplexing``); ``step_args`` maps step name -> args, and only
        steps with args are active."""
        if workflow_type not in WORKFLOW_TYPES:
            raise WorkflowError(f"unknown workflow type '{workflow_type}' "
                                f"(registered: {sorted(WORKFLOW_TYPES)})")
        step_args = step_args or {}
        return cls(stages=[
            WorkflowStageDescription(
                name=stage,
                steps=[WorkflowStepDescription(name=s, args=step_args.get(s, {}),
                                               active=s in step_args) for s in steps],
            )
            for stage, steps in WORKFLOW_TYPES[workflow_type]
        ])

    @classmethod
    def canonical(cls, step_args: dict[str, dict] | None = None) -> "WorkflowDescription":
        """The four-stage workflow; ``align`` args select the multiplexing
        variant (the only type that runs inter-cycle registration)."""
        wtype = "multiplexing" if "align" in (step_args or {}) else "canonical"
        return cls.for_type(wtype, step_args)


#: separator introducing the per-line checksum (the last key of each line)
_CRC_SEP = ', "crc": "'


class RunLedger:
    """Append-only JSON-lines event log of a store's runs.

    Every line is sealed with a CRC-32 of the event body as its last JSON
    key, byte for byte as the reference seals it, so a torn write is
    detectable even when its prefix is valid JSON.  Readers skip lines
    that fail to verify; the writer truncates a torn tail back to the
    last intact line before its first append (:meth:`recover`).  Lines
    without a CRC read as they are."""

    def __init__(self, path: Path, fsync: bool = False, host: str | None = None):
        self.path = Path(path)
        self.fsync = fsync
        #: a fleet host's name, stamped on each event (None: host-free)
        self.host = host
        #: (mtime_ns, size) -> parsed events
        self._cache: tuple[tuple[int, int], list[dict]] | None = None
        self._recovered = False
        #: per-step completed batches kept by append_batch_done
        self._done_cache: dict[str, set[int]] = {}
        self._warned: set[int] = set()

    # ------------------------------------------------------------- sealing
    @staticmethod
    def _seal(body: str) -> str:
        crc = zlib.crc32(body.encode())
        return f'{body[:-1]}{_CRC_SEP}{crc:08x}"}}'

    @staticmethod
    def _line_ok(line: str) -> bool:
        """True when the line parses and, if sealed, its CRC (over the
        exact sealed bytes) verifies."""
        head, sep, tail = line.rpartition(_CRC_SEP)
        if sep and tail.endswith('"}'):
            if f"{zlib.crc32((head + '}').encode()):08x}" != tail[:-2]:
                return False
            line = head + "}"
        try:
            json.loads(line)
        except json.JSONDecodeError:
            return False
        return True

    def recover(self) -> int:
        """Truncate a torn tail back to the last intact line boundary;
        returns the bytes dropped.  Writer only: a reader polling a live
        ledger must never truncate it."""
        self._recovered = True
        try:
            data = self.path.read_bytes()
        except OSError:
            return 0
        good = len(data)
        while good > 0:
            nl = data.rfind(b"\n", 0, good)
            if nl == good - 1:
                start = data.rfind(b"\n", 0, nl) + 1
                frag = data[start:nl]
                if not frag.strip() or self._line_ok(frag.decode("utf-8", errors="replace")):
                    break
                good = start
            else:
                good = nl + 1  # an unterminated fragment: a torn append
        dropped = len(data) - good
        if dropped:
            logger.warning("ledger %s: truncating %d bytes of torn tail back to the last "
                           "intact event", self.path, dropped)
            with open(self.path, "rb+") as f:
                f.truncate(good)
            self._cache = None
            self._done_cache.clear()
        return dropped

    def append(self, **event) -> None:
        if not self._recovered:
            self.recover()
        event["ts"] = time.time()
        if self.host is not None:
            event.setdefault("host", self.host)
        # the ambient trace labels of a served job; explicit labels win
        for k, v in telemetry.trace_context().items():
            event.setdefault(k, v)
        telemetry.flight_record(event)
        line = self._seal(json.dumps(event))
        spec = faults.match("ledger_append", step=event.get("step"), event=event.get("event"))
        self._cache = None
        if event.get("event") == "init_done":
            self._done_cache.clear()  # a re-init invalidates earlier completions
        with open(self.path, "a") as f:
            if spec is not None:
                # a process dying mid-write: half a line, no newline
                f.write(line[: max(1, len(line) // 2)])
                f.flush()
                faults.raise_for(spec, "ledger_append", event)
            f.write(line + "\n")
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())

    def append_batch_done(self, step: str, batch: int, **fields) -> bool:
        """``batch_done`` unless the batch's completion is already in the
        ledger (then a no-op, so replayed state never double-counts);
        returns whether the event was appended."""
        done = self._done_cache.get(step)
        if done is None:
            done = self._done_cache[step] = set(self.completed_batches(step))
        if batch in done:
            logger.info("ledger: batch_done for %s batch %d already recorded", step, batch)
            return False
        self.append(step=step, event="batch_done", batch=batch, **fields)
        done.add(batch)
        return True

    def events(self) -> list[dict]:
        """Parsed events without their ``crc`` key (cached until the file
        changes; treat as read-only).  Lines that fail to verify are
        skipped with a warning."""
        try:
            st = self.path.stat()
        except OSError:
            return []
        key = (st.st_mtime_ns, st.st_size)
        if self._cache is not None and self._cache[0] == key:
            return self._cache[1]
        out = []
        for lineno, line in enumerate(self.path.read_text().splitlines(), 1):
            if not line.strip():
                continue
            if not self._line_ok(line):
                if lineno not in self._warned:
                    self._warned.add(lineno)
                    logger.warning("ledger %s line %d is torn or corrupt — skipping it; "
                                   "resume treats the event as never recorded",
                                   self.path, lineno)
                continue
            parsed = json.loads(line)
            parsed.pop("crc", None)
            out.append(parsed)
        self._cache = (key, out)
        return out

    def completed_steps(self) -> set[str]:
        return {e["step"] for e in self.events() if e.get("event") == "step_done"}

    def completed_batches(self, step: str) -> set[int]:
        done: set[int] = set()
        for e in self.events():
            if e.get("step") != step:
                continue
            if e.get("event") == "batch_done":
                done.add(e["batch"])
            elif e.get("event") == "init_done":
                done.clear()
        return done

    def quarantined_batches(self, step: str) -> set[int]:
        """Batches recorded ``batch_failed`` and not completed since (a
        re-init clears them)."""
        q: set[int] = set()
        for e in self.events():
            if e.get("step") != step:
                continue
            if e.get("event") == "batch_failed":
                q.add(e["batch"])
            elif e.get("event") == "batch_done":
                q.discard(e["batch"])
            elif e.get("event") == "init_done":
                q.clear()
        return q

    def last_description_hash(self) -> str | None:
        h = None
        for e in self.events():
            if e.get("event") == "run_started":
                h = e.get("description_hash", h)
        return h

    def degraded_backend(self) -> dict | None:
        """The most recent ``backend_degraded`` event (the reference's
        device guard writes it; the port's engine never does)."""
        last = None
        for e in self.events():
            if e.get("event") == "backend_degraded":
                last = e
        return last

    def preempted(self) -> dict | None:
        """The trailing ``run_preempted`` event while the most recent run
        ended in a drain; a later ``run_started`` clears it."""
        last = None
        for e in self.events():
            if e.get("event") == "run_preempted":
                last = e
            elif e.get("event") == "run_started":
                last = None
        return last

    def status(self) -> dict[str, Any]:
        """Per-step state, batch progress, elapsed time, quarantine,
        pipeline stats, bucket routing and QC, folded from the events
        (the reference's ``status``, event for event)."""
        steps: dict[str, dict] = {}
        for e in self.events():
            s = e.get("step")
            if not s:
                continue
            entry = steps.setdefault(s, {"state": "pending", "batches_done": 0,
                                         "n_batches": None, "elapsed": 0.0,
                                         "quarantined": []})
            ev = e["event"]
            if ev == "init_done":
                entry.update(state="running", n_batches=e.get("n_batches"),
                             batches_done=0, quarantined=[])
            elif ev == "batch_done":
                entry["batches_done"] += 1
                entry["elapsed"] += e.get("elapsed", 0.0)
                if e.get("batch") in entry["quarantined"]:
                    entry["quarantined"].remove(e["batch"])
                result = e.get("result") or {}
                cap = result.get("bucket_capacity")
                if cap is not None:
                    buckets = entry.setdefault("buckets", {"routed": {}, "escalations": 0,
                                                           "occupancy_sum": 0.0,
                                                           "occupancy_n": 0})
                    buckets["routed"][str(cap)] = buckets["routed"].get(str(cap), 0) + 1
                    buckets["escalations"] += int(result.get("bucket_escalations", 0))
                    occ = result.get("slot_occupancy")
                    if occ is not None:
                        buckets["occupancy_sum"] += float(occ)
                        buckets["occupancy_n"] += 1
                qc = result.get("qc")
                if isinstance(qc, dict):
                    entry["qc"] = {"flagged": qc.get("flagged_total", 0),
                                   "nan_columns": qc.get("nan_columns", 0),
                                   "worst_focus": qc.get("worst_focus"),
                                   "count_z_max": qc.get("count_z_max")}
            elif ev == "qc_budget_exceeded":
                entry.setdefault("qc", {})["budget_exceeded"] = True
            elif ev == "batch_failed":
                if e.get("batch") not in entry["quarantined"]:
                    entry["quarantined"].append(e.get("batch"))
            elif ev in ("step_partial", "step_done"):
                entry["state"] = "partial" if ev == "step_partial" else "done"
                if e.get("pipeline_stats"):
                    entry["pipeline_stats"] = e["pipeline_stats"]
            elif ev == "step_failed":
                entry["state"] = "failed"
                entry["error"] = e.get("error")
            elif ev == "depth_clamped":
                entry.setdefault("depth_clamps", []).append(
                    {"from": e.get("from_depth"), "to": e.get("to_depth")})
            elif ev == "watchdog":
                entry["watchdog_fires"] = entry.get("watchdog_fires", 0) + 1
            elif ev == "run_preempted":
                entry["preempted"] = True
        return steps


class Workflow:
    """Run a workflow description against an experiment store on
    ``device``.

    Each batch runs under the retry policy; a batch that keeps failing is
    quarantined (a ``batch_failed`` event) while the step goes on, and
    the step fails only once its quarantined batches exceed the budget.
    ``resume`` re-attempts quarantined batches first."""

    def __init__(self, store: ExperimentStore, description: WorkflowDescription,
                 resilience: ResilienceConfig | None = None,
                 pipeline_depth: int | None = None,
                 device: "str | torch.device" = "cuda",
                 should_stop=None, stop_reason=None):
        description.validate()
        self.device = resolve_device(device)
        self.store = store
        self.description = description
        #: cooperative stop, polled at every step and batch boundary and
        #: in the executor's launch loop; default the preemption flag
        #: (the serve daemon adds the job's deadline)
        self._should_stop = should_stop if should_stop is not None else preemption_requested
        self._stop_reason = stop_reason if stop_reason is not None else preemption_reason
        cfg = LibraryConfig()
        self.ledger = RunLedger(
            store.workflow_dir / "ledger.jsonl", fsync=cfg.ledger_fsync,
            # single-host ledgers stay host-free; a fleet host stamps itself
            host=telemetry.host_id() if telemetry.fleet_active() else None)
        self.resilience = (resilience if resilience is not None
                           else ResilienceConfig.from_library_config(cfg))
        #: explicit in-flight depth for the pipelined executor; None: the
        #: per-device default
        self.pipeline_depth = pipeline_depth
        #: the run's PhaseWatchdog (None when off, the default)
        self._watchdog = None

    def description_hash(self) -> str:
        """Digest of the whole description, recorded in ``run_started`` so
        resume detects drift anywhere in the plan."""
        canon = json.dumps(self.description.to_dict(), sort_keys=True)
        return hashlib.sha256(canon.encode()).hexdigest()[:16]

    # ------------------------------------------------------------------ run
    def run(self, resume: bool = False) -> dict:
        """Run all active steps in order; with ``resume`` skip completed
        steps and the completed batches of an interrupted one.  A rank
        other than 0 follows rank 0's plan and returns ``{}``."""
        if not distributed.is_writer():
            return self._follow()
        if not resume and self.ledger.path.exists():
            self.ledger.path.unlink()
        desc_hash = self.description_hash()
        if resume:
            prev = self.ledger.last_description_hash()
            if prev is not None and prev != desc_hash:
                logger.warning("resume: workflow description changed since the last run "
                               "(%s -> %s) — steps whose args changed will re-plan",
                               prev, desc_hash)
                self.ledger.append(event="description_drift", previous=prev,
                                   current=desc_hash)
        self.ledger.append(event="run_started", description_hash=desc_hash, resume=resume)
        # compile spans recorded before this run (a step driven outside the
        # engine) belong to no run's ledger
        perf.pop_compile_spans()
        self._run_wall_t0 = time.time()
        self._first_batch_noted = False
        telemetry.get_registry().counter("tmx_runs_total").inc()
        sampler = self._start_sampler()
        self._watchdog = watchdog_from_config()
        done_steps = self.ledger.completed_steps() if resume else set()
        summary = {}
        try:
            with telemetry.span("run", emit=self.ledger.append):
                for stage in self.description.stages:
                    for sd in stage.steps:
                        if not sd.active:
                            continue
                        done = sd.name in done_steps
                        # the boundary between steps is already clean
                        stop, reason = self._poll_stop(applies=not done)
                        if done:
                            logger.info("resume: skipping completed step %s", sd.name)
                            self._announce(None)
                            distributed.sync_hosts(f"{sd.name} batches")
                            continue
                        if stop:
                            self._note_preempted(PreemptedError(
                                f"preempted before step '{sd.name}'", step=sd.name,
                                reason=reason))
                        with telemetry.span("step", emit=functools.partial(
                                self.ledger.append, step=sd.name), trace_label=sd.name):
                            summary[sd.name] = self._run_step(sd, resume)
        finally:
            if self._watchdog is not None:
                self._watchdog.stop()
                self._drain_watchdog()
                self._watchdog = None
            if sampler is not None:
                sampler.stop()
            self._drain_compile_spans()
            exc = sys.exc_info()[1]
            if exc is not None and not isinstance(exc, PreemptedError) \
                    and not (isinstance(exc, FaultInjected) and exc.fatal):
                # a crash keeps the event ring for the post-mortem (a
                # fatal injected fault is a dead process: it writes nothing)
                telemetry.flight_dump(telemetry.flightrec_path(self.store.workflow_dir),
                                      reason=f"crash:{type(exc).__name__}")
            self._write_metrics_snapshot()
        return summary

    def _drain_watchdog(self, step_name: str | None = None) -> None:
        """Append the watchdog's queued events on the engine thread (the
        only thread that touches the ledger) and dump the flight ring."""
        wd = self._watchdog
        if wd is None:
            return
        fired = False
        for ev in wd.drain_events():
            if step_name is not None:
                ev.setdefault("step", step_name)
            self.ledger.append(**ev)
            fired = True
        if fired:
            telemetry.flight_dump(telemetry.flightrec_path(self.store.workflow_dir),
                                  reason="watchdog", extra={"step": step_name})

    def _drain_compile_spans(self, step_name: str | None = None) -> None:
        """Append the compile spans :mod:`~tmlibrary_tpu_torch.perf`
        buffered (its records can come from persist workers; only the
        engine thread appends to the ledger); nothing with telemetry
        off."""
        if not telemetry.enabled():
            return
        for sp in perf.pop_compile_spans():
            if step_name is not None:
                sp.setdefault("step", step_name)
            self.ledger.append(event="span", span="compile", **sp)

    def _note_preempted(self, exc: PreemptedError) -> None:
        """Record the drain boundary (``run_preempted``, the counter, a
        flight dump) and re-raise; the CLI exits ``EXIT_PREEMPTED``."""
        self._drain_watchdog(exc.step)
        self.ledger.append(event="run_preempted", step=exc.step, reason=exc.reason,
                           in_flight=exc.in_flight, drained=exc.drained,
                           abandoned=exc.abandoned)
        telemetry.flight_dump(telemetry.flightrec_path(self.store.workflow_dir),
                              reason=f"preempted:{exc.reason}", extra={"step": exc.step})
        telemetry.get_registry().counter("tmx_preemptions_total").inc()
        logger.warning("run preempted (%s) at step '%s': drained %d/%d in-flight batches, "
                       "abandoned %d un-launched — resume with `workflow resume`",
                       exc.reason, exc.step, exc.drained, exc.in_flight, exc.abandoned)
        raise exc

    def _write_metrics_snapshot(self) -> None:
        """The QC profile, then with telemetry on the live registry as
        ``metrics.<host>.json`` (and ``metrics.json`` on host0) next to
        the ledger, one sample per series into the tsdb segment and the
        perf store as ``perf.json``; written on failure too."""
        self._write_qc_profile()
        if not telemetry.enabled():
            return
        rendered = telemetry.render_json(telemetry.get_registry().snapshot())
        atomic_write_text(telemetry.snapshot_path(self.store.workflow_dir), rendered)
        if telemetry.host_id() == "host0":
            atomic_write_text(self.store.workflow_dir / "metrics.json", rendered)
        timeseries.flush_registry(self.store.workflow_dir)
        # the per-program attribution `perf` reads
        snap = perf.perf_snapshot()
        if snap["programs"]:
            atomic_write_text(self.store.workflow_dir / "perf.json",
                              json.dumps(snap, indent=2) + "\n")

    def _start_sampler(self):
        """The resource sampler and heartbeat of this run, when telemetry
        is on and a sample period is set."""
        period = float(LibraryConfig().resource_sample_period or 0)
        if not telemetry.enabled() or period <= 0:
            return None
        return telemetry.ResourceSampler(
            period, heartbeat_path=telemetry.heartbeat_path(self.store.workflow_dir)).start()

    def _note_straggler(self, step_name: str, batch_index, result) -> None:
        """A ``straggler`` event when a batch's per-rank wall times skew
        past the threshold (the times ride the batch result)."""
        if not telemetry.enabled() or not isinstance(result, dict):
            return
        times = result.get("device_wall_times")
        skew = result.get("straggler_skew_s")
        if not times or skew is None:
            return
        slowest = max(float(t) for t in times.values())
        if float(skew) <= telemetry.straggler_threshold(slowest):
            return
        extra = {}
        if result.get("predicted_shard_work"):
            extra["predicted_shard_work"] = [float(w) for w in result["predicted_shard_work"]]
            extra["predicted_skew"] = float(result.get("predicted_skew", 0.0))
        self.ledger.append(step=step_name, event="straggler", batch=batch_index,
                           skew_s=float(skew), device_wall_times=times, **extra)

    @staticmethod
    def _announce(plan: "dict | None") -> "dict | None":
        """Rank 0 sends its plan of the step it runs next (``pending``: the
        batch indices in order, ``depth``: the pipelined executor's depth
        or None, ``budget``: the quarantine budget; None for a completed
        step it skips) and the other ranks receive it; one rank: the
        plan."""
        return distributed.broadcast_object(plan)

    # ------------------------------------------------------ rank agreement
    @staticmethod
    def _agree(report: dict, decide, peers: bool = True) -> dict:
        """Rank 0's decision on every rank's ``report``: the reports are
        gathered on rank 0, ``decide(reports)`` runs there and its result
        reaches every rank; one rank, or a step rank 0 runs without its
        peers (``peers`` False): ``decide([report])``."""
        if not peers or distributed.world_size() == 1:
            return decide([report])
        reports = distributed.gather_object(report)
        return distributed.broadcast_object(None if reports is None else decide(reports))

    def _stop_report(self, applies: bool = True) -> dict:
        stop = applies and bool(self._should_stop())
        return {"stop": stop, "reason": self._stop_reason() if stop else None}

    @staticmethod
    def _stops(reports: list[dict], applies: bool = True) -> "dict | None":
        """The stop decision when a rank asks for one (and it applies)."""
        asked = [r for r in reports if r.get("stop")]
        if applies and asked:
            return {"do": "stop", "reason": asked[0]["reason"]}
        return None

    def _poll_stop(self, applies: bool = True) -> tuple[bool, "str | None"]:
        """Whether the run stops here, and why: at one rank the stop hook
        (not polled where ``applies`` is False), at several the ranks'
        hooks judged by rank 0 (every rank polls, so the collective
        pairs)."""
        if distributed.world_size() == 1:
            if applies and self._should_stop():
                return True, self._stop_reason()
            return False, None
        d = self._agree(self._stop_report(),
                        lambda rs: self._stops(rs, applies) or {"do": "go"})
        return d["do"] == "stop", d.get("reason")

    @staticmethod
    def _error_report(err: "BaseException | None") -> dict:
        """A rank's outcome; a :class:`PeerFailed` is another rank's
        failure, which that rank reports."""
        if err is None or isinstance(err, PeerFailed):
            return {"error": None}
        return {"error": str(err), "exception": type(err).__name__,
                "classification": classify(err)}

    def _agree_persist(self, err: "BaseException | None") -> None:
        """The pipelined window's agreement before a persist's collectives
        (several ranks): when the ``persist`` fault site fired on any
        rank, ``err`` is raised where it fired and :class:`PeerFailed`
        on every other rank, so every rank yields the batch as failed
        and rank 0 decides its retry."""
        d = self._agree(self._error_report(err), lambda rs: next(
            ({"do": "fail", "rank": i, **r} for i, r in enumerate(rs) if r["error"]),
            {"do": "go"}))
        if err is not None:
            raise err
        if d["do"] == "fail":
            raise PeerFailed(f"rank {d['rank']}: {d['exception']}: {d['error']}")

    @staticmethod
    def _verdict(reports: list[dict], attempt: int, policy: RetryPolicy, t0: float,
                 describe: str, after_run: bool) -> dict:
        """Rank 0's judgement of one attempt of a batch: a stop first,
        then ``run``/``ok`` when no rank failed, else a retry after the
        policy's delay while the failures are transient and attempts and
        deadline remain, else ``fail`` (quarantine)."""
        stop = None if after_run else Workflow._stops(reports)
        if stop is not None:
            return stop
        failed = [(rank, r) for rank, r in enumerate(reports) if r.get("error")]
        if not failed:
            return {"do": "ok" if after_run else "run"}
        rank, first = failed[0]
        cls = PERMANENT if any(r["classification"] == PERMANENT for _, r in failed) \
            else TRANSIENT
        if cls == PERMANENT:
            logger.warning("%s failed permanently on rank %d (%s: %s) — not retrying",
                           describe, rank, first["exception"], first["error"])
        elif attempt < policy.max_attempts:
            pause = policy.delay(attempt)
            if policy.deadline is None or time.monotonic() - t0 + pause <= policy.deadline:
                logger.warning("%s failed on rank %d (%s: %s) — retry %d/%d on every rank "
                               "in %.2fs", describe, rank, first["exception"], first["error"],
                               attempt, policy.max_attempts - 1, pause)
                telemetry.get_registry().counter("tmx_retry_attempts_total").inc()
                return {"do": "retry", "delay": pause}
            logger.warning("%s: retry deadline (%.1fs) exhausted", describe, policy.deadline)
        return {"do": "fail", "rank": rank, "error": first["error"],
                "exception": first["exception"], "classification": cls}

    def _agreed_attempts(self, step, batch: dict, policy: RetryPolicy, abandoned: int,
                         peers: bool, attempt: int = 1,
                         t0: "float | None" = None) -> RetryOutcome:
        """Attempts of one batch, each decided by rank 0 on every rank of a
        sharding step (``peers``), else by this rank alone (before it: the
        stop hooks and the ``batch_run`` fault site, which fire before any
        collective of the batch; after it: whether it raised anywhere).
        Raises :class:`PreemptedError` on every rank for a stop; a step
        rank 0 runs without its peers polls no stop."""
        t0 = time.monotonic() if t0 is None else t0
        describe = f"{step.name} batch {batch['index']}"
        stops = peers or distributed.world_size() == 1
        while True:
            err = None
            try:
                faults.maybe_fire("batch_run", step=step.name, batch=batch["index"])
            except Exception as e:
                if isinstance(e, FaultInjected) and e.fatal:
                    raise
                err = e
            d = self._agree({**self._stop_report(stops), **self._error_report(err)},
                            lambda rs: self._verdict(rs, attempt, policy, t0, describe, False),
                            peers)
            if d["do"] == "stop":
                raise PreemptedError(
                    f"preempted before batch {batch['index']} of '{step.name}': abandoned "
                    f"{abandoned} pending batches", step=step.name, abandoned=abandoned,
                    reason=d["reason"])
            value = None
            if d["do"] == "run":
                try:
                    with telemetry.trace_range(f"batch:{batch['index']}"):
                        value = step.run_batch(batch)
                except Exception as e:
                    if isinstance(e, FaultInjected) and e.fatal:
                        raise
                    err = e
                d = self._agree(self._error_report(err), lambda rs: self._verdict(
                    rs, attempt, policy, t0, describe, True), peers)
                if d["do"] == "ok":
                    return RetryOutcome(value=value, attempts=attempt)
            if d["do"] == "retry":
                time.sleep(d["delay"])
                attempt += 1
                continue
            if err is None:
                err = WorkflowError(f"rank {d['rank']}: {d['exception']}: {d['error']}")
            return RetryOutcome(error=err, attempts=attempt, classification=d["classification"])

    def _judged(self, step, batch: dict, result, policy: RetryPolicy, abandoned: int,
                peers: bool) -> RetryOutcome:
        """The outcome of a batch whose first attempt ran in the pipelined
        window (``result``: its summary, a :class:`BatchFailure` or the
        exception the window raised), judged as an attempt of
        :meth:`_agreed_attempts`, which runs its retries one by one."""
        err = result.error if isinstance(result, BatchFailure) else \
            result if isinstance(result, BaseException) else None
        t0 = time.monotonic()
        describe = f"{step.name} batch {batch['index']}"
        d = self._agree(self._error_report(err), lambda rs: self._verdict(
            rs, 1, policy, t0, describe, True), peers)
        if d["do"] == "retry":
            time.sleep(d["delay"])
            return self._agreed_attempts(step, batch, policy, abandoned, peers, 2, t0)
        if d["do"] == "fail":
            return RetryOutcome(
                error=err or WorkflowError(f"rank {d['rank']}: {d['exception']}: {d['error']}"),
                attempts=1, classification=d["classification"])
        return RetryOutcome(value=result, attempts=1)

    def _follow(self) -> dict:
        """A rank other than 0: for each active step, the step-boundary
        stop poll, then rank 0's plan; a step that shards over ranks runs
        the planned batches with every outcome agreed, raising as rank 0
        does for a stop or past the quarantine budget; then the step's
        barrier."""
        for stage in self.description.stages:
            for sd in stage.steps:
                if not sd.active:
                    continue
                stop, reason = self._poll_stop()
                if stop:
                    raise PreemptedError(f"preempted before step '{sd.name}'", step=sd.name,
                                         reason=reason)
                plan = self._announce(None)
                step = get_step(sd.name)(self.store, device=self.device)
                collective = getattr(step, "collective", False)
                if collective and plan is not None:
                    pending = [step.load_batch(i) for i in plan["pending"]]
                    pstats = (None if plan["depth"] is None
                              else PipelineStats(plan["depth"], "rank 0", step=sd.name))
                    failed = 0
                    for _, outcome in self._iter_outcomes(step, pending, RetryPolicy(),
                                                          pstats):
                        failed += not outcome.ok
                        if failed > plan["budget"]:
                            raise WorkflowError(
                                f"step '{sd.name}': {failed} failed batches exceeds the "
                                f"quarantine budget ({plan['budget']})") from outcome.error
                distributed.sync_hosts(f"{sd.name} batches")
                # rank 0 collects now (a skipped step announced None)
                if collective and plan is not None and hasattr(step, "collective_collect"):
                    step.collective_collect()
        return {}

    def _write_qc_profile(self) -> None:
        """The QC session's profile as ``qc.<host>.json``, and as
        ``qc.json`` on ``host0``; nothing when QC is off.  A failed write
        raises (the reference logs it at debug level)."""
        profile = qc_mod.get_session().snapshot()
        if not profile:
            return
        wf = self.store.workflow_dir
        qc_mod.write_profile(qc_mod.profile_path(wf), profile)
        if telemetry.host_id() == "host0":
            qc_mod.write_profile(wf / "qc.json", profile)

    def _note_qc(self, step_name: str, batch_index, result) -> int:
        """``qc_batch`` and one ``qc_site`` per flagged site when a batch
        summary carries a QC summary; returns the sites flagged."""
        summary = result.get("qc") if isinstance(result, dict) else None
        if not isinstance(summary, dict):
            return 0
        flagged = summary.get("flagged_sites") or []
        self.ledger.append(step=step_name, event="qc_batch", batch=batch_index,
                           summary={k: v for k, v in summary.items() if k != "flagged_sites"})
        for site in flagged:
            self.ledger.append(step=step_name, event="qc_site", batch=batch_index,
                               **{k: v for k, v in site.items() if k != "step"})
        return len(flagged)

    # ---------------------------------------------------------- batch level
    def _iter_outcomes(self, step, pending: list[dict], policy: RetryPolicy,
                       pstats: PipelineStats | None = None):
        """``(batch, RetryOutcome)`` for every pending batch: through the
        pipelined executor for steps with the launch/persist split, else
        one by one, every attempt judged by :meth:`_verdict`.  A step that
        shards over several ranks agrees on every outcome (the module
        docstring); a step that does not runs on rank 0 alone without
        stop polls.  After a failure in the pipeline at one rank the
        failing batch is retried and the rest run one by one.  A stop
        surfaces as :class:`PreemptedError`, never as a batch failure."""
        ranks = distributed.world_size()
        peers = ranks > 1 and getattr(step, "collective", False)
        if peers:
            should_stop = lambda: self._poll_stop()[0]  # noqa: E731
        elif ranks > 1:
            should_stop = lambda: False  # noqa: E731
        else:
            should_stop = self._should_stop
        gen = None
        if pstats is not None and pending:
            on_event = (lambda **ev: self.ledger.append(step=step.name, **ev)) \
                if distributed.is_writer() else None
            gen = PipelinedExecutor(
                step, depth=pstats.depth, stats=pstats, on_event=on_event,
                should_stop=should_stop, watchdog=self._watchdog,
                agree=self._agree_persist if peers else None,
            ).run(pending)
        pos = 0
        while pos < len(pending):
            batch, abandoned = pending[pos], len(pending) - pos
            if gen is None:
                yield batch, self._agreed_attempts(step, batch, policy, abandoned, peers)
                pos += 1
                continue
            try:
                batch, result = next(gen)
            except StopIteration:
                break
            except Exception as e:
                if isinstance(e, FaultInjected) and e.fatal:
                    raise
                if isinstance(e, PreemptedError):
                    raise  # drained cleanly: not a batch failure
                logger.warning("%s: pipelined runner failed at batch %d — running the "
                               "rest one by one", step.name, batch["index"])
                gen, result = None, e
            yield batch, self._judged(step, batch, result, policy, abandoned, peers)
            pos += 1

    @staticmethod
    def _call_collect(step, results: list[dict]):
        """``collect(results=...)`` when the step takes the surviving batch
        results, else ``collect()``."""
        try:
            params = inspect.signature(step.collect).parameters
        except (TypeError, ValueError):
            params = {}
        if "results" in params:
            return step.collect(results=results)
        return step.collect()

    # ----------------------------------------------------------- step level
    def _run_step(self, sd: WorkflowStepDescription, resume: bool) -> dict:
        step = get_step(sd.name)(self.store, device=self.device)
        res = self.resilience
        policy = res.policy if res.enabled else RetryPolicy(max_attempts=1, base_delay=0.0)
        t0 = time.time()
        current_batch: int | None = None
        try:
            existing = step.list_batches() if resume else []
            quarantined: set[int] = set()
            if existing:
                batches = [step.load_batch(i) for i in existing]
                done = self.ledger.completed_batches(sd.name)
                quarantined = self.ledger.quarantined_batches(sd.name)
                # args changed since the batches were planned: re-plan
                if batches and step.batch_args.resolve(sd.args) != batches[0]["args"]:
                    logger.info("resume: args changed for %s, re-planning", sd.name)
                    existing = []
            if not existing:
                batches = step.init(sd.args)
                batches = [step.load_batch(i) for i in range(len(batches))]
                done, quarantined = set(), set()
                self.ledger.append(step=sd.name, event="init_done", n_batches=len(batches))
            # the packing plan's digest, recorded again on resume from the
            # plan's side file
            plan_info = getattr(step, "schedule_plan_info", None)
            if callable(plan_info):
                try:
                    info = plan_info()
                except Exception:
                    info = None
                if info:
                    self.ledger.append(step=sd.name, event="schedule_plan", **info)
            pending = [b for b in batches if b["index"] not in done]
            # quarantined batches first: the most suspect work re-runs first
            pending.sort(key=lambda b: (b["index"] not in quarantined, b["index"]))
            if quarantined:
                logger.info("resume: re-attempting quarantined batches %s of %s first",
                            sorted(quarantined), sd.name)
            results: list[dict] = []
            failed: list[dict] = []
            budget = res.failure_budget(len(batches)) if res.enabled else 0
            qc_flagged = 0
            qc_budget_noted = False
            qc_sites_total = sum(len(b.get("sites") or []) for b in batches)
            qc_site_budget = (int(res.qc_flag_budget * qc_sites_total)
                              if res.enabled and qc_sites_total else 0)
            pstats = None
            if pending and supports_pipelining(step) and not faults.sequential_forced():
                depth, source = resolve_pipeline_depth(self.pipeline_depth, self.device)
                pstats = PipelineStats(depth, source, step=sd.name)
                logger.info("%s: pipelined executor, in-flight depth %d (source: %s)",
                            sd.name, depth, source)
            self._announce({"pending": [b["index"] for b in pending],
                            "depth": None if pstats is None else pstats.depth,
                            "budget": budget})
            metrics = telemetry.get_registry()
            bt0 = time.time()
            with step.capture_logs("run"):
                for batch, outcome in self._iter_outcomes(step, pending, policy, pstats):
                    current_batch = batch["index"]
                    self._drain_watchdog(sd.name)
                    self._drain_compile_spans(sd.name)
                    if outcome.ok:
                        b_elapsed = time.time() - bt0
                        if telemetry.enabled():
                            self.ledger.append(step=sd.name, event="span", span="batch",
                                               batch=batch["index"], t0=round(bt0, 6),
                                               elapsed=round(b_elapsed, 6))
                        self.ledger.append_batch_done(
                            sd.name, batch["index"], elapsed=b_elapsed,
                            attempts=outcome.attempts, result=outcome.value)
                        if not self._first_batch_noted and hasattr(step, "launch_batch"):
                            # time to the first persisted batch of a device step
                            self._first_batch_noted = True
                            ttfb = time.time() - self._run_wall_t0
                            self.ledger.append(
                                step=sd.name, event="first_batch",
                                first_batch_index=batch["index"],
                                time_to_first_batch_s=round(ttfb, 6))
                            metrics.gauge("tmx_time_to_first_batch_seconds").set(round(ttfb, 6))
                        self._note_straggler(sd.name, batch["index"], outcome.value)
                        qc_flagged += self._note_qc(sd.name, batch["index"], outcome.value)
                        if qc_site_budget and not qc_budget_noted \
                                and qc_flagged > qc_site_budget:
                            qc_budget_noted = True  # a warning, never a failure
                            self.ledger.append(step=sd.name, event="qc_budget_exceeded",
                                               flagged=qc_flagged, budget=qc_site_budget)
                            metrics.counter("tmx_qc_budget_exceeded_total", step=sd.name).inc()
                            logger.warning("%s: QC flagged %d sites, more than the budget "
                                           "(%d)", sd.name, qc_flagged, qc_site_budget)
                        metrics.counter("tmx_batches_done_total", step=sd.name).inc()
                        metrics.histogram("tmx_batch_seconds", step=sd.name).observe(b_elapsed)
                        if outcome.attempts > 1:
                            metrics.counter("tmx_batch_retries_total", step=sd.name).inc(
                                outcome.attempts - 1)
                        results.append(outcome.value)
                        bt0 = time.time()
                        continue
                    failure = {
                        "batch": batch["index"],
                        "error": str(outcome.error),
                        "exception": type(outcome.error).__name__,
                        "attempts": outcome.attempts,
                        "classification": outcome.classification,
                    }
                    self.ledger.append(step=sd.name, event="batch_failed", **failure)
                    metrics.counter("tmx_batches_failed_total", step=sd.name).inc()
                    metrics.counter("tmx_batches_quarantined_total", step=sd.name).inc()
                    failed.append(failure)
                    bt0 = time.time()
                    if len(failed) > budget:
                        raise WorkflowError(
                            f"step '{sd.name}': {len(failed)} failed batches exceeds the "
                            f"quarantine budget ({budget} of {len(batches)})"
                        ) from outcome.error
                    logger.error("%s: batch %d quarantined after %d attempt(s) (%s: %s) — "
                                 "step continues (%d/%d budget used)", sd.name,
                                 batch["index"], outcome.attempts, failure["exception"],
                                 failure["error"], len(failed), budget)
                distributed.sync_hosts(f"{sd.name} batches")
                collected = self._call_collect(step, results)
            self._drain_compile_spans(sd.name)
            metrics.histogram("tmx_step_seconds", step=sd.name).observe(time.time() - t0)
            extra = {"pipeline_stats": pstats.summary()} if pstats is not None else {}
            if failed:
                # no step_done: resume re-attempts the quarantined batches
                quarantine = sorted(f["batch"] for f in failed)
                self.ledger.append(step=sd.name, event="step_partial",
                                   elapsed=time.time() - t0, collected=collected,
                                   quarantined=quarantine, **extra)
                metrics.counter("tmx_steps_partial_total", step=sd.name).inc()
                return {"n_batches": len(batches), "collected": collected,
                        "quarantined": quarantine}
            self.ledger.append(step=sd.name, event="step_done", elapsed=time.time() - t0,
                               collected=collected, **extra)
            metrics.counter("tmx_steps_done_total", step=sd.name).inc()
            return {"n_batches": len(batches), "collected": collected}
        except PreemptedError as e:
            # a drain, not a failure: the ledger boundary is clean
            if e.step is None:
                e.step = sd.name
            if e.reason == "signal":
                e.reason = self._stop_reason()
            self._note_preempted(e)
        except FaultInjected as e:
            if e.fatal:
                raise  # a simulated hard crash: no further ledger writes
            self.ledger.append(step=sd.name, event="step_failed", error=str(e),
                               exception=type(e).__name__, batch=current_batch)
            telemetry.get_registry().counter("tmx_steps_failed_total", step=sd.name).inc()
            raise WorkflowError(f"step '{sd.name}' failed: {e}") from e
        except WorkflowError as e:
            # the quarantine budget overflow: the original class stays
            # visible through __cause__
            self.ledger.append(step=sd.name, event="step_failed", error=str(e),
                               exception=type(e.__cause__ or e).__name__,
                               batch=current_batch)
            telemetry.get_registry().counter("tmx_steps_failed_total", step=sd.name).inc()
            raise
        except Exception as e:
            self.ledger.append(step=sd.name, event="step_failed", error=str(e),
                               exception=type(e).__name__, batch=current_batch)
            telemetry.get_registry().counter("tmx_steps_failed_total", step=sd.name).inc()
            raise WorkflowError(f"step '{sd.name}' failed: {e}") from e
