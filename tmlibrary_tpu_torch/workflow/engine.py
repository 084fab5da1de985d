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
- Telemetry (spans, metrics snapshots, the flight recorder), fault
  injection, the phase watchdog, preemption and fleet host attribution
  are not ported (ROADMAP A item 11).

**Several ranks.**  Under a process group of more than one rank
(``torchrun``, :func:`tmlibrary_tpu_torch.parallel.distributed.initialize`)
rank 0 runs the engine as above: it plans, appends to the ledger and
collects.  For each step it sends the other ranks the indices of the
batches it is about to run, in order; they run the same batches of the
steps that shard over ranks (``collective = True``: corilla, illuminati,
jterator), whose collectives pair with rank 0's, and skip the others.
The ranks meet at a barrier after each step's batches; a step with a
``collective_collect`` (jterator's re-segmentation of saturated batches)
then runs it on every rank while rank 0 collects.  There are no
retries and no pipelining then (a retry on one rank alone would wait
forever on the others), and a failed batch fails the run.

At the end of a run, finished or failed, the engine writes the QC
session's profile (:mod:`tmlibrary_tpu_torch.qc`) to
``workflow/qc.<host>.json`` and, on ``host0``, ``workflow/qc.json``, as
the reference does (``:783-802``); with QC off it writes nothing.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
import logging
import os
import time
import zlib
from pathlib import Path
from typing import Any

import torch

from tmlibrary_tpu_torch import qc as qc_mod
from tmlibrary_tpu_torch import yamlio
from tmlibrary_tpu_torch.atomicio import atomic_write_text
from tmlibrary_tpu_torch.config import LibraryConfig
from tmlibrary_tpu_torch.device import resolve_device
from tmlibrary_tpu_torch.errors import WorkflowError
from tmlibrary_tpu_torch.models.store import ExperimentStore
from tmlibrary_tpu_torch.parallel import distributed
from tmlibrary_tpu_torch.resilience import (
    PERMANENT,
    ResilienceConfig,
    RetryOutcome,
    RetryPolicy,
    classify,
    retry_call,
)
from tmlibrary_tpu_torch.workflow.pipelined import (
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

    def __init__(self, path: Path, fsync: bool = False):
        self.path = Path(path)
        self.fsync = fsync
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
        line = self._seal(json.dumps(event))
        self._cache = None
        if event.get("event") == "init_done":
            self._done_cache.clear()  # a re-init invalidates earlier completions
        with open(self.path, "a") as f:
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
                 device: "str | torch.device" = "cuda"):
        description.validate()
        self.device = resolve_device(device)
        self.store = store
        self.description = description
        cfg = LibraryConfig()
        self.ledger = RunLedger(store.workflow_dir / "ledger.jsonl", fsync=cfg.ledger_fsync)
        self.resilience = (resilience if resilience is not None
                           else ResilienceConfig.from_library_config(cfg))
        #: explicit in-flight depth for the pipelined executor; None: the
        #: per-device default
        self.pipeline_depth = pipeline_depth

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
        self._run_wall_t0 = time.time()
        self._first_batch_noted = False
        done_steps = self.ledger.completed_steps() if resume else set()
        summary = {}
        try:
            for stage in self.description.stages:
                for sd in stage.steps:
                    if not sd.active:
                        continue
                    if sd.name in done_steps:
                        logger.info("resume: skipping completed step %s", sd.name)
                        self._announce(None)
                        distributed.sync_hosts(f"{sd.name} batches")
                        continue
                    summary[sd.name] = self._run_step(sd, resume)
        finally:
            self._write_qc_profile()
        return summary

    @staticmethod
    def _announce(pending: "list[int] | None") -> "list[int]":
        """Rank 0 sends the batch indices it will run next (a list, in
        order; None for a completed step it skips) and the other ranks
        receive them; one rank: the list."""
        return distributed.broadcast_object(pending)

    def _follow(self) -> dict:
        """A rank other than 0: for each active step, run the batches rank
        0 announces when the step shards over ranks, then meet at the
        step's barrier."""
        for stage in self.description.stages:
            for sd in stage.steps:
                if not sd.active:
                    continue
                pending = self._announce(None)
                step = get_step(sd.name)(self.store, device=self.device)
                collective = getattr(step, "collective", False)
                if collective:
                    for index in pending or []:
                        step.run_batch(step.load_batch(index))
                distributed.sync_hosts(f"{sd.name} batches")
                # rank 0 collects now (a skipped step announced None)
                if collective and pending is not None and hasattr(step, "collective_collect"):
                    step.collective_collect()
        return {}

    def _write_qc_profile(self) -> None:
        """The QC session's profile as ``qc.<host>.json``, and as
        ``qc.json`` on ``host0``; nothing when QC is off."""
        profile = qc_mod.get_session().snapshot()
        if not profile:
            return
        wf = self.store.workflow_dir
        try:
            qc_mod.write_profile(qc_mod.profile_path(wf), profile)
            if qc_mod.host_id() == "host0":
                qc_mod.write_profile(wf / "qc.json", profile)
        except OSError:
            logger.debug("qc profile write failed", exc_info=True)

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
    def _retry_after(self, step, batch: dict, first_exc: Exception,
                     policy: RetryPolicy) -> RetryOutcome:
        """Fold an already-observed failure into the retry budget and run
        the remaining attempts one by one."""
        cls = classify(first_exc)
        if cls is PERMANENT or policy.max_attempts <= 1:
            return RetryOutcome(error=first_exc, attempts=1, classification=cls)
        remaining = dataclasses.replace(policy, max_attempts=policy.max_attempts - 1)
        out = retry_call(lambda: step.run_batch(batch), remaining,
                         describe=f"{step.name} batch {batch['index']}")
        out.attempts += 1
        return out

    def _iter_outcomes(self, step, pending: list[dict], policy: RetryPolicy,
                       pstats: PipelineStats | None = None):
        """``(batch, RetryOutcome)`` for every pending batch: through the
        pipelined executor for steps with the launch/persist split, else
        one by one.  After a failure in the pipeline the failing batch
        is retried and the rest run one by one."""
        gen = None
        if pstats is not None and pending:
            gen = PipelinedExecutor(
                step, depth=pstats.depth, stats=pstats,
                on_event=lambda **ev: self.ledger.append(step=step.name, **ev),
            ).run(pending)
        pos = 0
        while pos < len(pending):
            if gen is not None:
                try:
                    batch, result = next(gen)
                except StopIteration:
                    break
                except Exception as e:
                    logger.warning("%s: pipelined runner failed at batch %d — running the "
                                   "rest one by one", step.name, pending[pos]["index"])
                    gen = None
                    yield pending[pos], self._retry_after(step, pending[pos], e, policy)
                    pos += 1
                    continue
                yield batch, RetryOutcome(value=result, attempts=1)
                pos += 1
            else:
                batch = pending[pos]
                try:
                    yield batch, RetryOutcome(value=step.run_batch(batch), attempts=1)
                except Exception as e:
                    yield batch, self._retry_after(step, batch, e, policy)
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
        ranks = distributed.world_size()
        policy = res.policy if res.enabled and ranks == 1 else \
            RetryPolicy(max_attempts=1, base_delay=0.0)
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
            self._announce([b["index"] for b in pending])
            results: list[dict] = []
            failed: list[dict] = []
            budget = res.failure_budget(len(batches)) if res.enabled and ranks == 1 else 0
            qc_flagged = 0
            qc_budget_noted = False
            qc_sites_total = sum(len(b.get("sites") or []) for b in batches)
            qc_site_budget = (int(res.qc_flag_budget * qc_sites_total)
                              if res.enabled and qc_sites_total else 0)
            pstats = None
            if pending and supports_pipelining(step) and ranks == 1:
                depth, source = resolve_pipeline_depth(self.pipeline_depth, self.device)
                pstats = PipelineStats(depth, source)
                logger.info("%s: pipelined executor, in-flight depth %d (source: %s)",
                            sd.name, depth, source)
            bt0 = time.time()
            with step.capture_logs("run"):
                for batch, outcome in self._iter_outcomes(step, pending, policy, pstats):
                    current_batch = batch["index"]
                    if outcome.ok:
                        self.ledger.append_batch_done(
                            sd.name, batch["index"], elapsed=time.time() - bt0,
                            attempts=outcome.attempts, result=outcome.value)
                        if not self._first_batch_noted and hasattr(step, "launch_batch"):
                            # time to the first persisted batch of a device step
                            self._first_batch_noted = True
                            self.ledger.append(
                                step=sd.name, event="first_batch",
                                first_batch_index=batch["index"],
                                time_to_first_batch_s=round(time.time() - self._run_wall_t0,
                                                            6))
                        qc_flagged += self._note_qc(sd.name, batch["index"], outcome.value)
                        if qc_site_budget and not qc_budget_noted \
                                and qc_flagged > qc_site_budget:
                            qc_budget_noted = True  # a warning, never a failure
                            self.ledger.append(step=sd.name, event="qc_budget_exceeded",
                                               flagged=qc_flagged, budget=qc_site_budget)
                            logger.warning("%s: QC flagged %d sites, more than the budget "
                                           "(%d)", sd.name, qc_flagged, qc_site_budget)
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
            extra = {"pipeline_stats": pstats.summary()} if pstats is not None else {}
            if failed:
                # no step_done: resume re-attempts the quarantined batches
                quarantine = sorted(f["batch"] for f in failed)
                self.ledger.append(step=sd.name, event="step_partial",
                                   elapsed=time.time() - t0, collected=collected,
                                   quarantined=quarantine, **extra)
                return {"n_batches": len(batches), "collected": collected,
                        "quarantined": quarantine}
            self.ledger.append(step=sd.name, event="step_done", elapsed=time.time() - t0,
                               collected=collected, **extra)
            return {"n_batches": len(batches), "collected": collected}
        except WorkflowError as e:
            # the quarantine budget overflow: the original class stays
            # visible through __cause__
            self.ledger.append(step=sd.name, event="step_failed", error=str(e),
                               exception=type(e.__cause__ or e).__name__,
                               batch=current_batch)
            raise
        except Exception as e:
            self.ledger.append(step=sd.name, event="step_failed", error=str(e),
                               exception=type(e).__name__, batch=current_batch)
            raise WorkflowError(f"step '{sd.name}' failed: {e}") from e
