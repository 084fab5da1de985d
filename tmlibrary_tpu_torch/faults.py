"""Deterministic fault-injection harness.

Counterpart: ``tmlibrary_tpu/faults.py``, which imports no JAX; the port keeps
its own copy, held equal to it on the same inputs by
``tests/test_torch_telemetry.py``.

The dominant real-world failure mode of an accelerator service is not a
clean Python exception but an environmental one: a device drops for
hours, calls hang, the process dies mid-append.  Those faults are
impossible to reproduce on demand, so the resilience layer is validated against *injected* ones:
a seed-driven :class:`FaultPlan` arms hooks at well-known sites in the
engine/ledger/device-guard, and each hook fires a configured exception
at exactly the chosen batch indices — same plan, same seed, same run,
every time.

Hook sites (``site`` field of a spec):

``batch_run``
    fired by the engine just before/around executing one batch
    (context: ``step``, ``batch``) — simulates device loss or an IO
    flake inside ``run_batch``.
``persist``
    fired inside the pipelined executor's persist worker just before
    ``persist_batch`` (context: ``step``, ``batch``) — simulates a
    fault landing *after* the device work finished but before the
    batch's outputs are durably written.  Unlike ``batch_run`` plans,
    a plan holding only ``persist``-site specs does NOT force the
    engine onto the sequential path: the fault's whole point is to
    land inside the real pipelined persist phase.
``ledger_append``
    fired inside :meth:`RunLedger.append` (context: ``step``,
    ``event``) — writes a *truncated* half line first, simulating a
    crash mid-append, then raises a ``fatal`` :class:`FaultInjected`.
``device_probe``
    fired inside the device health probe — ``kind="hang"`` sleeps
    past the probe deadline (a lost device hangs, it doesn't error).
    The port has no device health probe, so nothing fires this site.
``enqueue``
    fired inside :func:`tmlibrary_tpu_torch.serve.enqueue_job` before the
    spec hits the spool (context: ``step`` = tenant, ``event`` = job
    id) — simulates a failing/flooding submission path.
``admission``
    fired inside the serve daemon's spool scan, per offered job
    (context: ``step`` = tenant, ``event`` = job id).  ``hang`` wedges
    the admission loop (the admission-phase watchdog fires); any
    non-fatal raising kind converts to a pinned ``admission_fault``
    rejection — chaos can flood or wedge the queue but never crash
    the daemon.  Neither site forces the sequential engine path.
``claim``
    fired between winning the fleet spool's ``incoming/ → admitted/``
    claim rename and durably writing the lease file (context: ``step``
    = tenant, ``event`` = job id) — the exact torn-claim window the
    reaper's orphan pass must cover.  Non-fatal kinds leave the
    admitted spec claim-less for the reaper; ``kill`` is a host dying
    mid-claim.
``lease_renew``
    fired inside the serve daemon's lease-renewal pass (context:
    ``step`` = host id).  ``hang`` is the canonical GC-pause
    simulation: renewal wedges past the lease deadline, peers reclaim,
    and the owner's next terminal transition gets fenced.
``reclaim``
    fired inside the reaper, once per job about to be swept back to
    ``incoming/`` (context: ``step`` = tenant, ``event`` = job id) —
    non-fatal kinds defer the sweep to the next pass, ``kill`` is a
    reaper dying mid-reclaim (torn state the claim arbiter and the
    live-claim duplicate check must absorb).
``done_rename``
    fired just before a job's fenced terminal ``done``/``failed``/
    ``expired`` transition (context: ``step`` = tenant, ``event`` =
    job id).  ``hang`` sleeps past the lease so the epoch fence
    rejects the transition (``stale_claim``); ``kill`` is a host dying
    with the result computed but unpublished.
    None of these fleet sites forces the sequential engine path.

Two kinds are special.  ``kill`` hard-exits the process
(``os._exit(41)``) instead of raising — no exception propagation, no
cleanup — simulating a preempted/OOM-killed worker host; only
meaningful in subprocess harnesses (``tests/test_multihost_resume.py``,
``tests/test_preemption.py``) where a parent process observes the
death and re-launches with ``resume``.  ``sigterm`` delivers a real
``SIGTERM`` to the current process and *returns without raising*: with
the CLI's drain handler installed that models a preemption notice
arriving mid-step (the run keeps executing until the engine reaches
its next drain point), and without a handler it is process death at
the default disposition — both are exactly what a preempting scheduler
does.

Activation: programmatic ``install(plan)`` / ``clear()`` (tests,
``scripts/chaos_run.py``) or the ``TMX_FAULT_PLAN`` environment
variable holding inline JSON or a path to a JSON file.  With no plan
installed every hook is a no-op costing one global read.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import time
from pathlib import Path

from tmlibrary_tpu_torch.errors import FaultInjected, TransientDeviceError

logger = logging.getLogger(__name__)

#: exception factories per fault kind
_KINDS = ("device_loss", "io_error", "crash", "crash_append", "hang", "kill",
          "sigterm")

#: sites whose faults must land *before* a batch persists to mean
#: anything — a plan containing any of these forces the engine onto the
#: sequential path (DESIGN.md §11).  ``persist``-site faults (and the
#: probe hook) target the pipelined phases themselves and keep the real
#: executor running.
_SEQUENTIAL_SITES = frozenset({"batch_run", "ledger_append"})


@dataclasses.dataclass
class FaultSpec:
    """One armed fault.

    ``times`` bounds how often it fires (a spec with ``times`` larger
    than the retry budget defeats every retry in one run; ``times=1``
    lets the first retry succeed).  ``probability`` < 1 samples
    deterministically from the plan seed and the context, so a
    probabilistic plan still replays identically.
    """

    site: str
    kind: str = "device_loss"
    step: str | None = None
    batch: int | None = None
    event: str | None = None
    times: int = 1
    probability: float = 1.0
    seconds: float = 30.0
    fired: int = 0

    def matches(self, site: str, ctx: dict) -> bool:
        if site != self.site or self.fired >= self.times:
            return False
        if self.step is not None and ctx.get("step") != self.step:
            return False
        if self.batch is not None and ctx.get("batch") != self.batch:
            return False
        if self.event is not None and ctx.get("event") != self.event:
            return False
        return True


class FaultPlan:
    """An ordered set of :class:`FaultSpec` plus the seed that makes any
    probabilistic sampling reproducible."""

    def __init__(self, specs: list[FaultSpec], seed: int = 0):
        for s in specs:
            if s.kind not in _KINDS:
                raise ValueError(f"unknown fault kind '{s.kind}' "
                                 f"(known: {_KINDS})")
        self.specs = list(specs)
        self.seed = int(seed)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        specs = [
            FaultSpec(**{k: v for k, v in spec.items() if k != "fired"})
            for spec in d.get("faults", [])
        ]
        return cls(specs, seed=d.get("seed", 0))

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_dict(json.loads(text))

    def match(self, site: str, **ctx) -> FaultSpec | None:
        for spec in self.specs:
            if not spec.matches(site, ctx):
                continue
            if spec.probability < 1.0:
                # hash-seeded draw: independent of call order, identical
                # across replays of the same plan
                key = (self.seed, site, ctx.get("step"), ctx.get("batch"),
                       ctx.get("event"), spec.fired)
                if random.Random(repr(key)).random() >= spec.probability:
                    continue
            spec.fired += 1
            return spec
        return None

    def fire_counts(self) -> dict[str, int]:
        return {f"{s.site}/{s.kind}": s.fired for s in self.specs}

    def forces_sequential(self) -> bool:
        """True when any spec targets a site whose faults only make
        sense before a batch persists (the engine then degrades to the
        sequential path for the whole run — see ``_SEQUENTIAL_SITES``)."""
        return any(s.site in _SEQUENTIAL_SITES for s in self.specs)


_PLAN: FaultPlan | None = None
_ENV_CHECKED = False


def install(plan: FaultPlan) -> FaultPlan:
    """Install a plan for this process (tests / chaos harness)."""
    global _PLAN
    _PLAN = plan
    return plan


def clear() -> None:
    global _PLAN, _ENV_CHECKED
    _PLAN = None
    _ENV_CHECKED = True  # an explicit clear() also disarms TMX_FAULT_PLAN


def active() -> FaultPlan | None:
    """The installed plan, lazily loading ``TMX_FAULT_PLAN`` once."""
    global _PLAN, _ENV_CHECKED
    if _PLAN is None and not _ENV_CHECKED:
        _ENV_CHECKED = True
        raw = os.environ.get("TMX_FAULT_PLAN")
        if raw:
            text = raw
            if not raw.lstrip().startswith("{"):
                text = Path(raw).read_text()
            _PLAN = FaultPlan.from_json(text)
            logger.warning("fault injection ARMED from TMX_FAULT_PLAN "
                           "(%d specs, seed %d)", len(_PLAN.specs), _PLAN.seed)
    return _PLAN


def raise_for(spec: FaultSpec, site: str, ctx: dict) -> None:
    """Raise (or hang) per the spec's kind."""
    where = f"{site} step={ctx.get('step')} batch={ctx.get('batch')}"
    logger.warning("fault injection firing: %s at %s (%d/%d)",
                   spec.kind, where, spec.fired, spec.times)
    if spec.kind == "kill":
        # hard host death: no exception to catch, no finally blocks, no
        # atexit — exactly what a preempted machine looks like to the
        # surviving run ledger.  41 marks an injected (not organic) death.
        logger.warning("fault injection: hard-killing process at %s", where)
        logging.shutdown()
        os._exit(41)
    if spec.kind == "sigterm":
        # a real preemption notice: the signal lands on the main thread
        # at its next bytecode boundary and this call RETURNS — the
        # drain handler (resilience.install_preemption_handlers) decides
        # what happens next, exactly as with an external scheduler
        import signal as _signal

        logger.warning("fault injection: delivering SIGTERM at %s", where)
        os.kill(os.getpid(), _signal.SIGTERM)
        return
    if spec.kind == "hang":
        time.sleep(spec.seconds)
        raise TransientDeviceError(f"injected hang ({spec.seconds}s) at {where}")
    if spec.kind == "device_loss":
        raise TransientDeviceError(f"injected device loss at {where}")
    if spec.kind == "io_error":
        raise OSError(f"injected IO error at {where}")
    if spec.kind == "crash_append":
        raise FaultInjected(f"injected crash mid-append at {where}",
                            kind=spec.kind, transient=False, fatal=True)
    # "crash": a permanent, non-fatal application error (bad data)
    raise FaultInjected(f"injected permanent fault at {where}",
                        kind=spec.kind, transient=False)


def maybe_fire(site: str, **ctx) -> None:
    """Hook entry point: no-op unless an armed spec matches."""
    plan = active()
    if plan is None:
        return
    spec = plan.match(site, **ctx)
    if spec is not None:
        raise_for(spec, site, ctx)


def match(site: str, **ctx) -> FaultSpec | None:
    """Match without raising — for hooks that need custom behavior
    (the ledger's truncated-write simulation)."""
    plan = active()
    return plan.match(site, **ctx) if plan is not None else None


def sequential_forced() -> bool:
    """True when an armed plan requires the engine's sequential path
    (see :data:`_SEQUENTIAL_SITES`); no plan, or a plan targeting only
    pipelined-phase sites, leaves the pipelined executor in play."""
    plan = active()
    return plan is not None and plan.forces_sequential()
