"""``tmx-torch serve`` — the always-on analysis service on the card.

Counterpart: ``tmlibrary_tpu/serve.py`` (the port keeps its own copy):
the same spool layout, ledgers, events and decisions as ``tmx serve``,
so either package's ``serve status``, ``slo`` and ``metrics --source
ledger`` read the other's serve root.  Where the port differs:

- **The card.**  :class:`ServeDaemon` takes ``device`` (``"cuda"`` unless
  the caller asks for ``"cpu"``) and runs every workflow job's
  :class:`~tmlibrary_tpu_torch.workflow.engine.Workflow` and every query
  job on it; a missing card fails the job with ``DeviceError``, it never
  runs on the CPU instead.
- **Warm programs.**  The port compiles nothing per program: "warm"
  means a program already ran in this process
  (:mod:`~tmlibrary_tpu_torch.aotstore`), and the shared store the
  fleet imports from holds the built kernel libraries, so a host that
  can import one claims a cold-key job (a warm-start claim) instead of
  deferring it.  JAX's persistent compilation cache has no counterpart.
- **No swallowed telemetry.**  The SLO check, the anomaly check, the
  time series flush and the metrics snapshot raise on failure instead
  of logging at debug level.

A long-lived daemon that accepts a continuous stream of workflow jobs
across many concurrent experiments.  Jobs are JSON specs dropped into a
**spool directory** (``tmx-torch enqueue`` writes them atomically), so no
network stack is needed and the whole submission path inherits the
crash-consistency story of ``atomicio`` + the CRC-sealed run ledger.

Spool lifecycle (every transition is an atomic write or same-fs rename)::

    spool/incoming/<job>.json      tmx enqueue drops specs here
        │  admission (bounded queue, quotas, WDRR, retry budgets,
        │             per-tenant breakers — workflow/admission.py)
        ├── admitted  → spool/admitted/<job>.json  + job_admitted event
        └── rejected  → spool/rejected/<job>.json  + job_rejected event
                        (decision envelope with the pinned retry_after_s)
    spool/admitted/<job>.json      queued or running
        ├── success   → spool/done/<job>.json      + job_done event
        ├── failure   → spool/failed/<job>.json    + job_failed event
        ├── deadline  → spool/expired/<job>.json   + job_expired event
        └── SIGTERM   → back to spool/incoming/    + job_requeued event

Execution reuses the whole engine stack: each job is one
:class:`~tmlibrary_tpu_torch.workflow.engine.Workflow` run against its own
experiment store (``resume=True`` whenever the job's ledger already
exists, so re-admitted work converges bit-identically).  Jobs that route
to the same pipeline share the process's pipeline cache and its built
kernel library; keeping the daemon resident is what makes that reuse
possible.

Per-job deadlines ride the engine's cooperative-stop hooks: the
composite ``should_stop`` trips at the next batch boundary, the
pipelined executor drains its in-flight window, and the job lands in
``spool/expired/`` — partial results persisted, nothing corrupted.

Preemption (SIGTERM/SIGINT) is routine: the current job drains through
the engine's drain (its own ``run_preempted`` ledger event), every
admitted-but-unfinished job is re-spooled to ``incoming/``, a
``serve_preempted`` event seals the serve ledger, and the daemon exits
:data:`~tmlibrary_tpu_torch.resilience.EXIT_PREEMPTED` (75) for its wrapper
to restart.  A hard kill is equally safe: startup recovery re-spools
whatever was left in ``admitted/`` — scoped to jobs whose claim is
absent or provably expired, so a restarting host never steals a live
peer's work.

**Fleet spool protocol** (DESIGN.md §25): several daemons may share one
spool.  Pickup is an atomic *claim*: the host that wins the
``incoming/ → admitted/`` rename (``atomicio.claim_rename``) owns the
job and records a lease — ``admitted/<job>.claim.<host_id>`` with a
deadline renewed on the heartbeat cadence by a background
:class:`~tmlibrary_tpu_torch.resilience.LeaseRenewer`.  Every claim stamps a
monotonically increasing ``claim_epoch`` into the job spec; the owner
re-checks its claim (file present, epoch matching) before every
``done``/``failed``/``expired`` transition, so a stale host resuming
after a GC pause gets a pinned ``stale_claim`` ledger event instead of
clobbering a reclaimed job's result.  A **reaper** in the poll loop
detects dead peers (lease deadline passed AND the per-host
``heartbeat.<host>.json`` stale) and sweeps their claimed jobs back to
``incoming/`` with attempt counts preserved — daemon death never
charges tenant retry budgets — emitting ``job_reclaimed`` events that
``registry_from_ledger`` replays.  Each fleet host seals its own
``serve/ledger.<host>.jsonl``; status/SLO/replay consumers merge them
(:func:`serve_ledger_events`), keeping admission/WDRR/shed decisions
pure functions of the merged per-host ledger history.

**Affinity routing**: jobs carry a compiled-program affinity key
(:func:`affinity_key_for` — a content digest over the workflow
description + jterator pipeline files, i.e. the inputs of
``program_digest_extras``'s compile key).  A host greedily claims jobs
whose key is warm in its process-level AOT/compile caches first, and
defers cold-key jobs to affine peers — bounded: once a job has waited
one lease period, any host claims it.

Fault-injection sites: ``enqueue`` (fires inside :func:`enqueue_job`),
``admission`` (inside the daemon's scan loop, ``step`` = the tenant,
``event`` = the job id), ``claim`` (between winning the claim rename
and durably writing the claim file — the window recovery/reaping must
cover), ``lease_renew`` (inside the renewal pass; a hang here is the
GC-pause simulation), ``reclaim`` (inside the reaper, per reclaimed
job) and ``done_rename`` (just before the fenced terminal transition).
An injected admission fault converts to a ``admission_fault`` rejection
— overload or chaos must never crash the daemon.  The admission loop is
armed by the phase watchdog (``admission`` phase) when the watchdog
master switch is on.
"""

from __future__ import annotations

import functools
import hashlib
import logging
import sys
import threading
import time
from contextlib import nullcontext
from pathlib import Path

from tmlibrary_tpu_torch import aotstore, canary, faults, slo, telemetry, timeseries
from tmlibrary_tpu_torch.atomicio import atomic_write_json, claim_rename
from tmlibrary_tpu_torch.errors import FaultInjected, PreemptedError
from tmlibrary_tpu_torch.resilience import (
    EXIT_PREEMPTED,
    LeaseRenewer,
    PhaseWatchdog,
    install_preemption_handlers,
    preemption_reason,
    preemption_requested,
    watchdog_enabled,
)
from tmlibrary_tpu_torch.workflow.admission import (
    REASON_DUPLICATE,
    REASON_FAULT,
    REASON_INVALID,
    SHED_REASONS,
    AdmissionConfig,
    AdmissionDecision,
    AdmissionQueue,
    JobSpec,
    reject,
)

logger = logging.getLogger(__name__)

#: spool subdirectories, in lifecycle order
SPOOL_STATES = ("incoming", "admitted", "done", "failed", "rejected",
                "expired")

#: a scan pass shedding at least this many jobs is a "shed storm" — one
#: of the flight-recorder dump triggers (latched: one dump per storm,
#: re-armed by a clean pass)
SHED_STORM_N = 3

#: throttle for the daemon's periodic SLO burn evaluation (seconds)
SLO_CHECK_PERIOD_S = 5.0


# ------------------------------------------------------------------ paths
def spool_dir(serve_root: Path, state: str = "incoming") -> Path:
    return Path(serve_root) / "spool" / state


def serve_dir(serve_root: Path) -> Path:
    return Path(serve_root) / "serve"


def ledger_path(serve_root: Path, host: str | None = None) -> Path:
    """One fleet host's serve ledger: the legacy single-host name for
    ``host0``/no-host (so existing consumers keep working), a per-host
    ``ledger.<host>.jsonl`` for every other fleet member — same naming
    convention as :func:`telemetry.heartbeat_path`."""
    if host in (None, "host0"):
        return serve_dir(serve_root) / "ledger.jsonl"
    return serve_dir(serve_root) / f"ledger.{host}.jsonl"


def serve_ledger_paths(serve_root: Path) -> list[Path]:
    """Every per-host serve ledger under the root, sorted by name."""
    return sorted(serve_dir(serve_root).glob("ledger*.jsonl"))


def serve_ledger_events(serve_root: Path) -> list[dict]:
    """The merged per-host serve ledger history, ordered by timestamp
    (stable within a host's ledger).  This is THE fleet read path:
    status, SLO burn, replay and the exactly-once chaos proofs all
    consume this merge, so admission/shed decisions stay pure functions
    of one well-defined event history regardless of how many hosts
    wrote it."""
    from tmlibrary_tpu_torch.workflow.engine import RunLedger

    events: list[dict] = []
    for lp in serve_ledger_paths(serve_root):
        events.extend(RunLedger(lp).events())
    events.sort(key=lambda ev: float(ev.get("ts", 0.0) or 0.0))
    return events


def heartbeat_file(serve_root: Path, host: str | None = None) -> Path:
    """One fleet host's serve heartbeat (legacy name for host0/no-host,
    ``heartbeat.<host>.json`` otherwise)."""
    if host in (None, "host0"):
        return serve_dir(serve_root) / "heartbeat.json"
    return serve_dir(serve_root) / f"heartbeat.{host}.json"


def status_file(serve_root: Path) -> Path:
    return serve_dir(serve_root) / "status.json"


def aot_store_path(serve_root: Path) -> Path:
    """The fleet-shared store of this spool: the daemon points the
    kernel-library store (:mod:`aotstore`) here, so a host that joins the
    fleet imports the libraries a peer built (the reference stores its
    serialized executables here)."""
    return Path(serve_root) / "aotstore"


def claim_path(serve_root: Path, job_id: str, host: str) -> Path:
    """The lease file recording ``host``'s claim on an admitted job."""
    return spool_dir(serve_root, "admitted") / f"{job_id}.claim.{host}"


def job_claims(serve_root: Path,
               job_id: str | None = None) -> list[tuple[Path, str, str]]:
    """All claim files in the spool as ``(path, job_id, host)``, sorted;
    optionally filtered to one job."""
    out: list[tuple[Path, str, str]] = []
    pattern = f"{job_id}.claim.*" if job_id else "*.claim.*"
    for p in sorted(spool_dir(serve_root, "admitted").glob(pattern)):
        jid, _, host = p.name.rpartition(".claim.")
        if jid and host:
            out.append((p, jid, host))
    return out


def read_claim(path: Path) -> dict | None:
    import json

    try:
        claim = json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return None
    return claim if isinstance(claim, dict) else None


def ensure_layout(serve_root: Path) -> None:
    for state in SPOOL_STATES:
        spool_dir(serve_root, state).mkdir(parents=True, exist_ok=True)
    serve_dir(serve_root).mkdir(parents=True, exist_ok=True)


def is_serve_root(root: Path) -> bool:
    """Whether ``root`` looks like a serve root (spool layout present)."""
    root = Path(root)
    return (root / "spool").is_dir() or ledger_path(root).exists()


def affinity_key_for(root: str | Path,
                     description: str | None = None) -> str | None:
    """Best-effort compiled-program affinity key for a workflow job.

    A content digest over the inputs that determine which compiled
    program family the job routes to: the workflow description YAML plus
    every jterator pipeline description (``*.pipe.yaml``) under the
    experiment root, the reference's digest for the same files, read
    without building anything at enqueue time.  A proxy on purpose: two jobs with
    identical keys share their pipeline content (a warm-cache hit is
    real); distinct keys for identical programs merely cost an affinity
    miss, never correctness.  Returns None when nothing is readable —
    affinity is a routing hint, not a requirement."""
    try:
        root = Path(root)
        desc = Path(description) if description else (
            root / "workflow" / "workflow.yaml")
        if not desc.is_absolute():
            desc = root / desc
        h = hashlib.sha1()
        h.update(desc.read_bytes())
        # bounded: pipeline descriptions are small and few; a runaway
        # directory must not turn enqueue into a crawl
        for i, p in enumerate(sorted(root.rglob("*.pipe.yaml"))):
            if i >= 64:
                break
            h.update(p.name.encode())
            h.update(p.read_bytes())
        return h.hexdigest()[:16]
    except Exception:
        return None


# ---------------------------------------------------------------- enqueue
def enqueue_job(serve_root: Path, spec: JobSpec) -> Path:
    """Drop one job spec into the spool (the ``tmx-torch enqueue`` backend).

    Atomic write keeps the daemon from ever observing half a spec.  The
    ``enqueue`` fault site fires here so chaos plans can flood or break
    the submission path without touching the daemon."""
    ensure_layout(serve_root)
    if not spec.submitted_at:
        spec.submitted_at = time.time()
    if spec.affinity_key is None and spec.kind == "workflow":
        spec.affinity_key = affinity_key_for(spec.root, spec.description)
    faults.maybe_fire("enqueue", step=spec.tenant, event=spec.job_id)
    path = spool_dir(serve_root, "incoming") / f"{spec.job_id}.json"
    atomic_write_json(path, spec.to_dict())
    return path


# ----------------------------------------------------------------- daemon
class ServeDaemon:
    """The admission + execution loop behind ``tmx serve run``."""

    def __init__(self, serve_root: Path,
                 admission: AdmissionConfig | None = None,
                 poll_s: float | None = None,
                 max_jobs: int = 0, idle_exit_s: float = 0.0,
                 install_handlers: bool = True,
                 host: str | None = None, lease_s: float | None = None,
                 canary_period_s: float | None = None,
                 anomaly_check_s: float | None = None,
                 device: str = "cuda"):
        from tmlibrary_tpu_torch.config import cfg
        from tmlibrary_tpu_torch.workflow.engine import RunLedger

        #: where every job runs; never changed to the CPU behind the
        #: caller's back
        self.device = device
        self.serve_root = Path(serve_root)
        ensure_layout(self.serve_root)
        self.queue = AdmissionQueue(
            admission or AdmissionConfig.from_library_config()
        )
        self.poll_s = float(cfg.serve_poll_s if poll_s is None else poll_s)
        self.max_jobs = int(max_jobs)
        self.idle_exit_s = float(idle_exit_s)
        self.install_handlers = bool(install_handlers)
        #: this daemon's fleet identity: the explicit ``host`` parameter
        #: (in-process multi-daemon tests), else the process identity
        #: when a fleet is active, else None — single-host daemons keep
        #: the seed-era ledger/heartbeat names and host-less events
        self.host: str | None = host or (
            telemetry.host_id() if telemetry.fleet_active() else None
        )
        #: the name stamped into claim files (claims always name an
        #: owner, even single-host ones — the protocol is uniform)
        self.host_name: str = self.host or "host0"
        self.lease_s = float(cfg.serve_lease_s if lease_s is None
                             else lease_s)
        self.ledger = RunLedger(
            ledger_path(self.serve_root, self.host), fsync=cfg.ledger_fsync,
            host=self.host,
        )
        #: job_id → claim epoch for every lease this daemon holds; the
        #: lock covers the renewal thread reading while the main loop
        #: claims/releases
        self._claims: dict[str, int] = {}
        self._claims_lock = threading.Lock()
        self._renewer: LeaseRenewer | None = None
        #: affinity keys whose compiled programs this process has
        #: (likely) warmed — fed by completed executions, consulted by
        #: the claim loop's greedy preference
        self._warm_keys: set[str] = set()
        #: job_id → first time this daemon saw (and deferred) a cold-key
        #: job, the staleness bound's fallback clock when a spec carries
        #: no submitted_at
        self._deferred_seen: dict[str, float] = {}
        #: admission-phase watchdog — a wedged scan (hung filesystem,
        #: injected hang) fires telemetry + the breaker path instead of
        #: stalling silently
        self._watchdog: PhaseWatchdog | None = None
        if watchdog_enabled() and float(cfg.serve_admission_deadline_s) > 0:
            self._watchdog = PhaseWatchdog(
                {"admission": float(cfg.serve_admission_deadline_s)}
            )
        self._jobs_run = 0
        #: job_id → admission wall time, for the WDRR scheduling-delay
        #: span (admit → execute start)
        self._admit_ts: dict[str, float] = {}
        #: multi-query fusion (cfg.serve_query_fusion): leader job_id →
        #: follower JobSpecs pulled from the queue to ride its sweep,
        #: and follower job_id → its precomputed summary.  Every
        #: follower still runs its own full job lifecycle — only the
        #: device work is shared.
        self._fusion_peers: dict[str, list[JobSpec]] = {}
        self._fusion_results: dict[str, dict] = {}
        #: (tenant, window) pairs already warned this burn episode —
        #: slo_burn is warn-only AND latched, so a sustained breach is
        #: one ledger event, not one per loop iteration
        self._slo_latched: set[tuple[str, str]] = set()
        self._shed_latch = False
        self._last_slo_check = 0.0
        #: synthetic canary probes (canary.py): self-addressed
        #: ``kind="canary"`` jobs enqueued every ``canary_period_s``
        #: seconds (0 = off), riding the normal spool lifecycle but
        #: bypassing the admission queue — invisible to tenant quota,
        #: WDRR, retry budgets and the per-tenant SLO
        self.canary_period_s = float(
            cfg.serve_canary_period_s if canary_period_s is None
            else canary_period_s)
        self.anomaly_check_s = float(
            cfg.serve_anomaly_check_s if anomaly_check_s is None
            else anomaly_check_s)
        self._canary_seq = 0
        self._canary_inflight: str | None = None
        self._canary_started = 0.0
        self._last_canary = 0.0
        self._canary_ready: list[JobSpec] = []
        #: anomaly fingerprints already written to the ledger this
        #: process — the latch mirroring ``_slo_latched``: the detector
        #: (a pure function of the event window) returns the full
        #: historical sequence, the daemon appends only the new tail
        self._anomaly_emitted: set[tuple] = set()
        self._last_anomaly_check = 0.0
        self._tsdb_flush_s = float(cfg.tsdb_flush_s)
        self._last_tsdb_flush = 0.0
        #: the reference's fleet-shared executable store sits under the
        #: serve root; the port's is always empty (see the module notes)
        aotstore.set_process_default_dir(str(aot_store_path(self.serve_root)))
        #: throttled store-stats cache for _publish_state/_should_defer —
        #: (monotonic_ts, stats dict); listing the store every poll-loop
        #: iteration would hammer the shared filesystem
        self._store_stats_cache: tuple[float, dict] | None = None

    # ------------------------------------------------------------ helpers
    def _arm(self, phase: str):
        if self._watchdog is None:
            return nullcontext()
        return self._watchdog.arm(phase, step="serve")

    def _metric(self, kind: str, name: str, value: float = 1.0, **labels):
        if self.host is not None:
            # fleet mode: live series carry the host label, exactly as
            # registry_from_ledger derives them from host-stamped events
            labels.setdefault("host", self.host)
        reg = telemetry.get_registry()
        if kind == "counter":
            reg.counter(name, **labels).inc(value)
        elif kind == "gauge":
            reg.gauge(name, **labels).set(value)
        else:
            reg.histogram(name, **labels).observe(value)

    def _move_spool(self, job_id: str, dst_state: str,
                    envelope: dict) -> None:
        """Land ``job_id``'s spool file in ``dst_state`` with an
        envelope payload, removing it from every transient state (the
        job's claim files included — a terminal transition ends the
        lease; any *foreign* claim file still present is stale by the
        epoch monotonicity invariant, since we verified ours first)."""
        atomic_write_json(
            spool_dir(self.serve_root, dst_state) / f"{job_id}.json",
            envelope,
        )
        for state in ("incoming", "admitted"):
            f = spool_dir(self.serve_root, state) / f"{job_id}.json"
            if f.exists() and state != dst_state:
                f.unlink()
        for p, _, _ in job_claims(self.serve_root, job_id):
            p.unlink(missing_ok=True)

    # ------------------------------------------------------------- leases
    def _write_claim(self, job_id: str, epoch: int) -> None:
        now = time.time()
        atomic_write_json(
            claim_path(self.serve_root, job_id, self.host_name), {
                "job": job_id, "host": self.host_name, "epoch": int(epoch),
                "claimed_at": round(now, 6), "lease_s": self.lease_s,
                "lease_deadline": round(now + self.lease_s, 6),
            },
        )

    def _renew_leases(self) -> None:
        """One renewal pass: refresh every held claim's lease deadline
        plus this host's heartbeat.  Runs on the LeaseRenewer thread
        while the main loop executes jobs — only ``atomicio`` writes,
        never the ledger (thread discipline).  The ``lease_renew``
        fault site fires here: a hang wedges renewal past the lease,
        which is exactly what a long GC pause looks like to peers."""
        faults.maybe_fire("lease_renew", step=self.host_name)
        with self._claims_lock:
            held = dict(self._claims)
        for job_id, epoch in held.items():
            self._write_claim(job_id, epoch)
        self._write_serve_heartbeat(queue_depth=None)

    def _verify_claim(self, job: JobSpec) -> bool:
        """The fencing check before every terminal transition: do we
        still hold this job's lease at the epoch we claimed it?  A
        reaper that reclaimed the job removed our claim file first, so
        a stale owner fails here — file gone, or epoch superseded."""
        with self._claims_lock:
            epoch = self._claims.get(job.job_id)
        if epoch is None:
            return False
        claim = read_claim(
            claim_path(self.serve_root, job.job_id, self.host_name))
        return (claim is not None
                and claim.get("host") == self.host_name
                and int(claim.get("epoch", -1)) == int(epoch))

    def _fence(self, job: JobSpec, outcome: str) -> bool:
        """The gate in front of every terminal spool transition.  Fires
        the ``done_rename`` fault site (a hang here IS the GC-pause
        scenario the protocol exists for: sleep past the lease, wake,
        and find the job reclaimed), then verifies the lease.  False
        means the transition must be dropped (``stale_claim`` sealed).

        A residual window remains between this check and the rename —
        DESIGN.md §25 documents why it is safe: a reaper re-runs the job
        from the experiment ledger's resume path, so even a transition
        that slips through converges to the same bytes."""
        try:
            faults.maybe_fire("done_rename", step=job.tenant,
                              event=job.job_id)
        except FaultInjected as exc:
            if exc.fatal:
                raise
        except Exception:
            pass  # a hang's post-sleep error: the pause already happened
        if self._verify_claim(job):
            return True
        self._stale_claim(job, outcome)
        return False

    def _stale_claim(self, job: JobSpec, outcome: str) -> None:
        """Fenced: our lease was reclaimed while we ran.  Pinned
        ``stale_claim`` event, drop the result, touch neither spool nor
        queue accounting — the job belongs to its new owner now, and a
        daemon death (or pause) must never charge the tenant."""
        with self._claims_lock:
            epoch = self._claims.pop(job.job_id, None)
        logger.warning(
            "stale claim: job %s (epoch %s) was reclaimed while this "
            "host ran it — dropping the %s transition",
            job.job_id, epoch, outcome,
        )
        self.ledger.append(event="stale_claim", job=job.job_id,
                           tenant=job.tenant, epoch=epoch,
                           outcome=outcome)
        self._metric("counter", "tmx_serve_stale_claims_total",
                     tenant=job.tenant)

    def _release_claim(self, job_id: str) -> None:
        with self._claims_lock:
            self._claims.pop(job_id, None)
        claim_path(self.serve_root, job_id,
                   self.host_name).unlink(missing_ok=True)

    def _write_serve_heartbeat(self, queue_depth: int | None) -> None:
        extra = {"role": "serve", "host": self.host_name,
                 "lease_s": self.lease_s}
        if queue_depth is not None:
            extra["queue_depth"] = queue_depth
        telemetry.write_heartbeat(
            heartbeat_file(self.serve_root, self.host),
            period=self.poll_s, extra=extra,
        )

    def _store_stats(self, max_age_s: float = 10.0) -> dict:
        """Throttled :func:`aotstore.store_stats` for the shared store —
        the poll loop and the deferral decision both consult it, and a
        directory listing per loop iteration would hammer the shared
        filesystem a fleet mounts it on."""
        now = time.monotonic()
        if (self._store_stats_cache is not None
                and now - self._store_stats_cache[0] < max_age_s):
            return self._store_stats_cache[1]
        stats = aotstore.store_stats()
        self._store_stats_cache = (now, stats)
        return stats

    def _publish_state(self) -> None:
        """Heartbeat + live status/queue gauges, every loop iteration."""
        snap = self.queue.snapshot()
        self._write_serve_heartbeat(queue_depth=snap["depth"])
        # fleet warm-start: publish this host's warm digests + the shared
        # store's shape next to the queue snapshot, so `tmx-torch serve status`
        # and peers can see who is warm without touching the registry
        store = self._store_stats()
        warm = {
            "store_entries": int(store.get("entries", 0)),
            "store_bytes": int(store.get("total_bytes", 0)),
            "store_enabled": bool(store.get("enabled", False)),
            "warm_keys": len(self._warm_keys),
            "warm_digests": list(aotstore.warm_digests(limit=8)),
            "seconds_saved": round(aotstore.seconds_saved(), 3),
        }
        atomic_write_json(status_file(self.serve_root), {
            "ts": time.time(), "jobs_run": self._jobs_run,
            "host": self.host_name, "warm": warm, **snap,
        })
        self._metric("gauge", "tmx_serve_queue_depth", snap["depth"])
        self._metric("gauge", "tmx_aot_store_entries", warm["store_entries"])
        self._metric("gauge", "tmx_aot_store_bytes", warm["store_bytes"])
        age = snap.get("oldest_job_age_s")
        if age is not None:
            self._metric("gauge", "tmx_serve_oldest_job_age_seconds", age)

    def _check_slo(self) -> None:
        """Periodic warn-only burn evaluation (throttled): replay the
        serve ledger's completion events through :mod:`slo` and append a
        latched ``slo_burn`` event per newly-breached (tenant, window).
        Same contract as QC: the service reports its own SLO, it never
        aborts or sheds because of it."""
        now = time.monotonic()
        if now - self._last_slo_check < SLO_CHECK_PERIOD_S:
            return
        self._last_slo_check = now
        # merged per-host history: one fleet-wide SLO truth no matter
        # which host evaluates it
        view = slo.report(serve_ledger_events(self.serve_root), now=time.time())
        burning: set[tuple[str, str]] = set()
        for b in slo.breaches(view):
            key = (b["tenant"], b["window"])
            burning.add(key)
            if key in self._slo_latched:
                continue
            self._slo_latched.add(key)
            self.ledger.append(event="slo_burn", tenant=b["tenant"],
                               window=b["window"], burn=b["burn"])
            self._metric("counter", "tmx_slo_burn_total",
                         tenant=b["tenant"], window=str(b["window"]))
            logger.warning(
                "SLO burn for tenant %s over window %ss: burn %s "
                "(warn-only — inspect with `tmx-torch slo`)",
                b["tenant"], b["window"], b["burn"],
            )
        # a (tenant, window) that stopped burning re-arms its latch
        self._slo_latched &= burning

    def _check_anomalies(self) -> None:
        """Periodic warn-only anomaly evaluation (throttled): run the
        pure EWMA/z-score detector (:func:`canary.anomaly_report`) over
        the merged serve ledger and append the anomalies it found that
        this daemon has not yet written — latched, one event per
        excursion.  Because the detector is a pure function of the event
        window, replaying the final ledger reproduces this exact event
        sequence (the pinned parity contract).  Each host reports only
        its own streams, so a fleet emits every anomaly exactly once."""
        now = time.monotonic()
        if now - self._last_anomaly_check < self.anomaly_check_s:
            return
        self._last_anomaly_check = now
        events = [ev for ev in serve_ledger_events(self.serve_root)
                  if ev.get("event") != "anomaly"]
        for rec in canary.anomaly_report(events):
            if rec["host"] != self.host_name:
                continue
            fp = (rec["metric"], rec["host"], rec["seq"])
            if fp in self._anomaly_emitted:
                continue
            self._anomaly_emitted.add(fp)
            self.ledger.append(
                event="anomaly", metric=rec["metric"],
                stream_host=rec["host"], seq=rec["seq"],
                sample_ts=rec["ts"], value=rec["value"],
                ewma=rec["ewma"], zscore=rec["zscore"],
            )
            self._metric("counter", "tmx_anomalies_total",
                         metric=rec["metric"])
            logger.warning(
                "anomaly on %s (host %s): value %s vs ewma %s, "
                "z=%s (warn-only — inspect with `tmx-torch timeline`)",
                rec["metric"], rec["host"], rec["value"],
                rec["ewma"], rec["zscore"],
            )

    def _maybe_canary(self) -> None:
        """Enqueue the next self-addressed canary probe when the period
        has elapsed and the previous probe has finished (a wedged
        pipeline must not pile probes onto itself — one slow probe IS
        the signal).  A probe lost to a crash re-arms after a grace
        window."""
        if self.canary_period_s <= 0:
            return
        now = time.monotonic()
        if self._last_canary and now - self._last_canary < self.canary_period_s:
            return
        if self._canary_inflight is not None:
            grace = max(5 * self.canary_period_s, 30.0)
            if now - self._canary_started < grace:
                return
            self._canary_inflight = None  # lost probe — re-arm
        self._canary_seq += 1
        spec = canary.make_probe_spec(self.serve_root, self.host_name,
                                      self._canary_seq)
        try:
            enqueue_job(self.serve_root, spec)
        except FaultInjected as exc:
            if exc.fatal:
                raise
            logger.warning("canary enqueue fault: %s", exc)
            return
        except Exception as exc:
            logger.warning("canary enqueue failed: %s", exc)
            return
        self._canary_inflight = spec.job_id
        self._canary_started = now
        self._last_canary = now

    def _flush_timeseries(self, force: bool = False) -> None:
        """Land the live registry in this host's tsdb segment
        (timeseries.py) — throttled; one ``enabled()`` check when
        telemetry is off."""
        if not telemetry.enabled():
            return
        now = time.monotonic()
        if not force and now - self._last_tsdb_flush < self._tsdb_flush_s:
            return
        self._last_tsdb_flush = now
        timeseries.flush_registry(serve_dir(self.serve_root),
                                  host=self.host or "host0")

    def _write_metrics(self) -> None:
        if not telemetry.enabled():
            return
        name = ("metrics.json" if self.host in (None, "host0")
                else f"metrics.{self.host}.json")
        atomic_write_json(serve_dir(self.serve_root) / name,
                          telemetry.get_registry().snapshot())

    # ---------------------------------------------------------- admission
    def _recover_spool(self) -> int:
        """Re-spool jobs a previous daemon admitted but never finished
        (crash or preemption) back into ``incoming/`` — startup is the
        crash-consistent counterpart of the SIGTERM drain.

        Fleet-scoped: the sweep only takes jobs whose claim is *ours*
        (a previous incarnation of this host died holding the lease),
        absent (claim-less admitted specs are torn-claim or torn-reclaim
        residue), or provably expired.  A job under a live peer's lease
        is that peer's work — the seed-era unconditional sweep would
        steal it and run it twice."""
        recovered = 0
        now = time.time()
        claims_by_job: dict[str, list[tuple[Path, str]]] = {}
        for cpath, jid, owner in job_claims(self.serve_root):
            claims_by_job.setdefault(jid, []).append((cpath, owner))
        for f in sorted(spool_dir(self.serve_root, "admitted").glob("*.json")):
            live_peer = False
            for cpath, owner in claims_by_job.get(f.stem, []):
                if owner == self.host_name:
                    cpath.unlink(missing_ok=True)  # our own dead lease
                    continue
                claim = read_claim(cpath)
                if claim is not None and not self._claim_expired(claim, now):
                    live_peer = True
                else:
                    cpath.unlink(missing_ok=True)
            if live_peer:
                continue
            target = spool_dir(self.serve_root, "incoming") / f.name
            if target.exists():
                f.unlink()  # incoming copy already exists (torn drain)
            else:
                f.rename(target)
            recovered += 1
            self.ledger.append(event="job_requeued", job=f.stem,
                               phase="recovery")
        return recovered

    def _load_spec(self, path: Path) -> "JobSpec | None":
        import json

        try:
            return JobSpec.from_dict(json.loads(path.read_text()))
        except Exception as exc:
            logger.warning("invalid job spec %s: %s", path.name, exc)
            return None

    def _offer(self, spec: JobSpec) -> AdmissionDecision:
        """One admission decision, chaos-safe: the ``admission`` fault
        site fires first, and any injected (or organic) error becomes a
        pinned ``admission_fault`` rejection — never a crash.  Fatal
        injected crashes (simulated host death) do propagate, exactly
        like a kill."""
        try:
            faults.maybe_fire("admission", step=spec.tenant,
                              event=spec.job_id)
            return self.queue.offer(spec)
        except FaultInjected as exc:
            if exc.fatal:
                raise
            return reject(REASON_FAULT)
        except Exception as exc:
            logger.warning("admission fault for job %s: %s",
                           spec.job_id, exc)
            return reject(REASON_FAULT)

    def _claimed_elsewhere(self, job_id: str) -> bool:
        """Live-claim duplicate test for an incoming spec: an admitted
        copy only blocks re-submission while somebody actually holds its
        lease.  A claim-less or expired admitted copy is torn-claim or
        torn-reclaim residue — it must stay claimable, and the claim
        rename atomically replaces it."""
        with self._claims_lock:
            if job_id in self._claims:
                return True
        if not (spool_dir(self.serve_root, "admitted")
                / f"{job_id}.json").exists():
            return False
        now = time.time()
        for cpath, _, _ in job_claims(self.serve_root, job_id):
            claim = read_claim(cpath)
            if claim is not None and not self._claim_expired(claim, now):
                return True
        return False

    def _live_peers(self) -> list[str]:
        """Other fleet hosts with a fresh serve heartbeat on this root."""
        peers: list[str] = []
        for hb in serve_dir(self.serve_root).glob("heartbeat*.json"):
            data = telemetry.read_heartbeat(hb)
            if data is None:
                continue
            owner = str(data.get("host") or "host0")
            if owner == self.host_name:
                continue
            age = telemetry.heartbeat_age(hb)
            period = float(data.get("period", 0) or 0)
            if age is not None and age <= max(5.0, 4 * period):
                peers.append(owner)
        return peers

    def _should_defer(self, spec: JobSpec, now: float,
                      live_peers: list[str]) -> bool:
        """Affinity routing's cold-key deferral, staleness-bounded: skip
        a job whose compiled-program key is cold here while live peers
        exist (one of them is likelier to have it warm) — but never for
        longer than one lease period, after which any host claims it.
        A host with nothing warm yet has no basis for preference and
        claims everything.

        As in the reference, a live entry in the shared store (here a
        built kernel library the host can import) retires the deferral:
        the host becomes warm rather than waiting for one."""
        key = spec.affinity_key
        if key is None or not self._warm_keys or key in self._warm_keys:
            self._deferred_seen.pop(spec.job_id, None)
            return False
        if not live_peers:
            return False
        store = self._store_stats()
        if store.get("enabled") and int(store.get("entries", 0)) > int(
                store.get("stale_entries", 0) or 0):
            # at least one importable executable exists — become a warm
            # host rather than deferring to one
            self._deferred_seen.pop(spec.job_id, None)
            self._metric("counter", "tmx_serve_warmstart_claims_total")
            return False
        first = self._deferred_seen.setdefault(spec.job_id, now)
        waited = now - (float(spec.submitted_at)
                        if spec.submitted_at else first)
        if waited >= self.lease_s:
            self._deferred_seen.pop(spec.job_id, None)
            return False
        return True

    def _try_claim(self, path: Path, spec: JobSpec) -> bool:
        """Claim one incoming spec for this host: win the atomic
        ``incoming/ → admitted/`` rename, bump the claim epoch into the
        spec, and record the lease.  False means a peer won the race (or
        an injected claim fault left the job for the reaper's orphan
        pass).  The ``claim`` fault site fires in the exact window the
        protocol must cover: rename won, lease not yet durable."""
        admitted = (spool_dir(self.serve_root, "admitted")
                    / f"{spec.job_id}.json")
        if not claim_rename(path, admitted):
            return False
        epoch = int(spec.claim_epoch) + 1
        spec.claim_epoch = epoch
        try:
            faults.maybe_fire("claim", step=spec.tenant, event=spec.job_id)
            atomic_write_json(admitted, spec.to_dict())
            self._write_claim(spec.job_id, epoch)
        except FaultInjected as exc:
            if exc.fatal:
                raise
            logger.warning(
                "claim fault for job %s: leaving the admitted spec for "
                "the reaper's orphan pass (%s)", spec.job_id, exc)
            return False
        except Exception as exc:
            logger.warning("claim write failed for job %s: %s",
                           spec.job_id, exc)
            return False
        with self._claims_lock:
            self._claims[spec.job_id] = epoch
        self._deferred_seen.pop(spec.job_id, None)
        return True

    # -------------------------------------------------------------- reaper
    def _claim_expired(self, claim: dict, now: float) -> bool:
        """A lease is reclaimable only when *both* signals agree the
        owner is gone: the lease deadline has passed AND the owner's
        heartbeat is older than the lease (or absent).  A host that
        still heartbeats but wedged one renewal keeps its jobs."""
        deadline = float(claim.get("lease_deadline", 0) or 0)
        if now < deadline:
            return False
        owner = str(claim.get("host") or "host0")
        lease = float(claim.get("lease_s") or self.lease_s)
        age = telemetry.heartbeat_age(
            heartbeat_file(self.serve_root, owner))
        return age is None or age > lease

    def _reap_expired(self) -> int:
        """One reaper pass: sweep dead peers' expired leases (and
        claim-less orphaned admitted specs) back to ``incoming/``."""
        now = time.time()
        reclaimed = 0
        for cpath, jid, owner in job_claims(self.serve_root):
            if owner == self.host_name:
                continue  # own leases are renewed, never reaped
            claim = read_claim(cpath)
            if claim is None or self._claim_expired(claim, now):
                reclaimed += self._reclaim(jid, claim, cpath)
        # orphan pass: an admitted spec with no claim file at all is the
        # residue of a host that died between winning the claim rename
        # and durably writing its lease; one lease period of grace
        # covers a live claimant still mid-write
        for f in spool_dir(self.serve_root, "admitted").glob("*.json"):
            with self._claims_lock:
                if f.stem in self._claims:
                    continue
            if job_claims(self.serve_root, f.stem):
                continue
            try:
                age = now - f.stat().st_mtime
            except OSError:
                continue
            if age > self.lease_s:
                reclaimed += self._reclaim(f.stem, None, None)
        return reclaimed

    def _reclaim(self, job_id: str, claim: dict | None,
                 claim_file: Path | None) -> int:
        """Sweep one dead host's job back to ``incoming/``: unlink the
        stale claim FIRST (that is the fence — the stale owner's
        ``_verify_claim`` fails from this point on), then re-spool the
        spec with its epoch and attempt count preserved (daemon death
        never charges a tenant's retry budget), then drop the admitted
        copy and seal a ``job_reclaimed`` event."""
        admitted = (spool_dir(self.serve_root, "admitted")
                    / f"{job_id}.json")
        spec = self._load_spec(admitted) if admitted.exists() else None
        if spec is None:
            # claim residue without an admitted spec: the job already
            # reached a terminal state — just drop the stale file
            if claim_file is not None:
                claim_file.unlink(missing_ok=True)
            return 0
        try:
            faults.maybe_fire("reclaim", step=spec.tenant, event=job_id)
        except FaultInjected as exc:
            if exc.fatal:
                raise
            return 0  # injected reclaim fault: retry next pass
        if claim_file is not None:
            claim_file.unlink(missing_ok=True)
        atomic_write_json(
            spool_dir(self.serve_root, "incoming") / f"{job_id}.json",
            spec.to_dict(),
        )
        admitted.unlink(missing_ok=True)
        from_host = (claim or {}).get("host")
        self.ledger.append(event="job_reclaimed", job=job_id,
                           tenant=spec.tenant, from_host=from_host,
                           epoch=spec.claim_epoch, attempt=spec.attempt)
        self._metric("counter", "tmx_serve_reclaims_total",
                     tenant=spec.tenant)
        logger.warning(
            "reclaimed job %s from %s (epoch %s): lease expired and "
            "owner heartbeat stale", job_id,
            from_host or "<no claim>", spec.claim_epoch,
        )
        return 1

    def _scan_incoming(self) -> None:
        sheds = 0
        live_peers = self._live_peers()
        entries: list[tuple[Path, "JobSpec | None"]] = []
        for path in sorted(spool_dir(self.serve_root, "incoming")
                           .glob("*.json")):
            with telemetry.trace_scope(job=path.stem), \
                    telemetry.span("spool_pickup", emit=self.ledger.append):
                entries.append((path, self._load_spec(path)))
        # greedy affinity: warm-key jobs first (stable, so spool order is
        # preserved within each group)
        entries.sort(key=lambda e: bool(
            e[1] is not None and e[1].affinity_key is not None
            and self._warm_keys and e[1].affinity_key not in self._warm_keys
        ))
        for path, spec in entries:
            if preemption_requested():
                return  # drain beats admission; specs stay spooled
            if spec is None:
                # arbitrate the rejection too: exactly one fleet host
                # moves the invalid spec and seals the event
                decision = reject(REASON_INVALID)
                dst = spool_dir(self.serve_root, "rejected") / path.name
                if not claim_rename(path, dst):
                    continue
                atomic_write_json(dst, {
                    "job_id": path.stem, "decision": decision.to_dict(),
                    "ts": time.time(),
                })
                self.ledger.append(
                    event="job_rejected", job=path.stem, tenant="unknown",
                    reason=decision.reason,
                    retry_after_s=decision.retry_after_s,
                )
                self._metric("counter", "tmx_serve_rejected_total",
                             tenant="unknown", reason=decision.reason)
                continue
            # every event below inherits the job's trace labels
            # (trace_id stamped by `tmx enqueue`) via RunLedger.append
            with telemetry.trace_scope(trace_id=spec.trace_id,
                                       job=spec.job_id,
                                       tenant=spec.tenant):
                if spec.kind == canary.CANARY_KIND:
                    # self-addressed probe: only the issuing host may
                    # claim it (the latency measures THAT host's
                    # pipeline), and it never touches the admission
                    # queue — no quota, no WDRR deficit, no retry
                    # budget, no breaker (tenant invisibility, pinned)
                    owner = (spec.payload or {}).get("host")
                    if owner and owner != self.host_name:
                        if (spec.submitted_at and time.time()
                                - float(spec.submitted_at)
                                > canary.CANARY_STALE_S):
                            # a dead daemon's probe: one winner sweeps
                            # the debris, nobody executes it
                            claim_rename(
                                path,
                                spool_dir(self.serve_root, "rejected")
                                / path.name)
                        continue
                    if not self._try_claim(path, spec):
                        continue
                    now = time.time()
                    wait = (max(0.0, now - float(spec.submitted_at))
                            if spec.submitted_at else None)
                    extra = ({"queue_wait_s": round(wait, 3)}
                             if wait is not None else {})
                    self.ledger.append(
                        event="job_admitted", job=spec.job_id,
                        tenant=spec.tenant, kind=canary.CANARY_KIND,
                        attempt=spec.attempt, epoch=spec.claim_epoch,
                        **extra)
                    self._metric("counter", "tmx_canary_probes_total")
                    self._canary_ready.append(spec)
                    continue
                if self._claimed_elsewhere(spec.job_id):
                    decision = reject(REASON_DUPLICATE)
                    dst = spool_dir(self.serve_root, "rejected") / path.name
                    if not claim_rename(path, dst):
                        continue
                    atomic_write_json(dst, {
                        "job": spec.to_dict(),
                        "decision": decision.to_dict(), "ts": time.time(),
                    })
                    self.ledger.append(
                        event="job_rejected", job=spec.job_id,
                        tenant=spec.tenant, reason=decision.reason,
                        retry_after_s=decision.retry_after_s,
                    )
                    self._metric("counter", "tmx_serve_rejected_total",
                                 tenant=spec.tenant,
                                 reason=decision.reason)
                    continue
                if self._should_defer(spec, time.time(), live_peers):
                    continue  # an affine peer should claim this one
                if not self._try_claim(path, spec):
                    continue  # a peer won the race (or claim fault)
                with telemetry.span("admission", emit=self.ledger.append):
                    decision = self._offer(spec)
                if decision.admitted:
                    now = time.time()
                    wait = (max(0.0, now - float(spec.submitted_at))
                            if spec.submitted_at else None)
                    self._admit_ts[spec.job_id] = now
                    extra = ({"queue_wait_s": round(wait, 3)}
                             if wait is not None else {})
                    if spec.affinity_key is not None:
                        hit = spec.affinity_key in self._warm_keys
                        extra["affinity"] = "hit" if hit else "miss"
                        if hit:
                            self._metric("counter",
                                         "tmx_serve_affinity_hits_total",
                                         tenant=spec.tenant)
                    if wait is not None and telemetry.enabled():
                        # enqueue → admit, as a span so the Chrome trace
                        # shows the wait as a real interval
                        self.ledger.append(
                            event="span", span="queue_wait",
                            t0=round(float(spec.submitted_at), 6),
                            elapsed=round(wait, 6),
                        )
                    self.ledger.append(event="job_admitted",
                                       job=spec.job_id,
                                       tenant=spec.tenant,
                                       attempt=spec.attempt,
                                       epoch=spec.claim_epoch, **extra)
                    self._metric("counter", "tmx_serve_admitted_total",
                                 tenant=spec.tenant)
                    if wait is not None:
                        self._metric("histogram",
                                     "tmx_serve_queue_wait_seconds",
                                     wait, tenant=spec.tenant)
                else:
                    self._move_spool(spec.job_id, "rejected", {
                        "job": spec.to_dict(),
                        "decision": decision.to_dict(),
                        "ts": time.time(),
                    })
                    self._release_claim(spec.job_id)
                    self.ledger.append(
                        event="job_rejected", job=spec.job_id,
                        tenant=spec.tenant, reason=decision.reason,
                        retry_after_s=decision.retry_after_s,
                    )
                    self._metric("counter", "tmx_serve_rejected_total",
                                 tenant=spec.tenant,
                                 reason=decision.reason)
                    if decision.reason in SHED_REASONS:
                        sheds += 1
                        self._metric("counter", "tmx_serve_shed_total",
                                     tenant=spec.tenant)
        if sheds >= SHED_STORM_N and not self._shed_latch:
            self._shed_latch = True
            telemetry.flight_dump(
                telemetry.flightrec_path(serve_dir(self.serve_root)),
                reason="shed_storm", extra={"sheds": sheds},
            )
        elif sheds == 0:
            self._shed_latch = False

    # ---------------------------------------------------------- execution
    def _execute(self, job: JobSpec) -> str:
        """Run one admitted job to an outcome: ``done``, ``failed``,
        ``expired`` or ``preempted``.

        The whole execution runs under the job's trace scope, so every
        event the engine seals into the *experiment* ledger (run/step/
        batch/phase spans, compile spans, batch_done) carries the same
        ``trace_id``/``job``/``tenant`` labels as the serve ledger's
        lifecycle events — one trace id, reconstructed purely from
        ledgers, covers enqueue → result."""
        with telemetry.trace_scope(trace_id=job.trace_id, job=job.job_id,
                                   tenant=job.tenant):
            if job.kind == canary.CANARY_KIND:
                return self._execute_canary(job)
            return self._execute_traced(job)

    def _discard_canary(self, job: JobSpec) -> None:
        """Canary results are discarded: delete the admitted spec
        instead of archiving it (probes at a 1 s period would otherwise
        grow ``done/`` without bound), release the lease, and let the
        scheduler arm the next probe."""
        try:
            (spool_dir(self.serve_root, "admitted")
             / f"{job.job_id}.json").unlink(missing_ok=True)
        except OSError:
            pass
        self._release_claim(job.job_id)
        if self._canary_inflight == job.job_id:
            self._canary_inflight = None

    def _sweep_own_canaries(self) -> None:
        """Shutdown tidy-up: a probe enqueued on the final loop iteration
        can still sit unclaimed in ``incoming/`` — synthetic work
        addressed to a process that is about to not exist.  Discard it,
        plus any probe claimed but never executed, so restarts and
        foreign stale-sweeps never meet our debris."""
        try:
            for path in spool_dir(self.serve_root, "incoming").glob(
                    f"canary-{self.host_name}-*.json"):
                path.unlink(missing_ok=True)
        except OSError:
            pass
        while self._canary_ready:
            try:
                self._discard_canary(self._canary_ready.pop(0))
            except Exception:
                logger.debug("canary discard on shutdown failed",
                             exc_info=True)
        self._canary_inflight = None

    def _execute_canary(self, job: JobSpec) -> str:
        """Run one canary probe to an outcome, on a lifecycle parallel
        to :meth:`_execute_traced` but feeding only the ``tmx_canary_*``
        series: no ``queue.record_result`` (breakers/retry budgets are
        tenant machinery), no ``slo.observe_job`` (per-tenant SLO must
        not see probes — per-host availability flows through
        :func:`slo.canary_report` instead)."""
        self.ledger.append(event="job_started", job=job.job_id,
                           tenant=job.tenant, kind=canary.CANARY_KIND,
                           attempt=job.attempt)
        t0 = time.monotonic()
        try:
            with telemetry.span(
                "job",
                emit=functools.partial(self.ledger.append,
                                       attempt=job.attempt),
            ):
                summary = canary.run_probe(job.payload or {})
        except FaultInjected as exc:
            if exc.fatal:
                raise
            return self._canary_failed(job, exc)
        except Exception as exc:
            return self._canary_failed(job, exc)
        elapsed = time.monotonic() - t0
        if not self._fence(job, "done"):
            return "stale"
        extra = {"degraded": True} if summary.get("degraded") else {}
        self.ledger.append(event="job_done", job=job.job_id,
                           tenant=job.tenant, kind=canary.CANARY_KIND,
                           elapsed_s=round(elapsed, 3),
                           epoch=job.claim_epoch, **extra)
        self._metric("counter", "tmx_canary_ok_total")
        self._metric("histogram", "tmx_canary_latency_seconds", elapsed)
        if extra:
            self._metric("counter", "tmx_canary_degraded_total")
        self._discard_canary(job)
        return "done"

    def _canary_failed(self, job: JobSpec, exc: Exception) -> str:
        if not self._fence(job, "failed"):
            return "stale"
        logger.warning("canary probe %s failed: %s", job.job_id, exc)
        self.ledger.append(event="job_failed", job=job.job_id,
                           tenant=job.tenant, kind=canary.CANARY_KIND,
                           error=f"{type(exc).__name__}: {exc}")
        self._metric("counter", "tmx_canary_failed_total")
        self._discard_canary(job)
        return "failed"

    def _execute_traced(self, job: JobSpec) -> str:
        from tmlibrary_tpu_torch.models.store import ExperimentStore
        from tmlibrary_tpu_torch.workflow.engine import Workflow, WorkflowDescription

        admit_ts = self._admit_ts.pop(job.job_id, None)
        delay = (max(0.0, time.time() - admit_ts)
                 if admit_ts is not None else None)
        extra = ({"sched_delay_s": round(delay, 3)}
                 if delay is not None else {})
        if delay is not None and telemetry.enabled():
            # admit → execute start: the WDRR scheduling delay
            self.ledger.append(event="span", span="sched_delay",
                               t0=round(admit_ts, 6),
                               elapsed=round(delay, 6))
        self.ledger.append(event="job_started", job=job.job_id,
                           tenant=job.tenant, attempt=job.attempt, **extra)
        if job.affinity_key:
            # executing the job is what warms this process's compile/AOT
            # caches for its program family
            self._warm_keys.add(job.affinity_key)
        if delay is not None:
            self._metric("histogram", "tmx_serve_sched_delay_seconds",
                         delay, tenant=job.tenant)
        deadline = float(job.deadline) if job.deadline else None

        def should_stop() -> bool:
            if preemption_requested():
                return True
            return deadline is not None and time.time() >= deadline

        def stop_reason() -> str:
            if preemption_requested():
                return preemption_reason()
            return "deadline"

        t0 = time.monotonic()
        compile_counts_t0 = aotstore.counts_snapshot()
        try:
            # the job span: per-attempt wall time of the whole execution,
            # the parent interval the engine's run→step→batch→phase tree
            # (or the query's feature_store→query_tool spans) nests under
            # in the exported trace
            with telemetry.span(
                "job",
                emit=functools.partial(self.ledger.append,
                                       attempt=job.attempt),
            ):
                store = ExperimentStore.open(Path(job.root))
                if job.kind == "query":
                    resume = False
                    summary = self._run_query(job, store, deadline)
                else:
                    if job.description:
                        desc_path = Path(job.description)
                        if not desc_path.is_absolute():
                            desc_path = Path(job.root) / desc_path
                    else:
                        desc_path = store.workflow_dir / "workflow.yaml"
                    desc = WorkflowDescription.load(desc_path)
                    wf = Workflow(store, desc,
                                  pipeline_depth=job.pipeline_depth,
                                  device=self.device,
                                  should_stop=should_stop,
                                  stop_reason=stop_reason)
                    resume = wf.ledger.path.exists()
                    summary = wf.run(resume=resume)
        except PreemptedError as exc:
            if exc.reason == "deadline" and not preemption_requested():
                if not self._fence(job, "expired"):
                    return "stale"
                self.ledger.append(event="job_expired", job=job.job_id,
                                   tenant=job.tenant, step=exc.step)
                self._move_spool(job.job_id, "expired", {
                    "job": job.to_dict(), "reason": "deadline",
                    "ts": time.time(),
                })
                self._release_claim(job.job_id)
                self._metric("counter",
                             "tmx_serve_deadline_expired_total",
                             tenant=job.tenant)
                slo.observe_job(telemetry.get_registry(), job.tenant,
                                "expired")
                return "expired"
            return "preempted"  # caller drains and re-spools
        except FaultInjected as exc:
            if exc.fatal:
                raise  # simulated hard crash: recovery re-spools the job
            self._job_failed(job, exc)
            return "failed"
        except Exception as exc:
            self._job_failed(job, exc)
            return "failed"
        elapsed = time.monotonic() - t0
        if not self._fence(job, "done"):
            return "stale"
        extra_done = {}
        if job.kind == "query" and isinstance(summary, dict):
            # carried so registry_from_ledger can replay the analytics
            # counters/latency exactly as the live registry observed them
            extra_done = {"kind": "query",
                          "tool": summary.get("tool"),
                          "cache": summary.get("cache"),
                          "query_elapsed_s": summary.get("elapsed_s")}
            if summary.get("fusion_window"):
                extra_done["fusion_window"] = summary["fusion_window"]
            attrs = summary.get("attributes") or {}
            if attrs.get("index"):
                # index provenance rides the done event so ledger replay
                # and `tmx top` can attribute throughput to ivf vs brute
                extra_done["index"] = attrs["index"]
            if summary.get("cache") == "miss":
                # only a miss drove an index ensure (hits/fused reuse
                # the leader's sweep) — gating here keeps the replayed
                # build/hit counters equal to the live ones
                if attrs.get("index_cache"):
                    extra_done["index_cache"] = attrs["index_cache"]
                if attrs.get("index_fallback"):
                    extra_done["index_fallback"] = True
        # warm-start provenance: this job's cold-compile / store-import
        # deltas ride the done event so ledger replay and `tmx serve
        # status` can show which jobs became warm hosts for free
        counts_t1 = aotstore.counts_snapshot()
        for kind, field in (("cold", "compiles_cold"),
                            ("import_hit", "compile_imports")):
            delta = counts_t1.get(kind, 0.0) - compile_counts_t0.get(kind, 0.0)
            if delta > 0:
                extra_done[field] = int(delta)
        if counts_t1 != compile_counts_t0:
            # the job compiled/exported/imported: drop the throttled
            # store-stats cache so the next published warm view reflects
            # the new entries instead of a pre-job snapshot
            self._store_stats_cache = None
        self.ledger.append(event="job_done", job=job.job_id,
                           tenant=job.tenant, elapsed_s=round(elapsed, 3),
                           epoch=job.claim_epoch, resumed=resume,
                           **extra_done)
        self._move_spool(job.job_id, "done", {
            "job": job.to_dict(), "summary": summary,
            "elapsed_s": round(elapsed, 3), "ts": time.time(),
        })
        self._release_claim(job.job_id)
        self.queue.record_result(job.tenant, ok=True)
        self._metric("counter", "tmx_serve_jobs_done_total",
                     tenant=job.tenant)
        self._metric("histogram", "tmx_serve_job_seconds", elapsed,
                     tenant=job.tenant)
        # the same observe_job definition registry_from_ledger replays,
        # so a live registry and a ledger-replayed one agree exactly
        slo.observe_job(telemetry.get_registry(), job.tenant, "ok",
                        round(elapsed, 3))
        return "done"

    def _run_query(self, job: JobSpec, store, deadline: float | None
                   ) -> dict:
        """Execute one ``kind=query`` job inside the caller's job span
        (its ``feature_store``/``query_tool`` phases become child spans
        on the serve ledger).  Queries are short and idempotent
        (digest-keyed cache), so preemption and deadline are checked
        once up front instead of per batch — a re-spooled query re-runs
        as a cache hit.

        Fusion: a leader job (one with follower peers pulled by the run
        loop) executes the WHOLE group as one
        :func:`~tmlibrary_tpu_torch.analytics.query.run_query_batch` sweep and
        stashes each follower's summary; a follower pops its stashed
        summary instead of touching the device.  Either way every job
        gets its own lifecycle events, cache entry and tenant
        attribution."""
        from tmlibrary_tpu_torch.analytics import query as analytics_query

        stashed = self._fusion_results.pop(job.job_id, None)
        group = self._fusion_peers.pop(job.job_id, None) or []
        if preemption_requested():
            raise PreemptedError("preempted before query start",
                                 step="query",
                                 reason=preemption_reason())
        if deadline is not None and time.time() >= deadline:
            raise PreemptedError("query deadline expired before start",
                                 step="query", reason="deadline")
        if stashed is not None:
            summary = stashed
        elif group:
            payloads = [dict(job.payload or {})]
            payloads.extend(dict(j.payload or {}) for j in group)
            summaries = analytics_query.run_query_batch(
                store, payloads, emit=self.ledger.append, device=self.device,
            )
            summary = summaries[0]
            for peer, s in zip(group, summaries[1:]):
                self._fusion_results[peer.job_id] = s
            window = len(payloads)
            self.ledger.append(
                event="query_fused", job=job.job_id, tenant=job.tenant,
                window=window,
                jobs=[j.job_id for j in group],
                store_digest=summary.get("store_digest"),
            )
            self._metric("counter", "tmx_serve_query_fused_total",
                         value=float(window))
            self._metric("histogram", "tmx_serve_fusion_window",
                         float(window))
        else:
            summary = analytics_query.run_query(
                store, dict(job.payload or {}), emit=self.ledger.append,
                device=self.device,
            )
        self._metric("counter", "tmx_analytics_jobs_total",
                     tenant=job.tenant,
                     tool=str(summary.get("tool", "unknown")))
        return summary

    def _job_failed(self, job: JobSpec, exc: Exception) -> None:
        logger.warning("serve job %s failed: %s", job.job_id, exc)
        if not self._fence(job, "failed"):
            return
        self.ledger.append(event="job_failed", job=job.job_id,
                           tenant=job.tenant, error=str(exc),
                           exception=type(exc).__name__)
        self._move_spool(job.job_id, "failed", {
            "job": job.to_dict(), "error": str(exc),
            "exception": type(exc).__name__, "ts": time.time(),
        })
        self._release_claim(job.job_id)
        self.queue.record_result(job.tenant, ok=False)
        self._metric("counter", "tmx_serve_jobs_failed_total",
                     tenant=job.tenant)
        slo.observe_job(telemetry.get_registry(), job.tenant, "failed")

    def _fusion_group_for(self, job: JobSpec) -> list[JobSpec]:
        """Follower jobs to fuse with ``job``'s sweep: queued ``query``
        jobs on the SAME experiment root whose payloads share ``job``'s
        fusion signature (everything but k — same store digest by
        construction, since the digest is a pure function of the root's
        shards).  Pulled from the admission queue up to the configured
        window; empty when fusion is off, the job is not fusable, or
        nobody else is waiting."""
        from tmlibrary_tpu_torch.config import cfg

        window = int(cfg.serve_fusion_window)
        if (not cfg.serve_query_fusion or window <= 1
                or job.kind != "query"):
            return []
        from tmlibrary_tpu_torch.analytics.query import fusion_signature

        sig = fusion_signature(job.payload or {})
        if sig is None:
            return []
        group = self.queue.take_matching(
            lambda j: (j.kind == "query" and j.root == job.root
                       and fusion_signature(j.payload or {}) == sig),
            window - 1,
        )
        if group:
            self._fusion_peers[job.job_id] = list(group)
        return group

    # -------------------------------------------------------------- drain
    def _drain_and_exit(self, current: JobSpec | None = None,
                        pending: list[JobSpec] | None = None) -> int:
        """The SIGTERM path: re-spool the interrupted job plus every
        queued job back to ``incoming/`` (attempt counts preserved — a
        preemption must never charge a tenant's retry budget), seal the
        serve ledger with ``serve_preempted``, and hand the pinned
        resume exit code to the wrapper.  ``pending`` carries fusion
        followers pulled from the queue but not yet executed — their
        fused results are already in the query cache, so the re-run is
        a cache hit."""
        requeued = []
        if current is not None:
            requeued.append(current)
        requeued.extend(pending or [])
        requeued.extend(self.queue.drain())
        for job in requeued:
            atomic_write_json(
                spool_dir(self.serve_root, "incoming")
                / f"{job.job_id}.json",
                job.to_dict(),  # claim_epoch rides along for the fence
            )
            admitted = (spool_dir(self.serve_root, "admitted")
                        / f"{job.job_id}.json")
            if admitted.exists():
                admitted.unlink()
            self._release_claim(job.job_id)
            self.ledger.append(event="job_requeued", job=job.job_id,
                               tenant=job.tenant, phase="drain")
        self.ledger.append(event="serve_preempted",
                           reason=preemption_reason(),
                           requeued=len(requeued))
        telemetry.flight_dump(
            telemetry.flightrec_path(serve_dir(self.serve_root)),
            reason=f"preempted:{preemption_reason()}",
            extra={"requeued": len(requeued)},
        )
        self._metric("counter", "tmx_serve_preemptions_total")
        logger.warning(
            "serve preempted (%s): re-spooled %d job(s), exiting %d for "
            "wrapper restart", preemption_reason(), len(requeued),
            EXIT_PREEMPTED,
        )
        return EXIT_PREEMPTED

    # ---------------------------------------------------------------- run
    def run(self) -> int:
        restore = (install_preemption_handlers()
                   if self.install_handlers else None)
        idle_since: float | None = None
        try:
            recovered = self._recover_spool()
            self.ledger.append(event="serve_started",
                               recovered=recovered,
                               lease_s=self.lease_s,
                               max_queue=self.queue.config.max_queue)
            # lease renewal rides the heartbeat cadence from its own
            # thread, so a long blocking job never lets our claims lapse
            self._renewer = LeaseRenewer(self._renew_leases,
                                         period=max(0.2, self.lease_s / 3))
            self._renewer.start()
            while True:
                try:
                    with self._arm("admission"):
                        self._scan_incoming()
                except FaultInjected as exc:
                    if exc.fatal:
                        raise
                    logger.warning("admission scan fault: %s", exc)
                except Exception as exc:
                    # incl. WatchdogTimeout from a wedged scan: count it
                    # and keep serving — overload/chaos never crash
                    logger.warning("admission scan error: %s", exc)
                try:
                    self._reap_expired()
                except FaultInjected as exc:
                    if exc.fatal:
                        raise
                    logger.warning("reaper fault: %s", exc)
                except Exception as exc:
                    logger.warning("reaper error: %s", exc)
                if self._watchdog is not None:
                    fired = False
                    for ev in self._watchdog.drain_events():
                        self.ledger.append(event="watchdog", **ev)
                        fired = True
                    if fired:
                        telemetry.flight_dump(
                            telemetry.flightrec_path(
                                serve_dir(self.serve_root)),
                            reason="watchdog",
                        )
                self._publish_state()
                self._check_slo()
                self._check_anomalies()
                self._flush_timeseries()
                try:
                    self._maybe_canary()
                except Exception as exc:
                    logger.warning("canary scheduling error: %s", exc)
                if preemption_requested():
                    return self._drain_and_exit()
                while self._canary_ready:
                    # probes run ahead of tenant work (they must not
                    # queue behind it or they'd measure the backlog
                    # twice) and never count toward max-jobs
                    probe = self._canary_ready.pop(0)
                    if self._execute(probe) == "preempted":
                        self._discard_canary(probe)
                        return self._drain_and_exit()
                job = self.queue.take()
                if job is None:
                    if self.idle_exit_s > 0:
                        now = time.monotonic()
                        if idle_since is None:
                            idle_since = now
                        elif now - idle_since >= self.idle_exit_s:
                            logger.info("serve idle for %.1fs — exiting",
                                        now - idle_since)
                            return 0
                    time.sleep(self.poll_s)
                    continue
                idle_since = None
                group = self._fusion_group_for(job)
                outcome = self._execute(job)
                if outcome == "preempted":
                    return self._drain_and_exit(current=job, pending=group)
                self._jobs_run += 1
                for i, peer in enumerate(group):
                    outcome = self._execute(peer)
                    if outcome == "preempted":
                        return self._drain_and_exit(
                            current=peer, pending=group[i + 1:])
                    self._jobs_run += 1
                # max-jobs is honored at group granularity: a fused
                # window always finishes before the daemon exits
                if self.max_jobs and self._jobs_run >= self.max_jobs:
                    logger.info("serve reached max-jobs=%d — exiting",
                                self.max_jobs)
                    return 0
        finally:
            if self._renewer is not None:
                self._renewer.stop()
            if self._watchdog is not None:
                self._watchdog.stop()
            exc = sys.exc_info()[1]
            if exc is not None and not (isinstance(exc, FaultInjected)
                                        and exc.fatal):
                # unhandled crash: preserve the last-N event ring for the
                # post-mortem (a FATAL injected fault simulates hard
                # process death — a dead process writes nothing)
                telemetry.flight_dump(
                    telemetry.flightrec_path(serve_dir(self.serve_root)),
                    reason=f"crash:{type(exc).__name__}",
                )
            self._sweep_own_canaries()
            self._publish_state()
            self._flush_timeseries(force=True)
            self._write_metrics()
            if restore is not None:
                restore()


def run_serve(serve_root: Path, **kwargs) -> int:
    """Construct and run a :class:`ServeDaemon` (the CLI entry)."""
    return ServeDaemon(serve_root, **kwargs).run()


# ----------------------------------------------------------------- status
def serve_status_view(serve_root: Path) -> dict:
    """Disk-derived status for ``tmx-torch serve status`` and the ``tmx top``
    SERVE panel: the daemon's last published snapshot (``status.json``),
    heartbeat liveness, spool counts, and ledger-derived per-tenant
    counters — readable with or without a live daemon."""
    serve_root = Path(serve_root)
    view: dict = {"root": str(serve_root), "live": False}
    # ---- fleet: one row per per-host heartbeat; the legacy top-level
    # heartbeat_age_s/live keys reflect the freshest host so single-host
    # consumers keep working unchanged
    hosts: dict[str, dict] = {}
    best_age: float | None = None
    for hb_path in sorted(serve_dir(serve_root).glob("heartbeat*.json")):
        hb = telemetry.read_heartbeat(hb_path)
        if hb is None:
            continue
        host = str(hb.get("host") or "host0")
        age = telemetry.heartbeat_age(hb_path)
        period = float(hb.get("period", 0) or 0)
        live = bool(
            age is not None and (period <= 0 or age <= max(5.0, 4 * period))
        )
        hosts[host] = {
            "heartbeat_age_s": None if age is None else round(age, 1),
            "live": live, "lease_s": hb.get("lease_s"), "leases": 0,
        }
        view["live"] = view["live"] or live
        if age is not None and (best_age is None or age < best_age):
            best_age = age
    if hosts:
        view["heartbeat_age_s"] = (None if best_age is None
                                   else round(best_age, 1))
    for _, _, owner in job_claims(serve_root):
        hosts.setdefault(owner, {"heartbeat_age_s": None, "live": False,
                                 "lease_s": None, "leases": 0})
        hosts[owner]["leases"] += 1
    import json

    try:
        view["status"] = json.loads(status_file(serve_root).read_text())
    except Exception:
        view["status"] = None
    view["spool"] = {
        state: len(list(spool_dir(serve_root, state).glob("*.json")))
        for state in SPOOL_STATES
        if spool_dir(serve_root, state).is_dir()
    }
    tenants: dict[str, dict] = {}
    preempted = 0
    reclaims = 0
    stale_claims = 0
    affinity_hits = 0
    affinity_known = 0
    compile_imports = 0
    compiles_cold = 0
    view["slo"] = None
    view["queries"] = None
    view["canary"] = None
    view["anomalies"] = None
    canary_stats = {"probes": 0, "ok": 0, "failed": 0, "degraded": 0}
    canary_lat: list[float] = []
    anomalies: dict[str, int] = {}
    queries: dict = {"total": 0, "cache": {}, "index": {},
                     "fusion_events": 0, "fusion_jobs": 0,
                     "index_builds": 0, "index_hits": 0,
                     "index_fallbacks": 0}
    qtimes: list[float] = []
    events = serve_ledger_events(serve_root)
    if events:
        waits: dict[str, list[float]] = {}
        for ev in events:
            kind = ev.get("event")
            if kind == "serve_preempted":
                preempted += 1
                continue
            if kind == "stale_claim":
                stale_claims += 1
                continue
            if kind == "query_fused":
                queries["fusion_events"] += 1
                queries["fusion_jobs"] += int(ev.get("window") or 0)
                continue
            if kind == "job_done" and ev.get("kind") == "query":
                # the QUERY row: per-cache / per-index-mode counts plus
                # query latency, straight from the done-event extras the
                # daemon records for ledger replay (no registry needed)
                queries["total"] += 1
                c = str(ev.get("cache") or "?")
                queries["cache"][c] = queries["cache"].get(c, 0) + 1
                mode = str(ev.get("index") or "?")
                queries["index"][mode] = queries["index"].get(mode, 0) + 1
                ic = ev.get("index_cache")
                if ic == "build":
                    queries["index_builds"] += 1
                elif ic == "hit":
                    queries["index_hits"] += 1
                if ev.get("index_fallback"):
                    queries["index_fallbacks"] += 1
                if ev.get("query_elapsed_s") is not None:
                    qtimes.append(float(ev["query_elapsed_s"]))
            if kind == "anomaly":
                m = str(ev.get("metric") or "?")
                anomalies[m] = anomalies.get(m, 0) + 1
                continue
            if ev.get("kind") == "canary":
                # probes are tenant-invisible: their own CANARY panel,
                # never the tenant tables or queue-wait stats
                if kind == "job_admitted":
                    canary_stats["probes"] += 1
                elif kind == "job_done":
                    canary_stats["ok"] += 1
                    if ev.get("degraded"):
                        canary_stats["degraded"] += 1
                    if ev.get("elapsed_s") is not None:
                        canary_lat.append(float(ev["elapsed_s"]))
                elif kind == "job_failed":
                    canary_stats["failed"] += 1
                continue
            if kind not in ("job_admitted", "job_rejected", "job_done",
                            "job_failed", "job_expired", "job_requeued",
                            "job_reclaimed"):
                continue
            t = tenants.setdefault(str(ev.get("tenant", "unknown")), {
                "admitted": 0, "rejected": 0, "done": 0, "failed": 0,
                "expired": 0, "requeued": 0, "reclaimed": 0,
            })
            t[kind.removeprefix("job_")] += 1
            if kind == "job_done":
                compile_imports += int(ev.get("compile_imports") or 0)
                compiles_cold += int(ev.get("compiles_cold") or 0)
            if kind == "job_reclaimed":
                reclaims += 1
            if kind == "job_admitted":
                if ev.get("queue_wait_s") is not None:
                    waits.setdefault(str(ev.get("tenant", "unknown")),
                                     []).append(float(ev["queue_wait_s"]))
                if ev.get("affinity") is not None:
                    affinity_known += 1
                    if ev["affinity"] == "hit":
                        affinity_hits += 1
        view["queue_wait_s"] = {
            tenant: {"n": len(vals),
                     "p50": slo.quantile(vals, 0.50),
                     "p95": slo.quantile(vals, 0.95)}
            for tenant, vals in sorted(waits.items())
        }
        try:
            # the SLO panel `tmx top`/`tmx slo`/CI all consume — derived
            # from the same (merged) ledger events, so it works with or
            # without a live daemon
            view["slo"] = slo.report(events)
        except Exception:
            logger.debug("slo report failed", exc_info=True)
        if any(canary_stats.values()):
            canary_stats["latency_s"] = {
                "n": len(canary_lat),
                "p50": slo.quantile(canary_lat, 0.50),
                "p95": slo.quantile(canary_lat, 0.95),
            } if canary_lat else None
            view["canary"] = canary_stats
        if anomalies:
            view["anomalies"] = anomalies
    if queries["total"] or queries["fusion_events"]:
        queries["elapsed_s"] = {
            "n": len(qtimes),
            "p50": slo.quantile(qtimes, 0.50),
            "p95": slo.quantile(qtimes, 0.95),
        } if qtimes else None
        view["queries"] = queries
    view["tenants"] = tenants
    view["preemptions"] = preempted
    # ---- WARM: the fleet-shared serialized-executable store (DESIGN.md
    # §28) read straight from disk, plus the daemon's last-published
    # warm snapshot — meaningful with or without a live daemon
    try:
        store = aotstore.store_stats(str(aot_store_path(serve_root)))
        view["warm"] = {
            "store_dir": store.get("dir"),
            "entries": int(store.get("entries", 0)),
            "bytes": int(store.get("total_bytes", 0)),
            "stale_entries": int(store.get("stale_entries", 0)),
            "fingerprint": store.get("fingerprint"),
            "compile_imports": compile_imports,
            "compiles_cold": compiles_cold,
            "published": (view["status"] or {}).get("warm")
            if isinstance(view.get("status"), dict) else None,
        }
    except Exception:
        logger.debug("warm store view failed", exc_info=True)
        view["warm"] = None
    view["fleet"] = {
        "hosts": hosts,
        "ledgers": [p.name for p in serve_ledger_paths(serve_root)],
        "reclaims_total": reclaims,
        "stale_claims_total": stale_claims,
        "affinity": {
            "hits": affinity_hits,
            "known": affinity_known,
            "hit_rate": (round(affinity_hits / affinity_known, 3)
                         if affinity_known else None),
        },
    }
    return view
