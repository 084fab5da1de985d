"""Admission control for the ``tmx serve`` daemon.

Counterpart: ``tmlibrary_tpu/workflow/admission.py``, which imports no JAX; the port keeps
its own copy, held equal to it on the same inputs by
``tests/test_torch_admission.py``.

The serving loop (``tmlibrary_tpu/serve.py``) is only viable as a
long-lived process if overload degrades *gracefully*: a flooded queue
must shed deterministically, one tenant's burst must not starve the
others, a retry storm must turn into early rejection, and a failing
tenant must trip to tenant-scoped rejection instead of taking the
daemon down.  All of those policies live here, in front of the
workflow engine, so the engine itself never sees load it cannot carry.

Mechanisms
----------
Bounded queue with watermark hysteresis
    At ``max_queue`` total queued jobs the queue enters *shedding*:
    every new offer is rejected with ``queue_full`` until the depth
    drains below ``low_watermark``.  Hysteresis prevents admit/shed
    flapping right at the boundary.
Per-tenant quotas
    A tenant may hold at most ``tenant_quota`` queued jobs; excess
    offers are rejected with ``tenant_quota`` while other tenants keep
    admitting.
Weighted deficit-round-robin dispatch
    :meth:`AdmissionQueue.take` serves tenants in sorted-name rotation,
    accumulating ``quantum * weight`` deficit per visit and spending
    one unit per job — a classic DRR scheduler, fully deterministic
    (no randomness, no wall-clock dependence).
Per-tenant retry budgets
    Resubmissions (``attempt > 0``) spend one token from the tenant's
    budget; an exhausted budget rejects with ``retry_budget``.  Each
    successful job refunds one token (capped at the budget), so a
    healthy tenant's budget self-heals.
Per-tenant circuit breakers
    Job failures feed a :class:`~tmlibrary_tpu_torch.resilience.CircuitBreaker`
    per tenant; an open breaker rejects that tenant's offers with
    ``tenant_breaker_open`` while everyone else is unaffected.

Every rejection carries a **pinned** ``retry_after_s`` from
:data:`RETRY_AFTER_S` — the contract clients (and the chaos tests)
rely on.  Rejection is always a *decision*, never an exception: the
admission layer cannot crash the daemon.
"""

from __future__ import annotations

import dataclasses
import time
from bisect import insort

from tmlibrary_tpu_torch.resilience import CircuitBreaker

# --------------------------------------------------------------- contract
#: pinned rejection reasons (ledger ``job_rejected.reason`` values)
REASON_QUEUE_FULL = "queue_full"
REASON_TENANT_QUOTA = "tenant_quota"
REASON_RETRY_BUDGET = "retry_budget"
REASON_BREAKER_OPEN = "tenant_breaker_open"
REASON_DEADLINE = "deadline_expired"
REASON_DUPLICATE = "duplicate"
REASON_INVALID = "invalid_spec"
REASON_FAULT = "admission_fault"

#: pinned retry-after seconds per rejection reason — part of the serve
#: API contract (DESIGN.md §20 overload policy table); clients sleep
#: this long before resubmitting.  0 means "do not retry as-is".
RETRY_AFTER_S: dict[str, float] = {
    REASON_QUEUE_FULL: 30.0,
    REASON_TENANT_QUOTA: 15.0,
    REASON_RETRY_BUDGET: 120.0,
    REASON_BREAKER_OPEN: 60.0,
    REASON_DEADLINE: 0.0,
    REASON_DUPLICATE: 0.0,
    REASON_INVALID: 0.0,
    REASON_FAULT: 10.0,
}

#: rejection reasons that count as load shedding (the overload signal,
#: as opposed to a per-job problem like an expired deadline)
SHED_REASONS = frozenset(
    {REASON_QUEUE_FULL, REASON_TENANT_QUOTA, REASON_RETRY_BUDGET,
     REASON_BREAKER_OPEN}
)


# ------------------------------------------------------------------- job
@dataclasses.dataclass
class JobSpec:
    """One spooled serve job: a workflow submission — or, with
    ``kind="query"``, one analytics query — for one experiment.

    ``deadline`` is an *absolute* unix timestamp (computed by ``tmx
    enqueue`` from its ``--deadline`` relative seconds) so the budget
    keeps counting down across re-spools and daemon restarts.
    ``attempt`` counts tenant resubmissions of the same job id — the
    daemon's own preemption re-spool preserves it, so a drain/restart
    cycle never charges the tenant's retry budget.
    """

    job_id: str
    root: str
    tenant: str = "default"
    description: str | None = None
    priority: int = 0
    deadline: float | None = None
    pipeline_depth: int | None = None
    attempt: int = 0
    submitted_at: float = 0.0
    #: end-to-end trace correlation id stamped by ``tmx enqueue``; every
    #: span/ledger event emitted on behalf of this job carries it, so one
    #: id links enqueue → admission → queue wait → execution phases.
    trace_id: str | None = None
    #: job kind: ``workflow`` (the default — run the experiment's
    #: workflow), ``query`` (answer one analytics query; see
    #: ``analytics/query.py``), or ``canary`` (a self-addressed health
    #: probe — claimed directly by its issuing daemon, never admitted to
    #: the queue; see ``canary.py``).  Old spool files carry no ``kind``
    #: and deserialize as workflows.
    kind: str = "workflow"
    #: the query payload for ``kind="query"`` jobs (tool name +
    #: tool-specific arguments); ignored for workflow jobs
    payload: dict | None = None
    #: highest lease epoch this job has ever been claimed under (fleet
    #: spool protocol, DESIGN.md §25).  Each claim stamps ``epoch + 1``
    #: back into the spooled spec; the claiming host checks its epoch
    #: against the on-disk claim before every done/failed transition, so
    #: a stale host resuming after a GC pause cannot clobber a reclaimed
    #: job's result.  Old spool files deserialize at epoch 0.
    claim_epoch: int = 0
    #: compiled-program affinity key (``serve.affinity_key_for``): a
    #: content digest over the job's workflow description + jterator
    #: project, the routing hint a fleet host compares against its warm
    #: AOT/compile caches when choosing which spooled jobs to claim.
    affinity_key: str | None = None

    def sort_key(self) -> tuple:
        """Deterministic within-tenant order: priority desc, then
        submission time, then id (the final tiebreak makes replayed
        offer sequences reproduce byte-identical take() orders)."""
        return (-int(self.priority), float(self.submitted_at), self.job_id)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v is not None}

    @classmethod
    def from_dict(cls, d: dict) -> "JobSpec":
        if not d.get("job_id") or not d.get("root"):
            raise ValueError("job spec needs 'job_id' and 'root'")
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class AdmissionDecision:
    """Outcome of one :meth:`AdmissionQueue.offer`."""

    admitted: bool
    reason: str | None = None
    retry_after_s: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def reject(reason: str) -> AdmissionDecision:
    """The pinned rejection for ``reason`` (unknown reasons get the
    admission-fault retry-after rather than crashing)."""
    return AdmissionDecision(
        admitted=False, reason=reason,
        retry_after_s=RETRY_AFTER_S.get(reason, RETRY_AFTER_S[REASON_FAULT]),
    )


@dataclasses.dataclass
class AdmissionConfig:
    """Queue policy knobs (``cfg.serve_*`` defaults; CLI flags beat)."""

    max_queue: int = 64
    low_watermark: int = 0  # 0 = max_queue // 2
    tenant_quota: int = 16
    retry_budget: int = 8
    quantum: float = 1.0
    tenant_weights: dict[str, float] = dataclasses.field(default_factory=dict)
    breaker_threshold: int = 3
    breaker_cooldown: float = 60.0

    @classmethod
    def from_library_config(cls) -> "AdmissionConfig":
        from tmlibrary_tpu_torch.config import cfg

        return cls(
            max_queue=int(cfg.serve_max_queue),
            low_watermark=int(cfg.serve_low_watermark),
            tenant_quota=int(cfg.serve_tenant_quota),
            retry_budget=int(cfg.serve_retry_budget),
        )

    @property
    def effective_low_watermark(self) -> int:
        low = int(self.low_watermark)
        if low <= 0:
            low = max(1, int(self.max_queue) // 2)
        return min(low, int(self.max_queue))


@dataclasses.dataclass
class _TenantState:
    name: str
    weight: float = 1.0
    queue: list = dataclasses.field(default_factory=list)  # (sort_key, job)
    deficit: float = 0.0
    retry_tokens: int = 0
    admitted: int = 0
    rejected: int = 0
    done: int = 0
    failed: int = 0
    rejected_by_reason: dict = dataclasses.field(default_factory=dict)
    breaker: CircuitBreaker | None = None


# ----------------------------------------------------------------- queue
class AdmissionQueue:
    """Bounded multi-tenant priority queue with deterministic shedding.

    Single-threaded by design: the serve daemon's admission loop is the
    only caller (thread discipline mirrors the ledger's engine-thread
    rule), so no lock is needed and every decision is a pure function
    of the offer/take/record_result history — which is what makes the
    shed-determinism chaos tests possible.
    """

    def __init__(self, config: AdmissionConfig | None = None,
                 clock=time.time):
        self.config = config or AdmissionConfig()
        self._clock = clock
        self._tenants: dict[str, _TenantState] = {}
        self._queued_ids: set[str] = set()
        self._shedding = False
        self._last_served: str | None = None

    # ------------------------------------------------------------ state
    def _tenant(self, name: str) -> _TenantState:
        st = self._tenants.get(name)
        if st is None:
            st = _TenantState(
                name=name,
                weight=float(self.config.tenant_weights.get(name, 1.0)),
                retry_tokens=int(self.config.retry_budget),
                breaker=CircuitBreaker(
                    failure_threshold=self.config.breaker_threshold,
                    cooldown=self.config.breaker_cooldown,
                ),
            )
            self._tenants[name] = st
        return st

    def depth(self) -> int:
        return sum(len(st.queue) for st in self._tenants.values())

    def shedding(self) -> bool:
        return self._shedding

    def oldest_age(self, now: float | None = None) -> float | None:
        """Age in seconds of the oldest queued job, None when empty."""
        now = self._clock() if now is None else now
        oldest = min(
            (job.submitted_at for st in self._tenants.values()
             for _, job in st.queue),
            default=None,
        )
        return None if oldest is None else max(0.0, now - oldest)

    # ------------------------------------------------------------ offer
    def offer(self, job: JobSpec,
              now: float | None = None) -> AdmissionDecision:
        """Admit or reject ``job``.  Check order is pinned (and
        documented in DESIGN.md §20): duplicate → deadline → breaker →
        retry budget → tenant quota → watermark.  Never raises."""
        now = self._clock() if now is None else now
        st = self._tenant(job.tenant)
        depth = self.depth()
        # watermark hysteresis bookkeeping happens on every offer, even
        # ones rejected for per-job reasons, so shedding state tracks
        # the actual depth trajectory
        if self._shedding and depth <= self.config.effective_low_watermark:
            self._shedding = False

        decision: AdmissionDecision | None = None
        if job.job_id in self._queued_ids:
            decision = reject(REASON_DUPLICATE)
        elif job.deadline is not None and now >= float(job.deadline):
            decision = reject(REASON_DEADLINE)
        elif st.breaker is not None and not st.breaker.allow():
            decision = reject(REASON_BREAKER_OPEN)
        elif job.attempt > 0 and st.retry_tokens <= 0:
            decision = reject(REASON_RETRY_BUDGET)
        elif len(st.queue) >= int(self.config.tenant_quota):
            decision = reject(REASON_TENANT_QUOTA)
        elif self._shedding or depth >= int(self.config.max_queue):
            self._shedding = True
            decision = reject(REASON_QUEUE_FULL)

        if decision is not None:
            st.rejected += 1
            st.rejected_by_reason[decision.reason] = (
                st.rejected_by_reason.get(decision.reason, 0) + 1
            )
            return decision

        if job.attempt > 0:
            st.retry_tokens -= 1
        insort(st.queue, (job.sort_key(), job))
        self._queued_ids.add(job.job_id)
        st.admitted += 1
        return AdmissionDecision(admitted=True)

    # ------------------------------------------------------------- take
    def take(self, now: float | None = None) -> JobSpec | None:
        """Next job under weighted deficit-round-robin, or None."""
        if self.depth() == 0:
            # classic DRR: deficit does not accumulate while idle
            for st in self._tenants.values():
                st.deficit = 0.0
            return None
        # a tenant whose visit left residual deficit keeps the floor
        # until it is spent — this is what makes weights > 1 grant
        # proportionally more service (weight 2.0 => two jobs per
        # rotation) instead of degenerating to plain round-robin
        if self._last_served is not None:
            held = self._tenants.get(self._last_served)
            if held is not None and held.queue and held.deficit >= 1.0:
                held.deficit -= 1.0
                _, job = held.queue.pop(0)
                self._queued_ids.discard(job.job_id)
                return job
        tenants = sorted(t for t, st in self._tenants.items() if st.queue)
        start = 0
        if self._last_served is not None:
            for i, t in enumerate(tenants):
                if t > self._last_served:
                    start = i
                    break
        order = tenants[start:] + tenants[:start]
        quantum = float(self.config.quantum)
        min_weight = min(self._tenants[t].weight for t in order)
        rounds = 2 + int(1.0 / max(min_weight * quantum, 1e-6))
        for _ in range(rounds):
            for name in order:
                st = self._tenants[name]
                if not st.queue:
                    st.deficit = 0.0
                    continue
                st.deficit += quantum * st.weight
                if st.deficit >= 1.0:
                    st.deficit -= 1.0
                    _, job = st.queue.pop(0)
                    self._queued_ids.discard(job.job_id)
                    self._last_served = name
                    return job
        return None  # unreachable with positive weights; defensive

    def take_matching(self, pred, limit: int) -> list[JobSpec]:
        """Remove and return up to ``limit`` queued jobs satisfying
        ``pred(job)``, in deterministic (tenant-name, priority) order —
        the multi-query fusion path pulls same-store query jobs to ride
        one batched device sweep.  DRR deficits are untouched: fused
        followers ride the leader's turn (their work is free at the
        device), and every follower still records its own result, so
        per-tenant accounting stays intact."""
        out: list[JobSpec] = []
        if limit <= 0:
            return out
        for name in sorted(self._tenants):
            st = self._tenants[name]
            keep = []
            for item in st.queue:
                job = item[1]
                if len(out) < int(limit) and pred(job):
                    out.append(job)
                    self._queued_ids.discard(job.job_id)
                else:
                    keep.append(item)
            st.queue[:] = keep
            if len(out) >= int(limit):
                break
        return out

    def drain(self) -> list[JobSpec]:
        """Remove and return every queued job in deterministic
        (tenant-name, priority) order — the SIGTERM re-spool path."""
        out: list[JobSpec] = []
        for name in sorted(self._tenants):
            st = self._tenants[name]
            out.extend(job for _, job in st.queue)
            st.queue.clear()
            st.deficit = 0.0
        self._queued_ids.clear()
        return out

    # ---------------------------------------------------------- results
    def record_result(self, tenant: str, ok: bool) -> None:
        """Feed a job outcome back into the tenant's breaker and retry
        budget (success refunds one retry token)."""
        st = self._tenant(tenant)
        if ok:
            st.done += 1
            if st.breaker is not None:
                st.breaker.record_success()
            st.retry_tokens = min(
                int(self.config.retry_budget), st.retry_tokens + 1
            )
        else:
            st.failed += 1
            if st.breaker is not None:
                st.breaker.record_failure()

    # --------------------------------------------------------- snapshot
    def snapshot(self, now: float | None = None) -> dict:
        """Status view: depth, shedding flag, per-tenant counters."""
        now = self._clock() if now is None else now
        age = self.oldest_age(now)
        return {
            "depth": self.depth(),
            "shedding": self._shedding,
            "high_watermark": int(self.config.max_queue),
            "low_watermark": self.config.effective_low_watermark,
            "oldest_job_age_s": None if age is None else round(age, 3),
            "tenants": {
                name: {
                    "queued": len(st.queue),
                    "admitted": st.admitted,
                    "rejected": st.rejected,
                    "rejected_by_reason": dict(st.rejected_by_reason),
                    "done": st.done,
                    "failed": st.failed,
                    "retry_budget_remaining": st.retry_tokens,
                    "weight": st.weight,
                    "breaker": (st.breaker.state if st.breaker else "closed"),
                }
                for name, st in sorted(self._tenants.items())
            },
        }
