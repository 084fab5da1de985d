"""Fault-tolerant batch execution: classification, retry and the
quarantine budget.

Counterpart: ``tmlibrary_tpu/resilience.py``, of which the port keeps
what the workflow engine's default path uses:

- :func:`classify` splits *transient* faults (timeouts, IO flakes, out of
  memory) from *permanent* ones (bad data or descriptions, a missing
  card, a kernel that does not build).  Only transients retry.
- :class:`RetryPolicy` is exponential backoff with seeded jitter and a
  deadline; :func:`retry_call` runs a call under it and never raises.
- :class:`ResilienceConfig` bundles the policy with the per-step
  quarantine budget and the QC flag budget, defaulted from
  :class:`~tmlibrary_tpu_torch.config.LibraryConfig`.

- :func:`call_with_timeout` turns a hanging call into
  :class:`ProbeTimeoutError`; :class:`CircuitBreaker` counts consecutive
  failures with a doubling cooldown (the serve daemon keeps one per
  tenant).
- **Preemption drain** (:func:`install_preemption_handlers`,
  :func:`preemption_requested`): a SIGTERM/SIGINT sets a process-wide
  flag the engine polls at batch boundaries; the run stops admitting
  batches, drains the pipelined window, records ``run_preempted`` and
  the CLI exits with :data:`EXIT_PREEMPTED` (75) so ``resume`` continues
  from the boundary.
- :class:`PhaseWatchdog` arms per-phase deadlines over the pipelined
  launch/block/persist phases; an overrun is :class:`WatchdogTimeout`
  (transient), counted and ledgered.  Off (the default) it costs
  nothing: no thread, no arming, no events.
- :class:`LeaseRenewer` keeps the fleet's claims fresh while the serve
  daemon's main thread runs a job.

The reference's ``DeviceHealthGuard`` pins the backend to the CPU when
device probes fail; that fallback hides the card and is not ported: a
dead card raises.  With it goes its ``note_watchdog_fire`` hook, so a
watchdog fire here is counted and ledgered but feeds no breaker.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import random
import signal as _signal
import threading
import time
from typing import Any, Callable, Iterator

from tmlibrary_tpu_torch import telemetry
from tmlibrary_tpu_torch.config import LibraryConfig, cfg
from tmlibrary_tpu_torch.errors import (
    BuildError,
    DeviceError,
    FaultInjected,
    JobDescriptionError,
    MetadataError,
    NotSupportedError,
    PipelineError,
    ProbeTimeoutError,
    RegistryError,
    TransientDeviceError,
    WatchdogTimeout,
    WorkflowError,
)

logger = logging.getLogger(__name__)

TRANSIENT = "transient"
PERMANENT = "permanent"

#: exception types that always retry
_TRANSIENT_TYPES = (TransientDeviceError, TimeoutError, ConnectionError, BrokenPipeError, InterruptedError)

#: exception types that never retry: retrying corrupt data, a bad
#: description or an absent card only burns the deadline
_PERMANENT_TYPES = (
    MetadataError,
    PipelineError,
    JobDescriptionError,
    RegistryError,
    WorkflowError,
    NotSupportedError,
    DeviceError,
    BuildError,
    ValueError,
    TypeError,
    KeyError,
    AssertionError,
)

#: runtime error messages that signal a flaky device rather than a bug
_TRANSIENT_PATTERNS = (
    "unavailable",
    "deadline_exceeded",
    "deadline exceeded",
    "resource_exhausted",
    "resource exhausted",
    "out of memory",
    "device halted",
    "device lost",
    "relay",
    "connection reset",
    "timed out",
    "socket closed",
    "failed to connect",
)


def classify(exc: BaseException) -> str:
    """``transient`` (worth retrying) or ``permanent`` (fail fast).
    Unknown errors are permanent: retrying a bug hides it behind sleeps,
    and a misclassified transient still gets a second chance on
    ``resume``."""
    if isinstance(exc, FaultInjected):
        return TRANSIENT if exc.transient else PERMANENT
    if isinstance(exc, _TRANSIENT_TYPES):
        return TRANSIENT
    if isinstance(exc, _PERMANENT_TYPES):
        return PERMANENT
    if isinstance(exc, (OSError, MemoryError)):
        return TRANSIENT  # an IO flake, or memory pressure
    msg = str(exc).lower()
    if any(p in msg for p in _TRANSIENT_PATTERNS):
        return TRANSIENT
    return PERMANENT


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic seeded jitter and a
    deadline; ``max_attempts`` counts all tries (1 = no retry)."""

    max_attempts: int = 3
    base_delay: float = 0.25
    max_delay: float = 8.0
    jitter: float = 0.25
    deadline: float | None = None
    seed: int = 0

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        d = min(self.max_delay, self.base_delay * (2.0 ** (attempt - 1)))
        if self.jitter > 0 and d > 0:
            r = random.Random(f"{self.seed}:{attempt}").uniform(-1.0, 1.0)
            d = max(0.0, d * (1.0 + self.jitter * r))
        return d


@dataclasses.dataclass
class RetryOutcome:
    value: Any = None
    error: BaseException | None = None
    attempts: int = 0
    classification: str = PERMANENT

    @property
    def ok(self) -> bool:
        return self.error is None


def retry_call(
    fn: Callable[[], Any],
    policy: RetryPolicy,
    describe: str = "call",
    sleep: Callable[[float], None] = time.sleep,
) -> RetryOutcome:
    """Run ``fn`` under the policy.  Never raises: the outcome carries the
    value, or the last exception and its classification."""
    t0 = time.monotonic()
    last: BaseException | None = None
    cls = PERMANENT
    attempt = 0
    for attempt in range(1, max(1, policy.max_attempts) + 1):
        try:
            return RetryOutcome(value=fn(), attempts=attempt)
        except FaultInjected as e:
            if e.fatal:
                raise  # simulated process death: nothing may absorb it
            last, cls = e, classify(e)
        except Exception as e:
            last, cls = e, classify(e)
        if cls is PERMANENT:
            logger.warning("%s failed permanently (%s: %s) — not retrying",
                           describe, type(last).__name__, last)
            break
        if attempt >= policy.max_attempts:
            break
        pause = policy.delay(attempt)
        if policy.deadline is not None and time.monotonic() - t0 + pause > policy.deadline:
            logger.warning("%s: retry deadline (%.1fs) exhausted", describe, policy.deadline)
            break
        logger.warning("%s failed (%s: %s) — retry %d/%d in %.2fs", describe,
                       type(last).__name__, last, attempt, policy.max_attempts - 1, pause)
        telemetry.get_registry().counter("tmx_retry_attempts_total").inc()
        sleep(pause)
    return RetryOutcome(error=last, attempts=attempt, classification=cls)


def call_with_timeout(fn: Callable[[], Any], timeout: float,
                      describe: str = "call") -> Any:
    """Run ``fn`` on a daemon thread; :class:`ProbeTimeoutError` if it
    does not answer in time.  This is how a *hanging* dependency (a
    lost device never errors, it just stops answering) is converted into
    an exception the classifier and breaker can act on.  The runaway
    thread is abandoned — acceptable for probes, do not use for work
    holding locks."""
    box: dict[str, Any] = {}

    def target():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — relayed to caller
            box["error"] = e

    t = threading.Thread(target=target, daemon=True,
                         name=f"timeout:{describe}")
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise ProbeTimeoutError(
            f"{describe} did not answer within {timeout:.1f}s"
        )
    if "error" in box:
        raise box["error"]
    return box.get("value")


class CircuitBreaker:
    """Consecutive-failure breaker with doubling cooldown.

    CLOSED → normal.  After ``failure_threshold`` consecutive failures
    the circuit OPENs: ``allow()`` is False until ``cooldown`` elapses,
    then one half-open probe is allowed; another failure re-opens with
    the cooldown doubled (capped), a success closes it.
    """

    def __init__(self, failure_threshold: int = 3, cooldown: float = 30.0,
                 max_cooldown: float = 600.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = max(1, failure_threshold)
        self.base_cooldown = cooldown
        self.max_cooldown = max_cooldown
        self._clock = clock
        self.failures = 0
        self.opened_at: float | None = None
        self.cooldown = cooldown

    @property
    def state(self) -> str:
        if self.opened_at is None:
            return "closed"
        if self._clock() - self.opened_at >= self.cooldown:
            return "half-open"
        return "open"

    def allow(self) -> bool:
        return self.state != "open"

    def record_success(self) -> None:
        if self.opened_at is not None:
            telemetry.get_registry().counter(
                "tmx_breaker_transitions_total", to="closed"
            ).inc()
        self.failures = 0
        self.opened_at = None
        self.cooldown = self.base_cooldown

    def record_failure(self) -> None:
        self.failures += 1
        if self.opened_at is not None:
            # a failed half-open probe: re-open and back off harder
            self.cooldown = min(self.max_cooldown, self.cooldown * 2.0)
            self.opened_at = self._clock()
            telemetry.get_registry().counter(
                "tmx_breaker_transitions_total", to="open"
            ).inc()
        elif self.failures >= self.failure_threshold:
            self.opened_at = self._clock()
            telemetry.get_registry().counter(
                "tmx_breaker_transitions_total", to="open"
            ).inc()


# ---------------------------------------------------------------------------
# preemption drain: SIGTERM/SIGINT → stop admitting batches, drain, resume

#: pinned exit code for a drained preemption (EX_TEMPFAIL): schedulers and
#: wrapper scripts key on it to re-launch with ``tmx workflow resume``;
#: distinct from the fault harness's injected hard-kill code (41)
EXIT_PREEMPTED = 75

#: process-wide drain request; an Event (not a bool) so executor worker
#: threads and the engine thread observe one coherent flag
_PREEMPT = threading.Event()
_PREEMPT_REASON: list[str] = []


def request_preemption(reason: str = "signal") -> None:
    """Ask the running workflow to drain and stop at the next batch
    boundary.  Safe from signal handlers and any thread; idempotent."""
    if not _PREEMPT.is_set():
        _PREEMPT_REASON.append(reason)
        _PREEMPT.set()
        logger.warning(
            "preemption requested (%s) — the engine will stop admitting "
            "new batches, drain in-flight work and exit resumably", reason,
        )


def preemption_requested() -> bool:
    """Zero-cost poll the engine runs at batch boundaries."""
    return _PREEMPT.is_set()


def preemption_reason() -> str:
    """What tripped the drain flag (a signal name, or ``signal``)."""
    return _PREEMPT_REASON[-1] if _PREEMPT_REASON else "signal"


def clear_preemption() -> None:
    """Reset the drain flag (tests; a real resume is a fresh process)."""
    _PREEMPT.clear()
    _PREEMPT_REASON.clear()


def install_preemption_handlers(
    signals: tuple[int, ...] = (_signal.SIGTERM, _signal.SIGINT),
) -> Callable[[], None]:
    """Install drain-on-signal handlers (main thread only — the CLI's
    ``workflow submit``/``resume`` path).  The first signal requests a
    graceful drain; further signals are absorbed while the drain runs
    (SIGKILL remains the force-quit).  Returns a ``restore()`` callable
    reinstating the previous handlers."""

    def _handler(signum, frame):  # noqa: ARG001 — signal API shape
        request_preemption(reason=_signal.Signals(signum).name)

    previous = {}
    for sig in signals:
        previous[sig] = _signal.signal(sig, _handler)

    def restore() -> None:
        for sig, old in previous.items():
            _signal.signal(sig, old)

    return restore


# ---------------------------------------------------------------------------
# phase watchdog: deadlines over the pipelined launch/block/persist phases


class PhaseWatchdog:
    """Monitor thread arming per-phase deadlines.

    The executor wraps each pipelined phase in :meth:`arm`; a monitor
    thread (started lazily on the first arm, so a watchdog that never
    arms never spawns a thread) scans the armed set on a poll period
    derived from the tightest deadline.  When a phase overruns:

    - ``tmx_watchdog_fired_total`` is incremented (step + phase labels),
    - the fire is queued for the engine thread to append as a
      ``watchdog`` ledger event (only the engine thread touches the
      ledger — thread discipline from DESIGN.md §13),
    - ``on_fire``, when given, is invoked (the reference wires its
      device guard's breaker there; the port has no guard),
    - and when the hung call eventually returns *successfully*, the
      arm's context manager raises :class:`WatchdogTimeout` — a
      transient classification, so the batch retries/quarantines like
      any other device flake instead of silently passing after minutes
      of hang.  A phase that raised its own error propagates that error
      untouched.

    The monitor cannot unstick a hung thread (no thread can, in
    Python); it converts the hang into *evidence* and lets the breaker,
    quarantine and resume machinery do what they already do.
    """

    def __init__(self, deadlines: dict[str, float],
                 on_fire: Callable[..., None] | None = None,
                 poll: float | None = None):
        self.deadlines = {str(k): float(v) for k, v in deadlines.items()
                          if v and float(v) > 0}
        self.on_fire = on_fire
        tightest = min(self.deadlines.values(), default=1.0)
        self.poll = float(poll) if poll else max(0.05, tightest / 4.0)
        self._lock = threading.Lock()
        self._armed: dict[int, dict[str, Any]] = {}
        self._pending_events: list[dict[str, Any]] = []
        self._next_token = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.fired_total = 0

    # ------------------------------------------------------------ arming
    @contextlib.contextmanager
    def arm(self, phase: str, step: str = "",
            batch: int | None = None) -> Iterator[None]:
        deadline = self.deadlines.get(phase)
        if deadline is None:
            yield
            return
        self._ensure_thread()
        with self._lock:
            token = self._next_token
            self._next_token += 1
            self._armed[token] = {
                "phase": phase, "step": step, "batch": batch,
                "t0": time.monotonic(),
                "deadline": time.monotonic() + deadline,
                "budget": deadline, "fired": False,
            }
        try:
            yield
        except BaseException:
            with self._lock:
                self._armed.pop(token, None)
            raise
        with self._lock:
            entry = self._armed.pop(token)
        if entry["fired"]:
            elapsed = time.monotonic() - entry["t0"]
            raise WatchdogTimeout(
                f"{phase} phase of step '{step}' batch {batch} overran its "
                f"{entry['budget']:.1f}s watchdog deadline "
                f"(took {elapsed:.1f}s)"
            )

    # ----------------------------------------------------------- monitor
    def _ensure_thread(self) -> None:
        if self._thread is None:
            with self._lock:
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._run, name="tmx-watchdog", daemon=True
                    )
                    self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.poll):
            now = time.monotonic()
            fired: list[dict[str, Any]] = []
            with self._lock:
                for entry in self._armed.values():
                    if not entry["fired"] and now >= entry["deadline"]:
                        entry["fired"] = True
                        fired.append(dict(entry))
            for entry in fired:
                self._note_fire(entry)

    def _note_fire(self, entry: dict[str, Any]) -> None:
        self.fired_total += 1
        elapsed = time.monotonic() - entry["t0"]
        logger.error(
            "watchdog: %s phase of step '%s' batch %s exceeded its %.1fs "
            "deadline (%.1fs so far) — classifying as a transient device "
            "hang", entry["phase"], entry["step"], entry["batch"],
            entry["budget"], elapsed,
        )
        telemetry.get_registry().counter(
            "tmx_watchdog_fired_total",
            step=str(entry["step"] or "unknown"), phase=entry["phase"],
        ).inc()
        with self._lock:
            self._pending_events.append({
                "event": "watchdog", "phase": entry["phase"],
                "batch": entry["batch"],
                "budget_s": entry["budget"],
                "elapsed_s": round(elapsed, 3),
            })
        if self.on_fire is not None:
            try:
                self.on_fire(phase=entry["phase"], step=entry["step"],
                             batch=entry["batch"])
            except Exception:  # pragma: no cover — defensive
                logger.debug("watchdog on_fire hook failed", exc_info=True)

    def drain_events(self) -> list[dict[str, Any]]:
        """Queued ``watchdog`` ledger events, consumed by the engine
        thread (the only thread allowed to append to the ledger)."""
        with self._lock:
            out, self._pending_events = self._pending_events, []
        return out

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None


class LeaseRenewer:
    """Background renewal loop for time-bounded claims (fleet spool
    leases, DESIGN.md §25).

    The serve daemon's main loop blocks for the whole duration of a job
    execution, which can be minutes — far past any sane lease.  This
    thread keeps the daemon's claims (and its heartbeat) fresh while the
    main thread works: every ``period`` seconds it invokes ``renew``,
    which must be safe to call from a non-engine thread (claim files and
    heartbeats are plain ``atomicio`` writes; the ledger is never touched
    here — thread discipline from DESIGN.md §13).

    A renewal that raises is *counted and skipped*, never propagated: a
    transient IO flake must not kill the renewer, because a dead renewer
    turns into an expired lease and a spurious reclaim.  The failure
    count is observable for tests and post-mortems.  ``renew_now`` runs
    one synchronous renewal for deterministic tests.
    """

    def __init__(self, renew: Callable[[], None], period: float):
        self.renew = renew
        self.period = max(0.05, float(period))
        self.failures = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="tmx-lease-renewer", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            self.renew_now()

    def renew_now(self) -> bool:
        """One renewal pass; returns False (and counts) on failure."""
        try:
            self.renew()
            return True
        except Exception:
            self.failures += 1
            logger.warning("lease renewal failed (%d so far)",
                           self.failures, exc_info=True)
            return False

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None


def watchdog_enabled() -> bool:
    """Master gate: ``TMX_WATCHDOG`` env beats the install config
    (``TM_WATCHDOG`` / INI ``watchdog``); off by default, and off means
    genuinely zero-cost — no thread, no arming, no events."""
    env = os.environ.get("TMX_WATCHDOG")
    if env is not None:
        return env.lower() in ("1", "true", "yes")
    return bool(cfg.watchdog)


def watchdog_from_config(
    on_fire: Callable[..., None] | None = None,
) -> PhaseWatchdog | None:
    """Build the configured watchdog, or ``None`` when disabled.

    Per-phase deadlines: ``TMX_WATCHDOG_LAUNCH_S`` /
    ``TMX_WATCHDOG_BLOCK_S`` / ``TMX_WATCHDOG_PERSIST_S`` env knobs beat
    the ``watchdog_*_s`` config fields; a deadline of 0 disarms that
    phase.  Defaults are deliberately generous (minutes, not seconds) —
    the watchdog exists to catch *wedged* calls, not slow ones."""
    if not watchdog_enabled():
        return None

    deadlines: dict[str, float] = {}
    for phase, attr in (("launch", "watchdog_launch_s"),
                        ("block", "watchdog_block_s"),
                        ("persist", "watchdog_persist_s")):
        env = os.environ.get(f"TMX_WATCHDOG_{phase.upper()}_S")
        try:
            val = float(env) if env is not None else float(
                getattr(cfg, attr, 0) or 0
            )
        except ValueError:
            val = 0.0
        if val > 0:
            deadlines[phase] = val
    if not deadlines:
        return None
    return PhaseWatchdog(deadlines, on_fire=on_fire)


@dataclasses.dataclass
class ResilienceConfig:
    """The engine's fault-tolerance knobs.

    ``max_batch_failures``: below 1 a fraction of the step's batches, from
    1 up an absolute count; a step fails only once its quarantined
    batches exceed it.  ``qc_flag_budget``: the fraction of a step's
    planned sites QC may flag before the engine records
    ``qc_budget_exceeded`` (a warning, never a failure)."""

    policy: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    max_batch_failures: float = 0.5
    enabled: bool = True
    qc_flag_budget: float = 0.5

    def failure_budget(self, n_batches: int) -> int:
        if self.max_batch_failures < 1.0:
            return int(self.max_batch_failures * n_batches)
        return int(self.max_batch_failures)

    @classmethod
    def from_library_config(cls, cfg: LibraryConfig | None = None) -> "ResilienceConfig":
        cfg = cfg if cfg is not None else LibraryConfig()
        return cls(
            policy=RetryPolicy(max_attempts=cfg.retry_attempts,
                               base_delay=cfg.retry_base_delay),
            max_batch_failures=cfg.max_batch_failures,
            qc_flag_budget=cfg.qc_flag_budget,
        )
