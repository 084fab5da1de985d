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

The reference's ``DeviceHealthGuard`` pins the backend to the CPU when
device probes fail; that fallback hides the card and is not ported: a
dead card raises.  Its circuit breaker, preemption drain and phase
watchdog are not ported either (ROADMAP A item 11).
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Any, Callable

from tmlibrary_tpu_torch.config import LibraryConfig
from tmlibrary_tpu_torch.errors import (
    BuildError,
    DeviceError,
    JobDescriptionError,
    MetadataError,
    NotSupportedError,
    PipelineError,
    RegistryError,
    WorkflowError,
)

logger = logging.getLogger(__name__)

TRANSIENT = "transient"
PERMANENT = "permanent"

#: exception types that always retry
_TRANSIENT_TYPES = (TimeoutError, ConnectionError, BrokenPipeError, InterruptedError)

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
        sleep(pause)
    return RetryOutcome(error=last, attempts=attempt, classification=cls)


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
