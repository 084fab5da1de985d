"""The install settings the port's workflow engine reads.

Counterpart: ``tmlibrary_tpu/config.py`` ``LibraryConfig``, of which the
port keeps only the fields its engine uses, under the same names and
defaults: ``ledger_fsync`` and the fault-tolerance knobs
(``retry_attempts``, ``retry_base_delay``, ``max_batch_failures``,
``qc_flag_budget``).  Each comes from the ``TM_<NAME>`` environment
variable, else its default; the port reads no INI file.
"""

from __future__ import annotations

import dataclasses
import os


def setting(name: str, default: str) -> str:
    """One install-level setting: ``TM_<NAME>``, else ``default``."""
    return os.environ.get(f"TM_{name.upper()}", default)


@dataclasses.dataclass
class LibraryConfig:
    """The engine's settings, read from the environment when built."""

    #: total tries per batch (1 = no retry) for transient faults
    retry_attempts: int = dataclasses.field(
        default_factory=lambda: int(setting("retry_attempts", "3")))
    #: first backoff delay in seconds (doubles per retry, jittered)
    retry_base_delay: float = dataclasses.field(
        default_factory=lambda: float(setting("retry_base_delay", "0.25")))
    #: quarantine budget: < 1 a fraction of a step's batches, >= 1 a count
    max_batch_failures: float = dataclasses.field(
        default_factory=lambda: float(setting("max_batch_failures", "0.5")))
    #: fsync every ledger append (crash-durable, one fsync per event)
    ledger_fsync: bool = dataclasses.field(
        default_factory=lambda: setting("ledger_fsync", "0").lower() in ("1", "true", "yes"))
    #: fraction of a step's sites QC may flag before a warning event
    qc_flag_budget: float = dataclasses.field(
        default_factory=lambda: float(setting("qc_flag_budget", "0.5")))
