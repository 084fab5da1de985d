"""The install settings the port's workflow engine reads.

Counterpart: ``tmlibrary_tpu/config.py`` ``LibraryConfig``, of which the
port keeps the fields its engine and its serving plane read, under the
same names and defaults: ``storage_home`` (with
:meth:`LibraryConfig.experiment_location`), ``ledger_fsync``, the fault-tolerance knobs
(``retry_attempts``, ``retry_base_delay``, ``max_batch_failures``,
``qc_flag_budget``), the phase watchdog (``watchdog``,
``watchdog_{launch,block,persist}_s``), telemetry (``telemetry``,
``resource_sample_period``), the serve daemon (``serve_*``), the time
series store (``tsdb_*``) and the objectives (``slo_*``).  Each comes, as
in the reference (``:21-60``), from
the ``TM_<NAME>`` environment variable, else the ``[tmlibrary]`` section
of the INI file ``$TM_CONFIG_FILE`` (default ``~/.tmlibrary.cfg``, read
by :mod:`configparser` without interpolation), else its default.  A
malformed file warns and reads as empty.

The reference builds its module-level ``cfg`` once at import; the port's
:data:`cfg` reads the settings anew at each attribute access, so an
environment variable set after import (a test, a CLI flag written into
the environment) takes effect.  The runtime ``TMX_*`` overrides stay
where the reference reads them (``resilience.watchdog_enabled``,
``slo``, the CLI).
"""

from __future__ import annotations

import configparser
import dataclasses
import functools
import os
import warnings
from pathlib import Path


def _ini_values() -> dict:
    """The ``[tmlibrary]`` section of the INI file, if there is one;
    parsed once per (path, modification time)."""
    path = os.environ.get("TM_CONFIG_FILE", os.path.expanduser("~/.tmlibrary.cfg"))
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        return {}
    return _parse_ini(path, mtime)


@functools.lru_cache(maxsize=8)
def _parse_ini(path: str, _mtime_ns: int) -> dict:
    # no interpolation: '%' is common in paths and date patterns
    parser = configparser.ConfigParser(interpolation=None)
    try:
        parser.read(path)
        if not parser.has_section("tmlibrary"):
            return {}
        return dict(parser.items("tmlibrary"))
    except configparser.Error as exc:
        warnings.warn(f"ignoring malformed config file {path}: {exc}")
        return {}


def setting(name: str, default: str) -> str:
    """One install-level setting: ``TM_<NAME>`` beats the INI file beats
    ``default``."""
    env = os.environ.get(f"TM_{name.upper()}")
    if env is not None:
        return env
    return _ini_values().get(name, default)


def _flag(name: str, default: str) -> bool:
    return setting(name, default).lower() in ("1", "true", "yes")


@dataclasses.dataclass
class LibraryConfig:
    """The engine's settings, read when built."""

    #: root directory under which experiment stores live (reference
    #: analogue: ``tmaps.cfg`` ``storage_home``)
    storage_home: Path = dataclasses.field(
        default_factory=lambda: Path(setting("storage_home",
                                             os.path.expanduser("~/tm_storage"))))
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
    # --------------------------------------------------- phase watchdog
    #: watchdog master switch (resilience.PhaseWatchdog); TMX_WATCHDOG
    #: beats it.  Off means no monitor thread, no arming, no events
    watchdog: bool = dataclasses.field(
        default_factory=lambda: _flag("watchdog", "0"))
    #: per-phase deadlines in seconds (0 disarms a phase); generous on
    #: purpose: they catch wedged calls, not slow ones
    watchdog_launch_s: float = dataclasses.field(
        default_factory=lambda: float(setting("watchdog_launch_s", "300")))
    watchdog_block_s: float = dataclasses.field(
        default_factory=lambda: float(setting("watchdog_block_s", "600")))
    watchdog_persist_s: float = dataclasses.field(
        default_factory=lambda: float(setting("watchdog_persist_s", "600")))
    # -------------------------------------------------------- telemetry
    #: master switch for the metrics registry and span tracing
    telemetry: bool = dataclasses.field(
        default_factory=lambda: _flag("telemetry", "1"))
    #: resource sampler period in seconds (0 disables the thread)
    resource_sample_period: float = dataclasses.field(
        default_factory=lambda: float(setting("resource_sample_period", "5")))
    # ---------------------------------------------------------- serving
    #: admission high watermark: at this depth new jobs are shed
    serve_max_queue: int = dataclasses.field(
        default_factory=lambda: int(setting("serve_max_queue", "64")))
    #: low watermark the shedding hysteresis re-admits below; 0 = max/2
    serve_low_watermark: int = dataclasses.field(
        default_factory=lambda: int(setting("serve_low_watermark", "0")))
    #: per-tenant cap on queued jobs
    serve_tenant_quota: int = dataclasses.field(
        default_factory=lambda: int(setting("serve_tenant_quota", "16")))
    #: per-tenant retry budget (a resubmission spends one token, a
    #: success refunds one)
    serve_retry_budget: int = dataclasses.field(
        default_factory=lambda: int(setting("serve_retry_budget", "8")))
    #: spool poll period of the serve daemon, seconds
    serve_poll_s: float = dataclasses.field(
        default_factory=lambda: float(setting("serve_poll_s", "0.5")))
    #: admission-phase watchdog deadline, seconds (0 disarms)
    serve_admission_deadline_s: float = dataclasses.field(
        default_factory=lambda: float(setting("serve_admission_deadline_s", "60")))
    #: fuse concurrent query jobs over one store into one batched sweep
    serve_query_fusion: bool = dataclasses.field(
        default_factory=lambda: _flag("serve_query_fusion", "1"))
    #: most jobs folded into one fused query sweep
    serve_fusion_window: int = dataclasses.field(
        default_factory=lambda: int(setting("serve_fusion_window", "8")))
    #: fleet lease, seconds: how long a claim stays valid unrenewed
    serve_lease_s: float = dataclasses.field(
        default_factory=lambda: float(setting("serve_lease_s", "15")))
    #: canary probe period, seconds; 0 disables probes
    serve_canary_period_s: float = dataclasses.field(
        default_factory=lambda: float(setting("serve_canary_period_s", "0")))
    #: how often the daemon re-runs the anomaly detector
    serve_anomaly_check_s: float = dataclasses.field(
        default_factory=lambda: float(setting("serve_anomaly_check_s", "5")))
    # ------------------------------------------------------ time series
    #: least seconds between flushes of a live snapshot into the tsdb
    tsdb_flush_s: float = dataclasses.field(
        default_factory=lambda: float(setting("tsdb_flush_s", "10")))
    #: raw samples older than this are dropped at compaction
    tsdb_retention_s: float = dataclasses.field(
        default_factory=lambda: float(setting("tsdb_retention_s", "86400")))
    #: segment size that triggers a compaction pass
    tsdb_segment_bytes: int = dataclasses.field(
        default_factory=lambda: int(setting("tsdb_segment_bytes", "1048576")))
    # -------------------------------------------------------------- SLO
    #: per-tenant p95 job latency objective, seconds
    slo_latency_p95_s: float = dataclasses.field(
        default_factory=lambda: float(setting("slo_latency_p95_s", "600")))
    #: per-tenant availability objective (fraction of jobs ok)
    slo_availability: float = dataclasses.field(
        default_factory=lambda: float(setting("slo_availability", "0.99")))
    #: comma-separated burn-rate windows, seconds
    slo_windows: str = dataclasses.field(
        default_factory=lambda: setting("slo_windows", "3600,21600"))

    def experiment_location(self, experiment_name: str) -> Path:
        """The store directory of ``experiment_name`` under ``storage_home``."""
        return Path(self.storage_home) / "experiments" / experiment_name


class _LiveConfig:
    """The settings read anew at each attribute access."""

    def __getattr__(self, name: str):
        return getattr(LibraryConfig(), name)


#: the settings as the reference's module-level ``cfg`` offers them
cfg = _LiveConfig()
