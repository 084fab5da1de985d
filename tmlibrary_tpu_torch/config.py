"""The install settings the port's workflow engine reads.

Counterpart: ``tmlibrary_tpu/config.py`` ``LibraryConfig``, of which the
port keeps only the fields its engine uses, under the same names and
defaults: ``ledger_fsync`` and the fault-tolerance knobs
(``retry_attempts``, ``retry_base_delay``, ``max_batch_failures``,
``qc_flag_budget``).  Each comes, as in the reference (``:21-60``), from
the ``TM_<NAME>`` environment variable, else the ``[tmlibrary]`` section
of the INI file ``$TM_CONFIG_FILE`` (default ``~/.tmlibrary.cfg``, read
by :mod:`configparser` without interpolation), else its default.  A
malformed file warns and reads as empty.
"""

from __future__ import annotations

import configparser
import dataclasses
import functools
import os
import warnings


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


@dataclasses.dataclass
class LibraryConfig:
    """The engine's settings, read when built."""

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
