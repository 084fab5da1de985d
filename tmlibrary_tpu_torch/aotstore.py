"""Process-level cold/warm accounting of compiled programs.

Counterpart: ``tmlibrary_tpu/aotstore.py``, of which the port keeps the
process-level counters the serve daemon reads: :func:`set_process_default_dir`,
:func:`note_cold`, :func:`counts_snapshot`, :func:`seconds_saved`,
:func:`warm_digests` and :func:`store_stats`, with the reference's
``tmx_compile_cold_total`` counter.

The reference serialises XLA executables into an on-disk store a fleet
shares; the port has no serialised executables (its kernels are one
shared library built from the checkout, its pipelines plain PyTorch), so
``export_entry``, ``import_entry``, ``list_entries`` and ``prune`` are
not here, the store is always empty and nothing is ever imported or
warm, so the reference's ``note_warm`` and its store-directory
resolution (``TMX_AOT_STORE_DIR``, ``~/.cache``) have nothing to do and
are left out: :func:`store_stats` reports the directory it is given, else
the one the serve daemon set.  Here
"cold" means the first time something ran in this process: the first
build or load of a kernel library (``ops/_cuda.py``, ``native.py``), and
the first batch of each program digest (the jterator step's description
digest and capacity).  A later run of the same digest in the process is
neither cold nor warm, as a hit of the reference's in-memory cache is.
:func:`warm_digests` lists the digests this process has run, most
recent first.  The reference's ``enable_compilation_cache`` (JAX's
persistent compilation cache) has no PyTorch counterpart and is left out.
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()
#: process-default directory (the serve daemon points it at its root)
_PROCESS_DEFAULT_DIR: str | None = None
#: process-wide tallies by kind (only ``cold`` in the port)
_COUNTS: dict = {}
#: program digests run in this process, most recent last
_SEEN: dict[str, None] = {}


def set_process_default_dir(directory: str | None) -> None:
    """Set the process-default store directory (the serve daemon calls
    this with ``<serve_root>/aotstore``)."""
    global _PROCESS_DEFAULT_DIR
    with _LOCK:
        _PROCESS_DEFAULT_DIR = str(directory) if directory else None


def note_cold(program: str | None = None) -> None:
    """Something was built or ran for the first time in this process:
    bump the tally and ``tmx_compile_cold_total``."""
    from tmlibrary_tpu_torch import telemetry

    with _LOCK:
        _COUNTS["cold"] = _COUNTS.get("cold", 0.0) + 1.0
    if telemetry.enabled():
        labels = {"program": str(program)} if program else {}
        telemetry.get_registry().counter("tmx_compile_cold_total", **labels).inc()


def note_program(program: str) -> bool:
    """Record a run of ``program``; the first one in this process counts
    cold.  Returns whether it was cold."""
    with _LOCK:
        cold = program not in _SEEN
        _SEEN.pop(program, None)
        _SEEN[program] = None
    if cold:
        note_cold(program)
    return cold


def seconds_saved() -> float:
    """Compile seconds avoided by imports so far: always 0 in the port,
    which imports nothing."""
    return 0.0


def counts_snapshot() -> dict:
    """Process-wide cold/warm tallies, for per-job deltas."""
    with _LOCK:
        return dict(_COUNTS)


def reset_counts() -> None:
    """Zero the tallies and forget the programs run (tests)."""
    with _LOCK:
        _COUNTS.clear()
        _SEEN.clear()


def warm_digests(directory: str | None = None, limit: int = 64) -> list[str]:
    """The program digests this process has run, most recent first."""
    with _LOCK:
        return list(reversed(list(_SEEN)))[:limit]


def store_stats(directory: str | None = None) -> dict:
    """The reference's one-line store summary; the port's store holds no
    entries.  ``dir`` is ``directory``, else the process default, else
    None."""
    with _LOCK:
        default = _PROCESS_DEFAULT_DIR
    return {
        "dir": str(directory) if directory else default,
        "enabled": False,
        "entries": 0,
        "total_bytes": 0,
        "stale_entries": 0,
        "fingerprint": None,
        "seconds_saved": round(seconds_saved(), 4),
    }
