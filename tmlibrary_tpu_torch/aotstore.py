"""Content-addressed store of built kernel libraries (cold-start plane).

Counterpart: ``tmlibrary_tpu/aotstore.py``.  The reference serialises
XLA executables into an on-disk store that the next process, or another
host of a fleet, imports instead of compiling.  In the port the compiled
artifacts are the shared libraries built from the checkout: the CUDA
kernels (``ops/_cuda.build()``, ``build/kernels/libtmtorch_<digest>.so``,
``nvcc`` for ``sm_90a``) and the host library (``native.build()``).
Before either build runs its compiler it tries :func:`import_entry`;
after a build it calls :func:`export_entry` (the reference's names; they
take and give a library file where the reference's take and give a
compiled executable).  An import copies the
stored library into the build directory and counts
``tmx_compile_import_hit_total`` and the build seconds it saved
(``tmx_compile_seconds_saved_total``).

Keying contract, as the reference's (a stale artifact is never found):

- the entry digest hashes the program (``cuda_kernels`` or
  ``host_library``), capacity and strategy (None for a library), the
  signature (the digest of the library's sources and flags, so a
  library built from other sources is never found) and the fingerprint;
- the fingerprint (:func:`fingerprint_info`) of the CUDA kernels is
  torch's version, the CUDA runtime's version and the arch
  (``sm_90a``); the host library's is the machine and the operating
  system, no CUDA fact.  Neither names the compiler or the card count:
  a host without ``nvcc`` imports what a host with it built, and a
  process of any number of cards finds the same library.  The
  fingerprint is re-checked from the meta sidecar at import, and a
  mismatch refuses loudly (a warning) before the caller builds; so does
  a payload whose SHA-256 is not the one recorded, which is deleted.

Layout (``TMX_AOT_STORE_DIR`` > the ``aot_store_dir`` setting > the
process default, which the serve daemon points at its root >
``~/.cache/tmlibrary_tpu_torch/aot``)::

    <dir>/<digest>.bin    the library's bytes
    <dir>/<digest>.json   the reference's meta keys (digest, program,
                          step, capacity, strategy, signature,
                          fingerprint, fingerprint_info, size_bytes,
                          compile_s, created_at_unix, last_used_unix)
                          and payload_sha256

Writes are a temporary file and ``os.replace``.  The store is on unless
``TMX_AOT_STORE`` (or the ``aot_store`` setting) says ``0``/``false``/
``no``/``off``; :func:`prune` keeps it under :func:`max_store_bytes`
after each export; ``tmx-torch cache list|gc`` is the operator's view.

Process accounting, as the reference's: ``note_cold`` (a library built
or loaded for the first time in the process, or the first batch of a
program digest, :func:`note_program`), ``note_warm`` and the tallies of
:func:`counts_snapshot`.  The reference's ``speculation_enabled`` and
its executable serialisation have nothing to act on in the port.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import platform
import shutil
import threading
import time
from pathlib import Path
from typing import Any

from tmlibrary_tpu_torch.atomicio import atomic_write_text

logger = logging.getLogger(__name__)

#: env toggle (beats the setting): "0"/"false"/"no"/"off" turns the store off
ENV_ENABLE = "TMX_AOT_STORE"
#: env override of the store directory
ENV_DIR = "TMX_AOT_STORE_DIR"
_FALSE_VALUES = ("0", "false", "no", "off")
#: default LRU cap on the payload bytes (1 GiB)
DEFAULT_MAX_BYTES = 1 << 30
#: the arch every kernel library is built for (``ops/_cuda.NVCC_FLAGS``)
ARCH = "sm_90a"

_LOCK = threading.Lock()
_PROCESS_DEFAULT_DIR: str | None = None
#: build seconds avoided by imports so far (process-wide)
_SECONDS_SAVED = 0.0
#: process-wide tallies by kind (cold/warm/import_hit/export)
_COUNTS: dict = {}
#: program digests run in this process, most recent last
_SEEN: dict[str, None] = {}


def _setting(name: str, default: str) -> str:
    from tmlibrary_tpu_torch import config

    return config.setting(name, default)


def enabled() -> bool:
    """Whether the store is on: ``TMX_AOT_STORE`` beats the ``aot_store``
    setting; on by default (the tests' conftest turns it off)."""
    env = os.environ.get(ENV_ENABLE)
    if env is None:
        env = _setting("aot_store", "1")
    return str(env).strip().lower() not in _FALSE_VALUES


def set_process_default_dir(directory: str | None) -> None:
    """Set the process-default store directory (the serve daemon calls
    this with ``<serve_root>/aotstore``, so a fleet shares one store)."""
    global _PROCESS_DEFAULT_DIR
    with _LOCK:
        _PROCESS_DEFAULT_DIR = str(directory) if directory else None


def store_dir(directory: str | None = None) -> str:
    """The store directory: ``directory`` > ``TMX_AOT_STORE_DIR`` > the
    ``aot_store_dir`` setting > the process default >
    ``~/.cache/tmlibrary_tpu_torch/aot``."""
    if directory:
        return str(directory)
    env = os.environ.get(ENV_DIR)
    if env:
        return env
    configured = _setting("aot_store_dir", "")
    if configured:
        return str(configured)
    with _LOCK:
        if _PROCESS_DEFAULT_DIR:
            return _PROCESS_DEFAULT_DIR
    return os.path.expanduser("~/.cache/tmlibrary_tpu_torch/aot")


def max_store_bytes() -> int:
    """LRU cap on the payload bytes (``TMX_AOT_STORE_MAX_BYTES`` /
    ``aot_store_max_bytes``; <= 0 means no cap)."""
    raw = os.environ.get("TMX_AOT_STORE_MAX_BYTES")
    if raw is None:
        raw = _setting("aot_store_max_bytes", str(DEFAULT_MAX_BYTES))
    try:
        return int(raw)
    except (TypeError, ValueError):
        return DEFAULT_MAX_BYTES


# ------------------------------------------------------------- identity
def fingerprint_info(program: str = "cuda_kernels") -> dict:
    """The facts the fingerprint of ``program``'s library digests: for the
    host library the machine and the operating system, for the CUDA
    kernels torch's and the CUDA runtime's versions and the arch."""
    if program == "host_library":
        return {"machine": platform.machine(), "system": platform.system()}
    import torch

    return {"torch": torch.__version__, "cuda": torch.version.cuda, "arch": ARCH}


def backend_fingerprint(info: dict | None = None) -> str:
    """Stable digest of a :func:`fingerprint_info` (the CUDA kernels' by
    default)."""
    info = info or fingerprint_info()
    blob = "|".join(f"{k}={info[k]}" for k in sorted(info))
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def _fingerprint(program: str) -> str:
    return backend_fingerprint(fingerprint_info(program))


def entry_digest(program: str, capacity: int | None, strategy: str | None,
                 signature: Any, fingerprint: str | None = None) -> str:
    """Content address of one entry, the reference's formula: program,
    capacity, strategy, signature and fingerprint."""
    fp = fingerprint or _fingerprint(program)
    blob = "|".join([str(program), str(capacity), str(strategy), repr(signature), fp])
    return hashlib.sha1(blob.encode()).hexdigest()


def _paths(digest: str, directory: str | None = None) -> tuple[str, str]:
    d = store_dir(directory)
    return os.path.join(d, digest + ".bin"), os.path.join(d, digest + ".json")


# ------------------------------------------------------------ telemetry
def _count(kind: str, program: str | None = None, amount: float = 1.0) -> None:
    """Bump the tally and ``tmx_compile_<kind>_total``."""
    from tmlibrary_tpu_torch import telemetry

    with _LOCK:
        _COUNTS[kind] = _COUNTS.get(kind, 0.0) + float(amount)
    if telemetry.enabled():
        labels = {"program": str(program)} if program else {}
        telemetry.get_registry().counter(f"tmx_compile_{kind}_total", **labels).inc(amount)


def note_cold(program: str | None = None) -> None:
    """Something was built or ran for the first time in this process."""
    _count("cold", program)


def note_warm(program: str | None = None) -> None:
    """A built artifact was waiting when first asked for."""
    _count("warm", program)


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


def _note_saved(seconds: float) -> None:
    global _SECONDS_SAVED
    from tmlibrary_tpu_torch import telemetry

    with _LOCK:
        _SECONDS_SAVED += float(seconds)
        total = _SECONDS_SAVED
    if telemetry.enabled():
        telemetry.get_registry().gauge("tmx_compile_seconds_saved_total").set(round(total, 4))


def seconds_saved() -> float:
    """Build seconds avoided by imports so far (process-wide)."""
    with _LOCK:
        return _SECONDS_SAVED


def reset_seconds_saved() -> None:
    global _SECONDS_SAVED
    with _LOCK:
        _SECONDS_SAVED = 0.0


def counts_snapshot() -> dict:
    """Process-wide cold/warm/import_hit/export tallies."""
    with _LOCK:
        return dict(_COUNTS)


def reset_counts() -> None:
    """Zero the tallies and forget the programs run (tests)."""
    with _LOCK:
        _COUNTS.clear()
        _SEEN.clear()


# ---------------------------------------------------------- export/import
def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def export_entry(library: "str | Path", *, program: str, signature: Any,
                   step: str = "build", capacity: int | None = None,
                   strategy: str | None = None, compile_s: float | None = None,
                   directory: str | None = None) -> str | None:
    """Copy a built library into the store; its digest, or None when the
    store is off.  An entry already there is kept as it is.  The write is
    atomic and the LRU cap is enforced after it."""
    if not enabled():
        return None
    info = fingerprint_info(program)
    fp = backend_fingerprint(info)
    digest = entry_digest(program, capacity, strategy, signature, fp)
    bin_path, meta_path = _paths(digest, directory)
    if os.path.exists(meta_path):
        return digest
    os.makedirs(os.path.dirname(bin_path), exist_ok=True)
    tmp = f"{bin_path}.{os.getpid()}.tmp"
    shutil.copyfile(library, tmp)
    os.replace(tmp, bin_path)
    now = time.time()
    atomic_write_text(meta_path, json.dumps({
        "digest": digest,
        "program": str(program),
        "step": str(step),
        "capacity": capacity,
        "strategy": strategy,
        "signature": repr(signature),
        "fingerprint": fp,
        "fingerprint_info": info,
        "size_bytes": os.path.getsize(bin_path),
        "payload_sha256": _sha256(bin_path),
        "compile_s": round(compile_s, 4) if compile_s else None,
        "created_at_unix": now,
        "last_used_unix": now,
    }, indent=2) + "\n")
    _count("export", program)
    prune(directory=directory)
    return digest


def _drop_entry(digest: str, directory: str | None = None) -> None:
    for path in _paths(digest, directory):
        try:
            os.remove(path)
        except OSError:
            pass


def import_entry(dest: "str | Path", *, program: str, signature: Any,
                   capacity: int | None = None, strategy: str | None = None,
                   directory: str | None = None) -> dict | None:
    """Copy the stored library of (program, signature) to ``dest``; its
    meta on a hit, None on a miss or with the store off.  A fingerprint
    that does not match this toolchain, or a payload whose SHA-256 is not
    the recorded one, refuses with a warning (the corrupt entry is
    deleted), and the caller builds."""
    if not enabled():
        return None
    fp = _fingerprint(program)
    digest = entry_digest(program, capacity, strategy, signature, fp)
    bin_path, meta_path = _paths(digest, directory)
    if not (os.path.exists(bin_path) and os.path.exists(meta_path)):
        return None
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, ValueError) as exc:
        logger.warning("aotstore: unreadable meta for %s (%s) — building", program, exc)
        return None
    if meta.get("fingerprint") != fp:
        logger.warning("aotstore: entry %s fingerprint %s does not match this toolchain "
                       "(%s) — refusing the stale library, building", digest[:12],
                       meta.get("fingerprint"), fp)
        return None
    if meta.get("payload_sha256") != _sha256(bin_path):
        logger.warning("aotstore: corrupt library %s for %s — deleting the entry and "
                       "building", digest[:12], program)
        _drop_entry(digest, directory)
        return None
    dest = Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_name(f"{dest.name}.{os.getpid()}.tmp")
    shutil.copyfile(bin_path, tmp)
    os.replace(tmp, dest)
    meta["last_used_unix"] = time.time()
    atomic_write_text(meta_path, json.dumps(meta, indent=2) + "\n")
    _count("import_hit", program)
    saved = meta.get("compile_s")
    if isinstance(saved, (int, float)) and saved > 0:
        _note_saved(float(saved))
    from tmlibrary_tpu_torch import perf

    perf.record_import(program=program, capacity=capacity, strategy=strategy,
                       saved_s=saved)
    return meta


# ------------------------------------------------------------ operations
def list_entries(directory: str | None = None) -> list[dict]:
    """Meta rows of every entry, most recently used first, each with
    ``age_s`` (since creation) and ``stale`` (its fingerprint is not this
    toolchain's: inert, since lookups digest the live fingerprint)."""
    d = store_dir(directory)
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return []
    fps = {}
    now = time.time()
    rows = []
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(d, name)) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(meta, dict) or "digest" not in meta:
            continue
        created = meta.get("created_at_unix")
        meta["age_s"] = round(now - created, 1) if isinstance(created, (int, float)) else None
        program = str(meta.get("program"))
        if program not in fps:
            fps[program] = _fingerprint(program)
        meta["stale"] = meta.get("fingerprint") != fps[program]
        rows.append(meta)
    rows.sort(key=lambda m: m.get("last_used_unix") or 0.0, reverse=True)
    return rows


def warm_digests(directory: str | None = None, limit: int = 64) -> list[str]:
    """The most recently used entry digests (what this host can warm a
    peer with)."""
    return [m["digest"] for m in list_entries(directory)[:limit]]


def store_stats(directory: str | None = None) -> dict:
    """One-line store summary for the status surfaces."""
    rows = list_entries(directory)
    return {
        "dir": store_dir(directory),
        "enabled": enabled(),
        "entries": len(rows),
        "total_bytes": sum(int(m.get("size_bytes") or 0) for m in rows),
        "stale_entries": sum(1 for m in rows if m.get("stale")),
        "fingerprint": backend_fingerprint(),
        "seconds_saved": round(seconds_saved(), 4),
    }


def prune(directory: str | None = None, max_bytes: int | None = None,
          max_age_s: float | None = None, drop_stale_fingerprint: bool = False) -> dict:
    """Evict, in the reference's order: orphans (a payload without meta or
    the reverse), entries older than ``max_age_s``, stale-fingerprint
    entries (opt-in), then the least recently used past ``max_bytes``.
    Returns ``{"removed": [digests], "kept": n, "total_bytes": n}``."""
    d = store_dir(directory)
    cap = max_store_bytes() if max_bytes is None else int(max_bytes)
    removed: list[str] = []
    try:
        names = set(os.listdir(d))
    except OSError:
        return {"removed": [], "kept": 0, "total_bytes": 0}
    rows = list_entries(d)
    known = {m["digest"] for m in rows}
    for name in names:
        stem, ext = os.path.splitext(name)
        if ext in (".bin", ".json") and stem not in known:
            try:
                os.remove(os.path.join(d, name))
            except OSError:
                pass
    now = time.time()
    keep: list[dict] = []
    for meta in rows:
        too_old = (max_age_s is not None
                   and isinstance(meta.get("created_at_unix"), (int, float))
                   and now - meta["created_at_unix"] > max_age_s)
        if too_old or (drop_stale_fingerprint and meta.get("stale")):
            _drop_entry(meta["digest"], d)
            removed.append(meta["digest"])
        else:
            keep.append(meta)
    if cap > 0:
        total = sum(int(m.get("size_bytes") or 0) for m in keep)
        while keep and total > cap:  # keep is MRU-first: evict from the tail
            meta = keep.pop()
            _drop_entry(meta["digest"], d)
            removed.append(meta["digest"])
            total -= int(meta.get("size_bytes") or 0)
    return {"removed": removed, "kept": len(keep),
            "total_bytes": sum(int(m.get("size_bytes") or 0) for m in keep)}
