"""Machine-written tuning defaults (``tuning/TUNING.json``).

Counterpart: ``tmlibrary_tpu/tuning.py``, which imports no JAX apart from
its backend lookups; the port keeps its own copy.  A hardware sweep
writes its verdict (``best_batch`` for the segment+measure chain,
``best_pipeline`` for the in-flight depth, and per-backend verdicts for
the reduction strategy, the object-capacity hint, the schedule and the
analytics index) into ``tuning/TUNING.json``; this module is the one
runtime reader of that file and of the bench history beside it.

Provenance gate, as the reference's: only a file with ``written_by`` set
and no ``SMOKE(`` dry-run methodology counts.  ``TMX_TUNING_JSON``
redirects the file, ``BENCH_HISTORY`` the history, ``BENCH_TPU_CACHE``
the cached bench records and ``WATCH_RECAPTURE`` the re-capture queue.

**Divergence: every tuned value is backend-scoped.**  The reference's
:func:`tuned_batch_size` and :func:`tuned_pipeline_depth` read
``best_batch``/``best_pipeline`` whatever the file's ``backend``, and its
callers adopt them on any backend but the CPU, while its own rule for
the other verdicts is that one measured on one backend never sets
another backend's default.  The port applies that rule to every value:
``best_batch`` and ``best_pipeline`` count only when the file's
``backend`` is the asking backend, and a per-backend dict counts only
under the asking backend's key.  The port's backend class on the card
is ``cuda`` (``torch.device(...).type``), so the repo's
``tuning/TUNING.json`` (``backend: tpu``) sets nothing there: the card
keeps batch 32 and depth 8 until a sweep on the card writes its own
verdict.  Where the reference's readers take ``backend=None`` to mean
JAX's default backend, the port's mean ``cuda``, the device its entry
points run on unless the caller asks for the CPU.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from pathlib import Path

from tmlibrary_tpu_torch.atomicio import atomic_write_text

#: the backend class of the port's default device
DEFAULT_BACKEND = "cuda"


def backend_of(device) -> str:
    """The backend class of ``device`` (``"cuda"`` or ``"cpu"``); None is
    :data:`DEFAULT_BACKEND`."""
    if device is None:
        return DEFAULT_BACKEND
    import torch

    return torch.device(device).type


def tuning_json_path() -> str:
    """The tuning file, resolved at call time (``TMX_TUNING_JSON``
    redirects it)."""
    return os.environ.get(
        "TMX_TUNING_JSON",
        str(Path(__file__).resolve().parent.parent / "tuning" / "TUNING.json"),
    )


def _tuning_dir() -> str:
    return os.path.dirname(os.path.abspath(tuning_json_path()))


def bench_cache_path() -> str:
    """The cache of the freshest on-hardware bench records
    (``tuning/BENCH_TPU.json`` beside the tuning file; ``BENCH_TPU_CACHE``
    redirects it)."""
    return os.environ.get("BENCH_TPU_CACHE", os.path.join(_tuning_dir(), "BENCH_TPU.json"))


def bench_history_path() -> str:
    """The append-only bench history (``BENCH_HISTORY.jsonl`` beside the
    tuning file; ``BENCH_HISTORY`` redirects it)."""
    return os.environ.get("BENCH_HISTORY", os.path.join(_tuning_dir(), "BENCH_HISTORY.jsonl"))


def recapture_path() -> str:
    """The re-capture queue the regression sentinel writes
    (``RECAPTURE.json`` beside the tuning file; ``WATCH_RECAPTURE``
    redirects it)."""
    return os.environ.get("WATCH_RECAPTURE", os.path.join(_tuning_dir(), "RECAPTURE.json"))


def append_bench_history(record: dict, path: str | None = None) -> str | None:
    """Append one bench record to the history, stamped with the append
    time; the path written, or None on any failure (history is
    observability and never breaks the bench's output)."""
    try:
        path = path or bench_history_path()
        line = {
            "recorded_at": datetime.datetime.now(datetime.timezone.utc).isoformat(
                timespec="seconds"),
            "recorded_at_unix": time.time(),
            **record,
        }
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(line, sort_keys=True) + "\n")
        return path
    except Exception:
        return None


def load_bench_history(path: str | None = None) -> list[dict]:
    """The history's records, oldest first; corrupt lines are skipped."""
    path = path or bench_history_path()
    out: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        return []
    return out


def load_tuning() -> dict | None:
    """The tuning verdict, or None when absent, unreadable or failing the
    provenance gate (no ``written_by``, or a ``SMOKE(`` methodology)."""
    try:
        with open(tuning_json_path()) as f:
            tuning = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(tuning, dict):
        return None
    if "SMOKE(" in str(tuning.get("timing_methodology", "")):
        return None
    return tuning if "written_by" in tuning else None


def _positive_int(value) -> int | None:
    if isinstance(value, (int, float)) and int(value) > 0:
        return int(value)
    return None


def _scoped(tuning: dict | None, key: str, backend: str | None):
    """``tuning[key]`` for ``backend``: a per-backend dict's entry under
    the backend, or a plain value when the file's ``backend`` is it."""
    if not tuning:
        return None
    backend = backend or DEFAULT_BACKEND
    entry = tuning.get(key)
    if isinstance(entry, dict):
        return entry.get(backend)
    return entry if tuning.get("backend") == backend else None


def tuned_pipeline_depth(backend: str | None = None) -> int | None:
    """``best_pipeline`` when the file was measured on ``backend``, else
    None (the divergence in the module docstring)."""
    return _positive_int(_scoped(load_tuning(), "best_pipeline", backend))


def tuned_batch_size(backend: str | None = None) -> int | None:
    """``best_batch`` when the file was measured on ``backend``, else
    None (the divergence in the module docstring)."""
    return _positive_int(_scoped(load_tuning(), "best_batch", backend))


_REDUCTION_STRATEGIES = ("onehot", "sort", "scatter", "fused")


def tuned_reduction_strategy(backend: str | None = None) -> str | None:
    """The swept grouped-reduction strategy for ``backend``, or None
    (malformed values too)."""
    value = _scoped(load_tuning(), "reduction_strategy", backend)
    return value if value in _REDUCTION_STRATEGIES else None


def tuned_object_capacity(backend: str | None = None) -> int | None:
    """The swept object-capacity bucket for ``backend`` (the router's
    first-batch hint), or None."""
    return _positive_int(_scoped(load_tuning(), "object_capacity", backend))


_SCHEDULE_MODES = ("pack", "off")


def tuned_schedule(backend: str | None = None) -> str | None:
    """The swept scheduling verdict (``"pack"`` | ``"off"``) for
    ``backend``, or None."""
    value = _scoped(load_tuning(), "schedule", backend)
    return value if value in _SCHEDULE_MODES else None


_ANALYTICS_INDEX_MODES = ("ivf", "brute")


def tuned_analytics_index(backend: str | None = None) -> str | None:
    """The swept analytics kNN index (``"ivf"`` | ``"brute"``) for
    ``backend``, or None."""
    value = _scoped(load_tuning(), "analytics_index", backend)
    return value if value in _ANALYTICS_INDEX_MODES else None


def record_config_sweep(config: str, entry: dict) -> dict:
    """Merge one per-config sweep verdict into the tuning file, as the
    reference does: ``config_sweeps[config]`` and the per-backend
    strategy, capacity, schedule and index verdicts; the file's other
    keys stay, and ``written_by`` is stamped only when this write makes
    the file.  Returns the merged document."""
    path = tuning_json_path()
    try:
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict):
            data = {}
    except (OSError, ValueError):
        data = {}
    data.setdefault("written_by", "bench.py --sweep")
    data.setdefault("config_sweeps", {})[str(config)] = entry
    backend = entry.get("backend")
    strategy = entry.get("best_strategy")
    if backend and strategy in _REDUCTION_STRATEGIES:
        verdicts = data.get("reduction_strategy")
        if not isinstance(verdicts, dict):
            # a legacy plain-string verdict moves under its backend
            legacy = verdicts if verdicts in _REDUCTION_STRATEGIES else None
            verdicts = {data["backend"]: legacy} if legacy and data.get("backend") else {}
        verdicts[backend] = strategy
        data["reduction_strategy"] = verdicts
    capacity = _positive_int(entry.get("best_capacity"))
    if backend and capacity:
        caps = data.get("object_capacity")
        caps = caps if isinstance(caps, dict) else {}
        caps[backend] = capacity
        data["object_capacity"] = caps
    for key, field, allowed in (("schedule", "best_schedule", _SCHEDULE_MODES),
                                ("analytics_index", "best_index", _ANALYTICS_INDEX_MODES)):
        value = entry.get(field)
        if backend and value in allowed:
            verdict = data.get(key)
            verdict = verdict if isinstance(verdict, dict) else {}
            verdict[backend] = value
            data[key] = verdict
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    atomic_write_text(path, json.dumps(data, indent=2, sort_keys=True) + "\n")
    return data


def config_sweep(config: str, *, model_digest: str | None = None) -> dict | None:
    """The recorded sweep verdict for ``config``, or None; with
    ``model_digest``, an entry recorded against another checkpoint (or
    none) counts as absent."""
    tuning = load_tuning()
    sweeps = tuning.get("config_sweeps") if tuning else None
    entry = sweeps.get(str(config)) if isinstance(sweeps, dict) else None
    if not isinstance(entry, dict):
        return None
    if model_digest is not None and entry.get("model_digest") != model_digest:
        return None
    return entry
