"""Data-quality observability of a run: the QC session, its sketches and
the drift sentinel.

Counterpart: ``tmlibrary_tpu/qc.py`` (no JAX import there; the port
keeps its own copy).  The jterator step folds each persisted batch into
the process session (:meth:`QCSession.observe_batch`: the per-site image
statistics of ``ops/qc.py``, object counts, feature sketches, the DL
segmenters' ``__model__`` streams and the capacity-saturation flag) and
corilla folds each channel's percentiles
(:meth:`QCSession.observe_illumination`).  The batch summary rides the
batch result into the ledger (``qc_batch``/``qc_site`` events, written by
the engine), and the engine writes the session's profile to
``workflow/qc.<host>.json`` and ``qc.json`` at the end of a run.
``compare_profiles`` diffs a profile against a reference with pinned
exit codes (0 ok, 1 drift, 2 stale, 3 no reference).

The summaries, snapshots, profiles and verdicts equal the reference's
on the same inputs (``tests/test_torch_qc_session.py``).  Each batch
summary is mirrored into the telemetry registry as the reference's is
(``_mirror_registry``: the ``tmx_qc_*`` gauges and counters, and the
``tmx_qc_illum_p_top`` illumination gauge).  The host is
:func:`tmlibrary_tpu_torch.telemetry.host_id` (``TMX_HOST_ID``, else
``host0``).

Invariants (the reference's): pipeline outputs are bit-identical with QC
on and off, since QC only reads what the persist path already fetched;
QC flags sites, it never fails a batch; disabled QC is one no-op call at
each instrumentation point (:class:`_NullQCSession`).
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np

from tmlibrary_tpu_torch import telemetry

from tmlibrary_tpu_torch.atomicio import atomic_write_text
from tmlibrary_tpu_torch.config import setting

#: qc.json schema version
QC_SCHEMA_VERSION = 1

#: pseudo-objects of the model-output streams (the DL segmenters' flow
#: magnitude and probability samples); ``filter_profile_kind(..., "model")``
#: keeps exactly these, ``"run"`` drops them
MODEL_OBJECTS = "__model__"

# drift-sentinel exit codes (pinned, the reference's)
EXIT_OK = 0            #: profile within threshold of the reference
EXIT_DRIFT = 1         #: feature/channel drift detected (outranks stale)
EXIT_STALE = 2         #: reference older than the staleness budget
EXIT_NO_REFERENCE = 3  #: no reference profile to compare against

#: a site is flagged when at least this fraction of a channel saturates
SATURATION_FLAG_FRAC = 0.5
#: |z| beyond which focus / object-count outliers are flagged
Z_FLAG_THRESHOLD = 4.0
#: running stats need this many sites before z-score flags arm
Z_MIN_SITES = 16
#: per-feature per-batch cap on values fed to the quantile estimators
QUANTILE_SAMPLE_CAP = 256
#: worst-focus sites retained for the ``qc`` verb's worst-N table
WORST_SITES_KEPT = 16
#: flagged-site records retained verbatim in the profile
FLAGGED_KEPT = 512

_FALSY = ("", "0", "false", "no", "off")

_OVERRIDE: bool | None = None


def enabled() -> bool:
    """Is QC collection on?  The :func:`set_enabled` override beats the
    ``TMX_QC`` environment variable beats the ``TM_QC`` setting beats the
    default (off)."""
    if _OVERRIDE is not None:
        return _OVERRIDE
    env = os.environ.get("TMX_QC")
    if env is not None:
        return env.strip().lower() not in _FALSY
    return str(setting("qc", "0")).strip().lower() not in _FALSY


def set_enabled(flag: bool | None) -> None:
    """Process-local override; ``None`` restores the environment's and
    the setting's resolution."""
    global _OVERRIDE
    _OVERRIDE = None if flag is None else bool(flag)


# --------------------------------------------------------------------------
# P² streaming quantiles + per-feature sketches
# --------------------------------------------------------------------------


class P2Quantile:
    """Streaming quantile estimate via the P² algorithm (Jain &
    Chlamtac 1985): five markers track the running q-quantile in O(1)
    memory, no sample buffer.  Exact below five observations."""

    __slots__ = ("q", "count", "_init", "_pos", "_heights")

    def __init__(self, q: float):
        self.q = float(q)
        self.count = 0
        self._init: list[float] = []
        self._pos: list[float] = []
        self._heights: list[float] = []

    def update(self, x: float) -> None:
        x = float(x)
        self.count += 1
        if len(self._init) < 5:
            self._init.append(x)
            if len(self._init) == 5:
                self._heights = sorted(self._init)
                self._pos = [0.0, 1.0, 2.0, 3.0, 4.0]
            return
        h, pos = self._heights, self._pos
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = next(i for i in range(4) if h[i] <= x < h[i + 1])
        for i in range(k + 1, 5):
            pos[i] += 1.0
        n1 = float(self.count - 1)
        q = self.q
        desired = (0.0, n1 * q / 2.0, n1 * q,
                   n1 * (1.0 + q) / 2.0, n1)
        for i in (1, 2, 3):
            d = desired[i] - pos[i]
            if ((d >= 1.0 and pos[i + 1] - pos[i] > 1.0)
                    or (d <= -1.0 and pos[i - 1] - pos[i] < -1.0)):
                d = 1.0 if d > 0 else -1.0
                hp = self._parabolic(i, d)
                if not (h[i - 1] < hp < h[i + 1]):
                    hp = self._linear(i, d)
                h[i] = hp
                pos[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        h, n = self._heights, self._pos
        return h[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (h[i + 1] - h[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (h[i] - h[i - 1]) / (n[i] - n[i - 1])
        )

    def _linear(self, i: int, d: float) -> float:
        h, n = self._heights, self._pos
        j = i + int(d)
        return h[i] + d * (h[j] - h[i]) / (n[j] - n[i])

    def value(self) -> float:
        if self.count == 0:
            return math.nan
        if len(self._init) < 5:
            s = sorted(self._init)
            # linear interpolation over the exact sample
            t = self.q * (len(s) - 1)
            lo = int(math.floor(t))
            hi = min(lo + 1, len(s) - 1)
            return s[lo] + (t - lo) * (s[hi] - s[lo])
        return self._heights[2]


class FeatureSketch:
    """Streaming distribution sketch for one feature column.

    count/sum/min/max and NaN/Inf tallies are exact; p50/p95 come from
    P² estimators fed a deterministic stride subsample (cap
    ``QUANTILE_SAMPLE_CAP`` per batch).  ``to_dict`` serializes the
    *estimates*, and dict-level merging follows the
    reference's ``merge_snapshots`` discipline (see ``merge_sketch_dicts``)."""

    __slots__ = ("count", "sum", "min", "max", "nan", "inf",
                 "_p50", "_p95")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.nan = 0
        self.inf = 0
        self._p50 = P2Quantile(0.50)
        self._p95 = P2Quantile(0.95)

    def update(self, values: np.ndarray) -> tuple[int, int]:
        """Fold a batch of values; returns ``(n_nan, n_inf)`` seen."""
        values = np.asarray(values, np.float64).ravel()
        if values.size == 0:
            return 0, 0
        n_nan = int(np.isnan(values).sum())
        n_inf = int(np.isinf(values).sum())
        self.nan += n_nan
        self.inf += n_inf
        finite = values[np.isfinite(values)] if (n_nan or n_inf) else values
        if finite.size == 0:
            return n_nan, n_inf
        self.count += int(finite.size)
        self.sum += float(finite.sum())
        self.min = min(self.min, float(finite.min()))
        self.max = max(self.max, float(finite.max()))
        if finite.size > QUANTILE_SAMPLE_CAP:
            stride = -(-finite.size // QUANTILE_SAMPLE_CAP)
            finite = finite[::stride]
        for v in finite:
            v = float(v)
            self._p50.update(v)
            self._p95.update(v)
        return n_nan, n_inf

    def to_dict(self) -> dict[str, Any]:
        empty = self.count == 0
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": (self.sum / self.count) if self.count else None,
            "min": None if empty else self.min,
            "max": None if empty else self.max,
            "nan": self.nan,
            "inf": self.inf,
            "p50": None if empty else float(self._p50.value()),
            "p95": None if empty else float(self._p95.value()),
        }


def merge_sketch_dicts(a: dict, b: dict) -> dict:
    """Merge two serialized sketches with the reference's ``merge_snapshots``
    discipline: counts/sums/NaN tallies add, min/max fold, quantile
    estimates follow the larger sample (ties keep the first)."""
    ca, cb = int(a.get("count") or 0), int(b.get("count") or 0)
    bigger = a if ca >= cb else b
    total = ca + cb
    s = float(a.get("sum") or 0.0) + float(b.get("sum") or 0.0)
    mins = [v for v in (a.get("min"), b.get("min")) if v is not None]
    maxs = [v for v in (a.get("max"), b.get("max")) if v is not None]
    return {
        "count": total,
        "sum": s,
        "mean": (s / total) if total else None,
        "min": min(mins) if mins else None,
        "max": max(maxs) if maxs else None,
        "nan": int(a.get("nan") or 0) + int(b.get("nan") or 0),
        "inf": int(a.get("inf") or 0) + int(b.get("inf") or 0),
        "p50": bigger.get("p50"),
        "p95": bigger.get("p95"),
    }


class _Running:
    """Scalar Welford accumulator for z-score guards."""

    __slots__ = ("n", "mean", "m2")

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def update(self, x: float) -> None:
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self.m2 += d * (x - self.mean)

    def std(self) -> float:
        return math.sqrt(self.m2 / self.n) if self.n else 0.0

    def z(self, x: float) -> float:
        s = self.std()
        return (x - self.mean) / s if s > 0 else 0.0


# --------------------------------------------------------------------------
# QC session (one per process per run) + the disabled null object
# --------------------------------------------------------------------------


class _NullQCSession:
    """Shared do-nothing stand-in when QC is disabled: one attribute
    lookup and a no-op method call per instrumentation point — nothing
    allocates and no lock is taken (the reference's
    null-instrument pattern)."""

    __slots__ = ()
    enabled = False

    def observe_batch(self, *a, **k):
        return None

    def observe_illumination(self, *a, **k):
        return None

    def snapshot(self):
        return {}


_NULL_SESSION = _NullQCSession()

_session: "QCSession | None" = None
_session_lock = threading.Lock()


def get_session(on: bool | None = None):
    """The process QC session, or the shared null object when QC is off;
    ``on`` (a step's own ``qc`` argument) decides in place of
    :func:`enabled` when given.  Callers never branch on ``enabled()``
    themselves."""
    if not (enabled() if on is None else on):
        return _NULL_SESSION
    global _session
    if _session is None:
        with _session_lock:
            if _session is None:
                _session = QCSession()
    return _session


def reset_session() -> None:
    """Drop accumulated QC state (tests; fresh runs in one process)."""
    global _session
    with _session_lock:
        _session = None


class QCSession:
    """Accumulates QC evidence across a run's batches (thread-safe:
    jterator's persist path runs on the engine thread but corilla's
    illumination hook may land from step workers)."""

    enabled = True

    def __init__(self):
        self._lock = threading.Lock()
        self.started_at = time.time()
        # per-channel image-stat aggregates: metric -> min/max/sum/count
        self.channels: dict[str, dict[str, dict[str, float]]] = {}
        # per-channel focus running stats (z-score flagging)
        self._focus: dict[str, _Running] = {}
        # per-objects object-count running stats
        self._counts: dict[str, _Running] = {}
        self.count_z_max = 0.0
        # per-feature-column sketches, key "objects.feature"
        self.sketches: dict[str, FeatureSketch] = {}
        self.nan_columns: set[str] = set()
        self.nan_values = 0
        self.inf_values = 0
        self.capacity_saturated_batches = 0
        self.flagged: list[dict] = []
        self.flagged_total = 0
        self.worst_sites: list[dict] = []
        self.steps: dict[str, dict[str, int]] = {}
        self.illumination: dict[str, dict[str, float]] = {}

    # -- fold helpers ----------------------------------------------------

    def _agg(self, channel: str, metric: str, values: np.ndarray) -> None:
        entry = self.channels.setdefault(channel, {}).setdefault(
            metric, {"min": math.inf, "max": -math.inf,
                     "sum": 0.0, "count": 0})
        entry["min"] = min(entry["min"], float(values.min()))
        entry["max"] = max(entry["max"], float(values.max()))
        entry["sum"] += float(values.sum())
        entry["count"] += int(values.size)

    def _note_worst(self, focus: float, site: int, channel: str,
                    step: str) -> None:
        self.worst_sites.append({"site": int(site), "channel": channel,
                                 "step": step, "focus": float(focus)})
        self.worst_sites.sort(key=lambda w: w["focus"])
        del self.worst_sites[WORST_SITES_KEPT:]

    def _flag(self, batch_flags: list[dict], **site) -> None:
        self.flagged_total += 1
        if len(self.flagged) < FLAGGED_KEPT:
            self.flagged.append(site)
        batch_flags.append(site)

    # -- observation entry points ---------------------------------------

    def observe_batch(self, step: str, sites, image_stats=None,
                      counts=None, measurements=None,
                      saturated: bool = False) -> dict:
        """Fold one persisted jterator batch and return the compact
        summary that rides the batch result into the ledger
        (``qc_batch`` event) and the registry.

        Gauge-like summary fields are **cumulative** session values so
        ``registry_from_ledger`` replaying last-write gauge semantics
        reconstructs exactly what the live registry showed;
        ``flagged_sites``/``nan_values`` are batch-local.

        - ``image_stats``: ``{channel: {metric: (B,) array}}`` from the
          fused on-device stats (``ops.qc``), already cropped to the
          batch's valid sites.
        - ``counts``: ``{objects: (B,) int array}`` per-site object
          counts.
        - ``measurements``: ``{objects: {feature: (B, M) array}}``
          padded feature matrices; rows beyond a site's count are
          padding and are masked out here.
        - ``saturated``: the bucketing layer's capacity-saturation flag
          for this batch (reused as a numerics guard)."""
        sites = [int(s) for s in (sites or [])]
        batch_flags: list[dict] = []
        batch_nan = batch_inf = 0
        with self._lock:
            st = self.steps.setdefault(step, {"batches": 0, "sites": 0,
                                              "flagged": 0})
            st["batches"] += 1
            st["sites"] += len(sites)
            if saturated:
                self.capacity_saturated_batches += 1

            for channel, metrics in (image_stats or {}).items():
                arrs = {m: np.asarray(v, np.float64).ravel()
                        for m, v in metrics.items()}
                for metric, arr in arrs.items():
                    if arr.size:
                        self._agg(channel, metric, arr)
                sat = arrs.get("saturation_frac")
                focus = arrs.get("focus_tenengrad")
                run = self._focus.setdefault(channel, _Running())
                for i, site in enumerate(sites):
                    if sat is not None and i < sat.size \
                            and sat[i] >= SATURATION_FLAG_FRAC:
                        self._flag(batch_flags, site=site, step=step,
                                   channel=channel, reason="saturation",
                                   value=float(sat[i]))
                    if focus is not None and i < focus.size:
                        f = float(focus[i])
                        if run.n >= Z_MIN_SITES \
                                and run.z(f) < -Z_FLAG_THRESHOLD:
                            self._flag(batch_flags, site=site, step=step,
                                       channel=channel, reason="focus",
                                       value=f, z=float(run.z(f)))
                        run.update(f)
                        self._note_worst(f, site, channel, step)

            for objects, arr in (counts or {}).items():
                arr = np.asarray(arr, np.float64).ravel()
                run = self._counts.setdefault(objects, _Running())
                for i, site in enumerate(sites):
                    if i >= arr.size:
                        break
                    c = float(arr[i])
                    if run.n >= Z_MIN_SITES:
                        z = run.z(c)
                        self.count_z_max = max(self.count_z_max, abs(z))
                        if abs(z) > Z_FLAG_THRESHOLD:
                            self._flag(batch_flags, site=site, step=step,
                                       channel=objects,
                                       reason="object_count",
                                       value=c, z=float(z))
                    run.update(c)

            for objects, feats in (measurements or {}).items():
                n_objs = None
                if counts and objects in counts:
                    n_objs = np.asarray(counts[objects], np.int64).ravel()
                for feature, mat in feats.items():
                    mat = np.asarray(mat, np.float64)
                    if mat.ndim == 1:
                        mat = mat[None, :]
                    if n_objs is not None and mat.ndim == 2 \
                            and n_objs.size >= mat.shape[0]:
                        mask = (np.arange(mat.shape[1])[None, :]
                                < n_objs[:mat.shape[0], None])
                        vals = mat[mask]
                    else:
                        vals = mat.ravel()
                    key = f"{objects}.{feature}"
                    sketch = self.sketches.setdefault(key, FeatureSketch())
                    n_nan, n_inf = sketch.update(vals)
                    batch_nan += n_nan
                    batch_inf += n_inf
                    if n_nan or n_inf:
                        self.nan_columns.add(key)
            self.nan_values += batch_nan
            self.inf_values += batch_inf
            st["flagged"] += len(batch_flags)
            summary = self._summary_locked(batch_flags, batch_nan,
                                           batch_inf, saturated)
        self._mirror_registry(step, summary, batch_flags)
        return summary

    def _summary_locked(self, batch_flags, batch_nan, batch_inf,
                        saturated) -> dict:
        channels = {}
        worst_focus = None
        for ch, metrics in self.channels.items():
            entry: dict[str, float] = {}
            foc = metrics.get("focus_tenengrad")
            if foc and foc["count"]:
                entry["focus_min"] = foc["min"]
                worst_focus = (foc["min"] if worst_focus is None
                               else min(worst_focus, foc["min"]))
            sat = metrics.get("saturation_frac")
            if sat and sat["count"]:
                entry["saturation_max"] = sat["max"]
            bg = metrics.get("background")
            if bg and bg["count"]:
                entry["background_mean"] = bg["sum"] / bg["count"]
            channels[ch] = entry
        return {
            "channels": channels,
            "worst_focus": worst_focus,
            "nan_columns": len(self.nan_columns),
            "nan_values": batch_nan,
            "inf_values": batch_inf,
            "count_z_max": self.count_z_max,
            "flagged_total": self.flagged_total,
            "flagged_sites": batch_flags,
            "capacity_saturated": bool(saturated),
        }

    def _mirror_registry(self, step: str, summary: dict,
                         batch_flags: list[dict]) -> None:
        reg = telemetry.get_registry()
        for ch, entry in summary["channels"].items():
            if "focus_min" in entry:
                reg.gauge("tmx_qc_worst_focus",
                          channel=ch).set(entry["focus_min"])
            if "saturation_max" in entry:
                reg.gauge("tmx_qc_max_saturation_frac",
                          channel=ch).set(entry["saturation_max"])
            if "background_mean" in entry:
                reg.gauge("tmx_qc_background_mean",
                          channel=ch).set(entry["background_mean"])
        reg.gauge("tmx_qc_nan_columns").set(summary["nan_columns"])
        if summary["nan_values"] or summary["inf_values"]:
            reg.counter("tmx_qc_nan_values_total").inc(
                summary["nan_values"] + summary["inf_values"])
        reg.gauge("tmx_qc_count_z_max").set(summary["count_z_max"])
        if batch_flags:
            reg.counter("tmx_qc_sites_flagged_total",
                        step=step).inc(len(batch_flags))

    def observe_illumination(self, channel: str, percentile_keys,
                             percentile_values) -> None:
        """Fold corilla's exact raw-intensity percentiles (from the
        Welford histogram finalize) into the profile — acquisition-level
        dynamic range per channel, for free."""
        keys = np.asarray(percentile_keys, np.float64).ravel()
        values = np.asarray(percentile_values, np.float64).ravel()
        entry = {f"p{k:g}": float(v) for k, v in zip(keys, values)}
        with self._lock:
            self.illumination[channel] = entry
        top = float(values.max()) if values.size else 0.0
        telemetry.get_registry().gauge("tmx_qc_illum_p_top", channel=channel).set(top)

    # -- profile assembly -----------------------------------------------

    def snapshot(self) -> dict:
        """The run's QC profile (the ``workflow/qc.json`` payload)."""
        with self._lock:
            channels = {
                ch: {m: {"min": e["min"], "max": e["max"],
                         "mean": (e["sum"] / e["count"]) if e["count"]
                         else None,
                         "count": e["count"]}
                     for m, e in metrics.items()}
                for ch, metrics in self.channels.items()
            }
            return {
                "schema_version": QC_SCHEMA_VERSION,
                "written_at_unix": time.time(),
                "host": telemetry.host_id(),
                "steps": {k: dict(v) for k, v in self.steps.items()},
                "channels": channels,
                "illumination": dict(self.illumination),
                "features": {k: s.to_dict()
                             for k, s in sorted(self.sketches.items())},
                "guards": {
                    "nan_columns": sorted(self.nan_columns),
                    "nan_values": self.nan_values,
                    "inf_values": self.inf_values,
                    "count_z_max": self.count_z_max,
                    "capacity_saturated_batches":
                        self.capacity_saturated_batches,
                },
                "worst_sites": list(self.worst_sites),
                "flagged": list(self.flagged),
                "flagged_total": self.flagged_total,
            }


# --------------------------------------------------------------------------
# Profile files: write / load / merge across hosts
# --------------------------------------------------------------------------


def profile_path(workflow_dir: Path, host: str | None = None) -> Path:
    """Per-host profile path (``qc.<host>.json``)."""
    host = host or telemetry.host_id()
    return Path(workflow_dir) / f"qc.{host}.json"


def write_profile(path: Path, profile: dict) -> None:
    # atomic (tmp + rename): a kill mid-write must never leave half a
    # profile where the ``qc`` verb / the drift sentinel will read it
    atomic_write_text(path, json.dumps(profile, indent=1, default=float))


def load_profile(path: Path) -> dict | None:
    try:
        data = json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError):
        return None
    return data if isinstance(data, dict) else None


def load_run_profiles(workflow_dir: Path) -> list[tuple[str, dict]]:
    """All per-host QC profiles under a workflow dir, as
    ``(host, profile)`` pairs.  The plain ``qc.json`` convenience copy
    is skipped when per-host files exist (it duplicates host0)."""
    wf = Path(workflow_dir)
    pairs: list[tuple[str, dict]] = []
    for p in sorted(wf.glob("qc.*.json")):
        prof = load_profile(p)
        if prof:
            pairs.append((str(prof.get("host")
                              or p.stem.split(".", 1)[1]), prof))
    if not pairs:
        prof = load_profile(wf / "qc.json")
        if prof:
            pairs.append((str(prof.get("host") or "host0"), prof))
    return pairs


def _merge_agg(a: dict, b: dict) -> dict:
    ca, cb = int(a.get("count") or 0), int(b.get("count") or 0)
    total = ca + cb
    mean = None
    if total:
        sa = (a.get("mean") or 0.0) * ca
        sb = (b.get("mean") or 0.0) * cb
        mean = (sa + sb) / total
    mins = [v for v in (a.get("min"), b.get("min")) if v is not None]
    maxs = [v for v in (a.get("max"), b.get("max")) if v is not None]
    return {"min": min(mins) if mins else None,
            "max": max(maxs) if maxs else None,
            "mean": mean, "count": total}


def merge_profiles(pairs: list[tuple[str, dict]]) -> dict:
    """Fold per-host QC profiles into one fleet view, with the same
    discipline as the reference's ``telemetry.merge_snapshots``: tallies add, min/max
    fold, means re-weight, sketch quantiles follow the larger sample."""
    merged: dict[str, Any] = {
        "schema_version": QC_SCHEMA_VERSION,
        "written_at_unix": 0.0,
        "hosts": [],
        "steps": {}, "channels": {}, "illumination": {},
        "features": {},
        "guards": {"nan_columns": [], "nan_values": 0, "inf_values": 0,
                   "count_z_max": 0.0, "capacity_saturated_batches": 0},
        "worst_sites": [], "flagged": [], "flagged_total": 0,
    }
    nan_cols: set[str] = set()
    for host, prof in pairs:
        merged["hosts"].append(host)
        merged["written_at_unix"] = max(
            merged["written_at_unix"],
            float(prof.get("written_at_unix") or 0.0))
        for step, entry in (prof.get("steps") or {}).items():
            acc = merged["steps"].setdefault(
                step, {"batches": 0, "sites": 0, "flagged": 0})
            for k in acc:
                acc[k] += int(entry.get(k) or 0)
        for ch, metrics in (prof.get("channels") or {}).items():
            out = merged["channels"].setdefault(ch, {})
            for m, e in metrics.items():
                out[m] = _merge_agg(out.get(m, {}), e)
        merged["illumination"].update(prof.get("illumination") or {})
        for key, sk in (prof.get("features") or {}).items():
            cur = merged["features"].get(key)
            merged["features"][key] = (merge_sketch_dicts(cur, sk)
                                       if cur else dict(sk))
        g = prof.get("guards") or {}
        nan_cols.update(g.get("nan_columns") or [])
        merged["guards"]["nan_values"] += int(g.get("nan_values") or 0)
        merged["guards"]["inf_values"] += int(g.get("inf_values") or 0)
        merged["guards"]["count_z_max"] = max(
            merged["guards"]["count_z_max"],
            float(g.get("count_z_max") or 0.0))
        merged["guards"]["capacity_saturated_batches"] += int(
            g.get("capacity_saturated_batches") or 0)
        merged["worst_sites"].extend(prof.get("worst_sites") or [])
        merged["flagged"].extend(prof.get("flagged") or [])
        merged["flagged_total"] += int(prof.get("flagged_total") or 0)
    merged["guards"]["nan_columns"] = sorted(nan_cols)
    merged["worst_sites"].sort(key=lambda w: w.get("focus", math.inf))
    del merged["worst_sites"][WORST_SITES_KEPT:]
    del merged["flagged"][FLAGGED_KEPT:]
    return merged


# --------------------------------------------------------------------------
# Ledger fallback: rebuild a renderable QC view without qc.json
# --------------------------------------------------------------------------


def qc_from_ledger(events) -> dict:
    """Reassemble a partial QC view from ``qc_batch``/``qc_site``
    ledger events (no feature sketches — those live only in qc.json,
    so a ledger-derived view renders tables but cannot drive the drift
    sentinel)."""
    view: dict[str, Any] = {
        "schema_version": QC_SCHEMA_VERSION, "source": "ledger",
        "steps": {}, "channels": {}, "features": {},
        "guards": {"nan_columns": [], "nan_values": 0, "inf_values": 0,
                   "count_z_max": 0.0, "capacity_saturated_batches": 0},
        "worst_sites": [], "flagged": [], "flagged_total": 0,
    }
    for ev in events:
        kind = ev.get("event")
        if kind == "qc_batch":
            s = ev.get("summary") or {}
            step = str(ev.get("step") or "?")
            acc = view["steps"].setdefault(
                step, {"batches": 0, "sites": 0, "flagged": 0})
            acc["batches"] += 1
            # cumulative gauge fields: last write wins, like the registry
            for ch, entry in (s.get("channels") or {}).items():
                out = view["channels"].setdefault(ch, {})
                if "focus_min" in entry:
                    out["focus_tenengrad"] = {"min": entry["focus_min"]}
                if "saturation_max" in entry:
                    out["saturation_frac"] = {"max": entry["saturation_max"]}
                if "background_mean" in entry:
                    out["background"] = {"mean": entry["background_mean"]}
            g = view["guards"]
            g["nan_values"] += int(s.get("nan_values") or 0)
            g["inf_values"] += int(s.get("inf_values") or 0)
            g["count_z_max"] = max(g["count_z_max"],
                                   float(s.get("count_z_max") or 0.0))
            if s.get("capacity_saturated"):
                g["capacity_saturated_batches"] += 1
            view["flagged_total"] = max(view["flagged_total"],
                                        int(s.get("flagged_total") or 0))
            view["guards"].setdefault("nan_columns_gauge", 0)
            view["guards"]["nan_columns_gauge"] = int(
                s.get("nan_columns") or 0)
        elif kind == "qc_site":
            site = {k: ev[k] for k in
                    ("site", "step", "channel", "reason", "value", "z")
                    if k in ev}
            if len(view["flagged"]) < FLAGGED_KEPT:
                view["flagged"].append(site)
            step = str(ev.get("step") or "?")
            acc = view["steps"].setdefault(
                step, {"batches": 0, "sites": 0, "flagged": 0})
            acc["flagged"] += 1
    return view


# --------------------------------------------------------------------------
# Drift sentinel
# --------------------------------------------------------------------------


def stale_hours_default() -> float:
    """Staleness budget for references (hours).  0 disables the check —
    the sensible default for a *committed* baseline, which ages by
    design; prior-run comparisons opt in via ``--stale-hours`` or
    ``TMX_QC_STALE_HOURS``."""
    try:
        return float(os.environ.get("TMX_QC_STALE_HOURS", "0") or 0.0)
    except ValueError:
        return 0.0


def filter_profile_kind(profile: dict | None, kind: str) -> dict | None:
    """Restrict a profile to one comparison kind.

    ``kind="model"`` keeps only the ``__model__.`` feature sketches (and
    drops channels — image acquisition stats say nothing about the
    checkpoint); ``kind="run"`` drops them, so a DL run compared against
    a classical baseline never reads model streams as biology drift.
    Metadata (timestamps, guards) passes through untouched — staleness
    judgment still applies to either kind."""
    if not profile:
        return profile
    if kind not in ("run", "model"):
        raise ValueError(f"unknown profile kind '{kind}'")
    feats = profile.get("features") or {}
    prefix = MODEL_OBJECTS + "."
    if kind == "model":
        kept = {k: v for k, v in feats.items() if k.startswith(prefix)}
        return {**profile, "features": kept, "channels": {}}
    kept = {k: v for k, v in feats.items() if not k.startswith(prefix)}
    return {**profile, "features": kept}


def compare_profiles(current: dict | None, reference: dict | None,
                     threshold: float = 0.25,
                     stale_hours: float | None = None,
                     now: float | None = None) -> dict:
    """Drift verdict for ``current`` vs ``reference``.

    Exit-code discipline matches ``scripts/bench_regression.py``:
    0 ok · 1 drift (outranks stale) · 2 stale reference · 3 no
    reference.  A feature drifts when its median moved more than
    ``threshold`` × the reference spread (p95−p50, floored at 5% of
    |p50|), or when it grew NaN/Inf values the reference didn't have;
    a channel drifts when its max saturation fraction rose by more
    than 0.25 absolute."""
    if stale_hours is None:
        stale_hours = stale_hours_default()
    if not reference:
        return {"status": "no_reference", "exit_code": EXIT_NO_REFERENCE,
                "checked": 0, "drifted": [],
                "reason": "no reference profile"}
    now = time.time() if now is None else now
    age_hours = None
    written = reference.get("written_at_unix")
    if written:
        age_hours = max(0.0, (now - float(written)) / 3600.0)
    stale = bool(stale_hours and age_hours is not None
                 and age_hours > stale_hours)

    drifted: list[dict] = []
    checked = 0
    cur_feats = (current or {}).get("features") or {}
    for key, ref in sorted((reference.get("features") or {}).items()):
        cur = cur_feats.get(key)
        if not cur or not cur.get("count") or not ref.get("count"):
            continue
        checked += 1
        ref_p50 = float(ref.get("p50") or 0.0)
        ref_p95 = float(ref.get("p95") or 0.0)
        cur_p50 = float(cur.get("p50") or 0.0)
        spread = max(abs(ref_p95 - ref_p50), abs(ref_p50) * 0.05, 1e-9)
        delta = abs(cur_p50 - ref_p50)
        if delta > threshold * spread:
            drifted.append({"kind": "median_shift", "feature": key,
                            "current_p50": cur_p50,
                            "reference_p50": ref_p50, "delta": delta,
                            "allowed": threshold * spread})
        cur_bad = int(cur.get("nan") or 0) + int(cur.get("inf") or 0)
        ref_bad = int(ref.get("nan") or 0) + int(ref.get("inf") or 0)
        if cur_bad and not ref_bad:
            drifted.append({"kind": "new_nan", "feature": key,
                            "current_nan": cur_bad})
    cur_chans = (current or {}).get("channels") or {}
    for ch, ref_m in sorted((reference.get("channels") or {}).items()):
        cur_m = cur_chans.get(ch)
        if not cur_m:
            continue
        ref_sat = (ref_m.get("saturation_frac") or {}).get("max")
        cur_sat = (cur_m.get("saturation_frac") or {}).get("max")
        if ref_sat is not None and cur_sat is not None:
            checked += 1
            if float(cur_sat) > float(ref_sat) + 0.25:
                drifted.append({"kind": "saturation", "channel": ch,
                                "current_max": float(cur_sat),
                                "reference_max": float(ref_sat)})

    if drifted:
        status, code = "drift", EXIT_DRIFT
    elif stale:
        status, code = "stale", EXIT_STALE
    else:
        status, code = "ok", EXIT_OK
    return {"status": status, "exit_code": code, "checked": checked,
            "drifted": drifted, "age_hours": age_hours,
            "threshold": threshold, "stale_hours": stale_hours}


def record_summary() -> dict | None:
    """Compact QC summary of the process session for a benchmark record
    (worst focus, NaN columns, flagged sites, largest count z-score), so
    a time can be read beside the input's quality.  ``None`` when QC is
    off or saw nothing."""
    if not enabled() or _session is None:
        return None
    snap = _session.snapshot()
    if not snap.get("steps") and not snap.get("channels"):
        return None
    worst = None
    for metrics in snap.get("channels", {}).values():
        foc = metrics.get("focus_tenengrad")
        if foc and foc.get("min") is not None:
            worst = (foc["min"] if worst is None
                     else min(worst, foc["min"]))
    return {
        "worst_focus": worst,
        "nan_columns": len(snap["guards"]["nan_columns"]),
        "flagged_sites": snap.get("flagged_total", 0),
        "count_z_max": snap["guards"]["count_z_max"],
    }
