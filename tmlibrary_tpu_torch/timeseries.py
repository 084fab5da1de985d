"""Durable metric time-series: the observability plane's history layer.

Counterpart: ``tmlibrary_tpu/timeseries.py``, which imports no JAX; the port keeps
its own copy, held equal to it on the same inputs by
``tests/test_torch_slo_canary.py``.

Every other metrics surface in the repo is a point-in-time artifact —
``metrics.<host>.json`` is the *last* registry snapshot, ``tmx metrics
--source ledger`` replays a whole run after the fact.  Neither answers
"what was throughput doing twenty minutes ago?" while the fleet is
live.  This module adds the missing axis: a crash-safe, file-based
time-series store (one append-only ``tsdb.<host>.jsonl`` segment per
host, next to the host's metrics snapshot) fed by a registry flush hook
so every counter/gauge/histogram snapshot the engine or the serve
daemon takes also lands as timestamped samples.  ``tmx timeline``
renders it; ``canary.py``'s anomaly detector consumes the same signals
from the ledger side.

Format (DESIGN.md §27)
----------------------
Raw sample lines::

    {"ts": 1722.5, "name": "tmx_serve_queue_depth", "labels": {...},
     "value": 3.0}

Rollup lines add a resolution and fold statistics::

    {"ts": 1700.0, "res": 60, "name": ..., "labels": ...,
     "count": 12, "mean": 2.5, "min": 0.0, "max": 5.0, "last": 3.0}

Multi-resolution downsampling: raw samples are kept for
:data:`RAW_WINDOW_S`, then folded into 60 s rollups, kept for
:data:`MID_WINDOW_S`, then folded into 900 s rollups, dropped past the
retention horizon (``cfg.tsdb_retention_s``).  Compaction rewrites the
whole segment through ``atomicio`` (tmp + rename), so a kill
mid-compaction leaves the previous segment intact; plain appends
tolerate a torn final line — the reader skips it.

Everything here is pure file I/O + arithmetic: no device, no threads, and
a single ``telemetry.enabled()`` check makes the flush hook free when
telemetry is off (the bit-identical-results-with-tsdb-on/off contract).
"""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path
from typing import Iterable

from tmlibrary_tpu_torch.atomicio import atomic_write_text

logger = logging.getLogger(__name__)

#: raw samples younger than this stay at full resolution
RAW_WINDOW_S = 600.0
#: 60 s rollups younger than this stay at mid resolution
MID_WINDOW_S = 7200.0
#: the two rollup resolutions, seconds
RES_MID = 60.0
RES_COARSE = 900.0

#: unicode ramp for :func:`sparkline`
_BLOCKS = "▁▂▃▄▅▆▇█"


# ------------------------------------------------------------------ paths
def tsdb_path(directory: Path, host: str | None = None) -> Path:
    """One host's time-series segment under ``directory``.

    Unlike the heartbeat/ledger naming (where host0 keeps a legacy
    un-suffixed name), tsdb segments are new in this layer and uniformly
    suffixed — ``tsdb.host0.jsonl`` for the default host — so discovery
    is one glob with no legacy special case."""
    if host is None:
        from tmlibrary_tpu_torch import telemetry

        host = telemetry.host_id()
    return Path(directory) / f"tsdb.{host}.jsonl"


def _segment_host(path: Path) -> str:
    return path.name[len("tsdb."):-len(".jsonl")] or "host0"


def load_tsdb(root: Path) -> list[tuple[str, list[dict]]]:
    """Discover time-series segments reachable from ``root``.

    ``root`` may be the directory holding the segments, an experiment
    root (``workflow/``) or a serve root (``serve/``) — all candidate
    directories are probed, and a host appearing in several (a root that
    is both) contributes all its records.  Returns sorted
    ``(host, records)`` pairs."""
    root = Path(root)
    candidates = [root, root / "workflow", root / "serve"]
    hosts: dict[str, list[dict]] = {}
    seen: set[Path] = set()
    for d in candidates:
        if not d.is_dir():
            continue
        for path in sorted(d.glob("tsdb.*.jsonl")):
            rp = path.resolve()
            if rp in seen:
                continue
            seen.add(rp)
            hosts.setdefault(_segment_host(path), []).extend(
                _load_records(path))
    return sorted(hosts.items())


def _load_records(path: Path) -> list[dict]:
    """Parse one segment, skipping torn/corrupt lines (a crash mid-append
    leaves at most one partial final line — never poisons the file)."""
    out: list[dict] = []
    try:
        text = Path(path).read_text()
    except OSError:
        return out
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn append tail — drop, never raise
        if isinstance(rec, dict) and "name" in rec and "ts" in rec:
            out.append(rec)
    return out


# ------------------------------------------------------------- snapshots
def snapshot_samples(snapshot: dict, ts: float | None = None) -> list[dict]:
    """Flatten one :meth:`MetricsRegistry.snapshot` into raw samples.

    Counters and gauges become one sample each; histograms fan out into
    ``_count``/``_sum``/``_max`` and the ``_p50``/``_p95`` summary
    quantiles, so latency percentiles are chartable over time without
    storing raw observations."""
    if ts is None:
        ts = float(snapshot.get("captured_at") or time.time())
    ts = round(float(ts), 6)
    out: list[dict] = []

    def _sample(name: str, labels: dict, value) -> None:
        if value is None:
            return
        out.append({"ts": ts, "name": name, "labels": dict(labels or {}),
                    "value": float(value)})

    for entry in snapshot.get("counters", []) or []:
        _sample(entry.get("name"), entry.get("labels"), entry.get("value"))
    for entry in snapshot.get("gauges", []) or []:
        _sample(entry.get("name"), entry.get("labels"), entry.get("value"))
    for entry in snapshot.get("histograms", []) or []:
        name, labels = entry.get("name"), entry.get("labels")
        for suffix in ("count", "sum", "max", "p50", "p95"):
            if suffix in entry:
                _sample(f"{name}_{suffix}", labels, entry[suffix])
    return out


class TimeSeriesStore:
    """One host's append-only segment plus its compaction policy."""

    def __init__(self, directory: Path, host: str | None = None,
                 retention_s: float | None = None,
                 segment_bytes: int | None = None):
        from tmlibrary_tpu_torch.config import cfg

        self.directory = Path(directory)
        self.path = tsdb_path(self.directory, host)
        self.retention_s = float(
            cfg.tsdb_retention_s if retention_s is None else retention_s)
        #: compaction trigger: segment growing past this many bytes gets
        #: rewritten with rollups applied (an O(1) stat per flush — the
        #: hook never pays a read on the hot path)
        self.segment_bytes = int(
            cfg.tsdb_segment_bytes if segment_bytes is None
            else segment_bytes)

    # -------------------------------------------------------------- write
    def append(self, samples: Iterable[dict]) -> int:
        """Append raw samples as JSON lines.  Crash-consistent by
        construction: a kill mid-write tears at most the final line,
        which the reader skips."""
        lines = [json.dumps(s, sort_keys=True) for s in samples]
        if not lines:
            return 0
        self.directory.mkdir(parents=True, exist_ok=True)
        with open(self.path, "a") as f:
            f.write("\n".join(lines) + "\n")
        return len(lines)

    def record_snapshot(self, snapshot: dict,
                        ts: float | None = None) -> int:
        """Flatten + append one registry snapshot, compacting if the
        segment has outgrown its byte budget."""
        n = self.append(snapshot_samples(snapshot, ts))
        if n:
            self.maybe_compact()
        return n

    # ------------------------------------------------------------ compact
    def maybe_compact(self, now: float | None = None) -> bool:
        try:
            if os.path.getsize(self.path) <= self.segment_bytes:
                return False
        except OSError:
            return False
        self.compact(now=now)
        return True

    def compact(self, now: float | None = None) -> int:
        """Rewrite the segment with the rollup/retention rules applied.

        Atomic (tmp + rename): a reader racing the compaction sees the
        old complete segment or the new one, and a crash mid-rewrite
        loses nothing."""
        now = time.time() if now is None else float(now)
        records = compact_records(self.load(), now,
                                  retention_s=self.retention_s)
        text = "".join(json.dumps(r, sort_keys=True) + "\n"
                       for r in records)
        atomic_write_text(self.path, text)
        return len(records)

    def load(self) -> list[dict]:
        return _load_records(self.path)


def compact_records(records: list[dict], now: float,
                    raw_window_s: float = RAW_WINDOW_S,
                    mid_window_s: float = MID_WINDOW_S,
                    retention_s: float = 86400.0) -> list[dict]:
    """Apply the multi-resolution downsampling policy to ``records``.

    Deterministic: output depends only on the records and ``now``, and
    is sorted by (ts, resolution, name, labels) so repeated compactions
    of the same inputs are byte-identical."""

    def _label_key(labels: dict) -> tuple:
        return tuple(sorted((str(k), str(v))
                            for k, v in (labels or {}).items()))

    buckets: dict[tuple, dict] = {}
    keep: list[dict] = []

    def _fold(rec: dict, res: float) -> None:
        bucket_ts = float(rec["ts"]) // res * res
        key = (res, rec.get("name"), _label_key(rec.get("labels")),
               bucket_ts)
        cur = buckets.get(key)
        if "value" in rec:  # raw sample
            count, mean = 1, float(rec["value"])
            lo = hi = last = mean
        else:  # finer rollup folding into a coarser bucket
            count = int(rec.get("count", 1) or 1)
            mean = float(rec.get("mean", 0.0))
            lo = float(rec.get("min", mean))
            hi = float(rec.get("max", mean))
            last = float(rec.get("last", mean))
        if cur is None:
            buckets[key] = {
                "ts": bucket_ts, "res": res, "name": rec.get("name"),
                "labels": dict(rec.get("labels") or {}), "count": count,
                "mean": mean, "min": lo, "max": hi, "last": last,
                "_last_ts": float(rec["ts"]),
            }
        else:
            total = cur["count"] + count
            cur["mean"] = (cur["mean"] * cur["count"] + mean * count) / total
            cur["count"] = total
            cur["min"] = min(cur["min"], lo)
            cur["max"] = max(cur["max"], hi)
            if float(rec["ts"]) >= cur["_last_ts"]:
                cur["_last_ts"] = float(rec["ts"])
                cur["last"] = last

    for rec in records:
        try:
            ts = float(rec["ts"])
        except (KeyError, TypeError, ValueError):
            continue
        if ts < now - retention_s:
            continue
        res = float(rec.get("res", 0) or 0)
        if res <= 0:  # raw
            if ts >= now - raw_window_s:
                keep.append(rec)
            else:
                _fold(rec, RES_MID)
        elif res <= RES_MID:
            if ts >= now - mid_window_s:
                _fold(rec, RES_MID)
            else:
                _fold(rec, RES_COARSE)
        else:
            _fold(rec, RES_COARSE)

    out = []
    for b in buckets.values():
        b = dict(b)
        b.pop("_last_ts", None)
        for k in ("mean", "min", "max", "last"):
            b[k] = round(b[k], 6)
        out.append(b)
    out.extend(keep)
    out.sort(key=lambda r: (float(r["ts"]), float(r.get("res", 0) or 0),
                            str(r.get("name")),
                            sorted((r.get("labels") or {}).items())))
    return out


# ------------------------------------------------------------ flush hook
def flush_registry(directory: Path, host: str | None = None,
                   reg=None, now: float | None = None) -> int:
    """The :class:`MetricsRegistry` flush hook: snapshot the (given or
    process) registry and land it in ``directory``'s segment.

    Near-zero cost when telemetry is off — one boolean check, no I/O —
    which is what keeps jterator results bit-identical with the
    time-series layer on vs off.  A failed write raises (the reference
    logs it and returns 0): a run whose ``timeline`` would be silently
    empty fails instead."""
    from tmlibrary_tpu_torch import telemetry

    if reg is None:
        if not telemetry.enabled():
            return 0
        reg = telemetry.get_registry()
    snapshot = reg.snapshot()
    if host is None and telemetry.fleet_active():
        host = telemetry.host_id()
    return TimeSeriesStore(directory, host).record_snapshot(snapshot, ts=now)


# ----------------------------------------------------- merge + querying
def merge_tsdb(host_records: Iterable[tuple[str, list[dict]]]) -> list[dict]:
    """Merge per-host segments into one record stream, stamping each
    record with a ``host`` label under the same discipline as
    :func:`telemetry.merge_snapshots` — a host label the record already
    carries wins, so device series recorded with explicit host labels
    are not re-tagged."""
    out: list[dict] = []
    for host, records in host_records:
        for rec in records:
            merged = dict(rec)
            labels = dict(merged.get("labels") or {})
            labels.setdefault("host", str(host))
            merged["labels"] = labels
            out.append(merged)
    out.sort(key=lambda r: (float(r.get("ts", 0) or 0),
                            str(r.get("name")),
                            sorted((r.get("labels") or {}).items())))
    return out


def series_index(records: Iterable[dict]) -> dict[tuple, list[tuple]]:
    """Group records into series: ``(name, ((k, v), ...)) → [(ts, value),
    ...]`` sorted by timestamp.  Rollup records contribute their ``last``
    value — the right continuation for both counters (cumulative) and
    gauges (most recent)."""
    series: dict[tuple, list[tuple]] = {}
    for rec in records:
        name = rec.get("name")
        if not name:
            continue
        value = rec.get("value", rec.get("last"))
        if value is None:
            continue
        key = (str(name), tuple(sorted(
            (str(k), str(v)) for k, v in (rec.get("labels") or {}).items()
        )))
        series.setdefault(key, []).append(
            (float(rec.get("ts", 0) or 0), float(value)))
    for points in series.values():
        points.sort()
    return series


def delta(points: list[tuple]) -> float | None:
    """Counter increase over the points, reset-aware: a value drop is a
    counter reset (process restart), so the post-reset value counts in
    full rather than as a negative step."""
    if len(points) < 2:
        return None
    total = 0.0
    prev = points[0][1]
    for _, v in points[1:]:
        total += v if v < prev else v - prev
        prev = v
    return total


def rate(points: list[tuple], window_s: float | None = None,
         now: float | None = None) -> float | None:
    """Per-second increase over the (optionally windowed) points."""
    if window_s is not None:
        anchor = (max(ts for ts, _ in points) if points and now is None
                  else float(now or 0.0))
        points = [p for p in points if p[0] >= anchor - window_s]
    if len(points) < 2:
        return None
    span = points[-1][0] - points[0][0]
    if span <= 0:
        return None
    d = delta(points)
    return None if d is None else d / span


def quantile_over_time(points: list[tuple], q: float) -> float | None:
    """Nearest-rank quantile of the point values (``slo.quantile``'s
    convention, so timeline percentiles agree with the SLO math)."""
    from tmlibrary_tpu_torch import slo

    return slo.quantile([v for _, v in points], q)


def sparkline(values: list[float], width: int = 48) -> str:
    """Unicode sparkline: values bucketed to ``width`` columns (mean per
    bucket), normalized min→max across the series."""
    if not values:
        return ""
    if len(values) > width > 0:
        cols: list[float] = []
        for i in range(width):
            lo = i * len(values) // width
            hi = max(lo + 1, (i + 1) * len(values) // width)
            chunk = values[lo:hi]
            cols.append(sum(chunk) / len(chunk))
    else:
        cols = list(values)
    lo, hi = min(cols), max(cols)
    if hi <= lo:
        return _BLOCKS[3] * len(cols)
    scale = (len(_BLOCKS) - 1) / (hi - lo)
    return "".join(_BLOCKS[int((v - lo) * scale + 0.5)] for v in cols)


# -------------------------------------------------- seed-era fallback
def synthesize_from_ledger(events: Iterable[dict]) -> list[dict]:
    """Best-effort synthetic samples from ledger events, for roots that
    predate the tsdb (seed-era runs, or telemetry-off daemons).

    Each timing-bearing event becomes one raw sample under the metric
    name its live series uses, so ``tmx timeline`` renders the same
    series names either way — coarser (one point per event, not per
    flush) but honest about its source."""
    out: list[dict] = []

    def _sample(ts, name: str, value, **labels) -> None:
        if ts is None or value is None:
            return
        out.append({"ts": round(float(ts), 6), "name": name,
                    "labels": {k: str(v) for k, v in labels.items()
                               if v is not None},
                    "value": float(value)})

    for ev in events:
        kind = ev.get("event")
        ts = ev.get("ts")
        host = str(ev.get("host", "")) or None
        tenant = str(ev.get("tenant", "")) or None
        if kind == "batch_done" and ev.get("elapsed") is not None:
            _sample(ts, "tmx_batch_seconds", ev["elapsed"],
                    step=ev.get("step"), host=host)
        elif kind == "job_done" and ev.get("elapsed_s") is not None:
            if ev.get("kind") == "canary":
                _sample(ts, "tmx_canary_latency_seconds", ev["elapsed_s"],
                        host=host)
            else:
                _sample(ts, "tmx_serve_job_seconds", ev["elapsed_s"],
                        tenant=tenant, host=host)
        elif kind == "job_admitted" and ev.get("queue_wait_s") is not None:
            if ev.get("kind") != "canary":
                _sample(ts, "tmx_serve_queue_wait_seconds",
                        ev["queue_wait_s"], tenant=tenant, host=host)
        elif kind == "job_started" and ev.get("sched_delay_s") is not None:
            _sample(ts, "tmx_serve_sched_delay_seconds",
                    ev["sched_delay_s"], tenant=tenant, host=host)
        elif kind == "slo_burn":
            try:
                burn = float(ev.get("burn"))
            except (TypeError, ValueError):
                burn = None
            _sample(ts, "tmx_slo_burn", burn, tenant=tenant,
                    window=ev.get("window"), host=host)
        elif kind == "anomaly":
            _sample(ts, "tmx_anomaly_zscore", ev.get("zscore"),
                    metric=ev.get("metric"), host=host)
    out.sort(key=lambda r: (r["ts"], r["name"],
                            sorted(r["labels"].items())))
    return out
