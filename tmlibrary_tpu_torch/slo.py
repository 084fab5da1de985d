"""Per-tenant SLO accounting for the serving path (``tmx slo``).

Counterpart: ``tmlibrary_tpu/slo.py``, which imports no JAX; the port keeps
its own copy, held equal to it on the same inputs by
``tests/test_torch_slo_canary.py``.

The serve daemon is an always-on service; this module gives that service
an objective to be judged against.  Objectives are per-tenant latency
(p95 ≤ ``latency_p95_s``) and availability (ok-fraction ≥
``availability``), resolved from the install config with ``TMX_SLO_*``
environment overrides (per-tenant overrides append the uppercased tenant:
``TMX_SLO_LATENCY_P95_S_PROD``).

Everything derives from the serve ledger's job-completion events
(``job_done``/``job_failed``/``job_expired``), so the whole surface is
**replayable**: :func:`report` over a ledger reconstructs exactly what the
live daemon saw, order-independently (multi-host merged ledgers dedup by
the same host/ts fingerprint the metrics derivation uses).  Fleet
consumers (``tmx slo``, the daemon's own burn check, CI) feed it
:func:`tmlibrary_tpu_torch.serve.serve_ledger_events` — the merged per-host
history — so burn is one fleet-wide truth.  The fleet spool protocol's
``job_reclaimed``/``stale_claim`` events are deliberately *not*
outcomes: a reclaimed job completes later under its new owner (one
``job_done``), and charging a daemon death to a tenant's availability
would double-count it.  The raw
``tmx_slo_*`` series (:func:`observe_job`) are fed identically by the
live daemon and by ``telemetry.registry_from_ledger``.

Burn-rate semantics (documented in DESIGN.md §21): over each window ``W``

* availability burn = (failed+expired fraction) / (1 − availability
  objective) — 1.0 means the error budget is being spent exactly at the
  rate that exhausts it in one window;
* latency burn = (fraction of jobs slower than ``latency_p95_s``) / 0.05
  — the p95 objective grants a 5% slow budget by construction;
* a tenant's burn is the max of the two, over the worst window.

Breaches are **warn-only**: the daemon appends an ``slo_burn`` ledger
event (which ``tmx top`` renders)
and never aborts or sheds on its own — the same contract QC has.  Exit
codes for ``tmx slo`` are pinned like the other sentinels: 0 ok,
1 burn ≥ 1 for some tenant, 3 no job-completion data.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
import time
from typing import Iterable

EXIT_OK = 0
EXIT_BURN = 1
EXIT_NO_DATA = 3

#: ledger kind → outcome label used on ``tmx_slo_jobs_total``
_OUTCOMES = {"job_done": "ok", "job_failed": "failed",
             "job_expired": "expired"}

#: the p95 latency objective's implicit error budget: 5% of jobs may be
#: slower than the target before the objective is violated
_LATENCY_BUDGET = 0.05


@dataclasses.dataclass(frozen=True)
class Objectives:
    """One tenant's service objectives."""

    latency_p95_s: float
    availability: float
    windows: tuple[float, ...]

    def to_dict(self) -> dict:
        return {"latency_p95_s": self.latency_p95_s,
                "availability": self.availability,
                "windows": list(self.windows)}


def _env(name: str, tenant: str | None = None) -> str | None:
    if tenant:
        suffix = re.sub(r"[^A-Za-z0-9]", "_", tenant).upper()
        v = os.environ.get(f"{name}_{suffix}")
        if v:
            return v
    return os.environ.get(name)


def _parse_windows(spec: str) -> tuple[float, ...]:
    out = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        try:
            w = float(part)
        except ValueError:
            continue
        if w > 0:
            out.append(w)
    return tuple(out) or (3600.0,)


def objectives(tenant: str = "default") -> Objectives:
    """Resolve one tenant's objectives: ``TMX_SLO_*`` env (per-tenant
    override first) beats the install config (``TM_SLO_*`` / INI)."""
    from tmlibrary_tpu_torch.config import cfg

    lat = _env("TMX_SLO_LATENCY_P95_S", tenant)
    avail = _env("TMX_SLO_AVAILABILITY", tenant)
    windows = _env("TMX_SLO_WINDOWS")
    try:
        latency = float(lat) if lat else float(cfg.slo_latency_p95_s)
    except ValueError:
        latency = float(cfg.slo_latency_p95_s)
    try:
        availability = (float(avail) if avail
                        else float(cfg.slo_availability))
    except ValueError:
        availability = float(cfg.slo_availability)
    availability = min(max(availability, 0.0), 1.0)
    return Objectives(
        latency_p95_s=latency,
        availability=availability,
        windows=_parse_windows(windows or cfg.slo_windows),
    )


# ---------------------------------------------------------------- series
def observe_job(reg, tenant: str, outcome: str, elapsed_s=None,
                **labels) -> None:
    """Feed the raw ``tmx_slo_*`` series for one completed job — the one
    definition shared by the live daemon and ledger replay, so a replayed
    registry is identical to the live one."""
    reg.counter("tmx_slo_jobs_total", tenant=tenant, outcome=outcome,
                **labels).inc()
    if elapsed_s is not None:
        reg.histogram("tmx_slo_job_latency_seconds", tenant=tenant,
                      **labels).observe(float(elapsed_s))


# ------------------------------------------------------------- completions
def job_completions(events: Iterable[dict]) -> list[dict]:
    """Normalized job-completion records from serve-ledger events.

    Host-attributed events are deduped by the same fingerprint the
    metrics derivation uses, so concatenating per-host ledgers in any
    order yields the same set (order-independent, like the fleet merge).
    """
    seen: set[tuple] = set()
    out: list[dict] = []
    for ev in events:
        kind = ev.get("event")
        outcome = _OUTCOMES.get(kind)
        if outcome is None:
            continue
        if ev.get("kind") == "canary":
            # canary probes are tenant-invisible (DESIGN.md §27): their
            # availability is per-host, via canary_report(), never a
            # tenant's error budget
            continue
        host = str(ev.get("host", "")) if ev.get("host") else ""
        if host:
            fp = (host, ev.get("ts"), kind, ev.get("job"))
            if fp in seen:
                continue
            seen.add(fp)
        rec = {
            "ts": float(ev.get("ts", 0.0) or 0.0),
            "tenant": str(ev.get("tenant", "")) or "unknown",
            "outcome": outcome,
            "elapsed_s": (float(ev["elapsed_s"])
                          if ev.get("elapsed_s") is not None else None),
        }
        out.append(rec)
    return out


def canary_report(events: Iterable[dict]) -> dict:
    """Per-host black-box availability from canary probe completions.

    The tenant-facing SLO machinery never sees canary events (they are
    filtered in :func:`job_completions`); this is the other half of the
    split — probes measure *hosts*, tenants measure *workloads*.  Pure
    and order-independent like everything else in this module."""
    seen: set[tuple] = set()
    hosts: dict[str, dict] = {}
    lat: dict[str, list[float]] = {}
    for ev in events:
        kind = ev.get("event")
        outcome = _OUTCOMES.get(kind)
        if outcome is None or ev.get("kind") != "canary":
            continue
        host = str(ev.get("host", "")) or "host0"
        fp = (host, ev.get("ts"), kind, ev.get("job"))
        if fp in seen:
            continue
        seen.add(fp)
        h = hosts.setdefault(host, {"probes": 0, "ok": 0, "failed": 0,
                                    "degraded": 0})
        h["probes"] += 1
        if outcome == "ok":
            h["ok"] += 1
            if ev.get("degraded"):
                h["degraded"] += 1
            if ev.get("elapsed_s") is not None:
                lat.setdefault(host, []).append(float(ev["elapsed_s"]))
        else:
            h["failed"] += 1
    for host, h in hosts.items():
        h["availability"] = (round(h["ok"] / h["probes"], 6)
                             if h["probes"] else None)
        vals = lat.get(host)
        h["latency_p50_s"] = quantile(vals, 0.50) if vals else None
        h["latency_p95_s"] = quantile(vals, 0.95) if vals else None
    return {"hosts": {host: hosts[host] for host in sorted(hosts)}}


def quantile(values: list[float], q: float) -> float | None:
    """Nearest-rank quantile over the (sorted-copy) values; None when
    empty.  Deterministic and order-independent — the convention the
    pinned ``tmx slo`` fixtures hand-compute against."""
    if not values:
        return None
    vals = sorted(values)
    rank = max(1, math.ceil(q * len(vals)))
    return vals[min(rank, len(vals)) - 1]


# ----------------------------------------------------------------- report
def report(events: Iterable[dict], now: float | None = None) -> dict:
    """Per-tenant SLO report from serve-ledger events.

    ``now`` anchors the burn windows; it defaults to the newest
    completion timestamp so replaying a historical ledger reproduces the
    burn rates it had while live (and the report stays deterministic for
    pinned fixtures).
    """
    events = list(events)
    completions = job_completions(events)
    if now is None:
        now = max((c["ts"] for c in completions), default=time.time())
    canary = canary_report(events)
    tenants: dict[str, list[dict]] = {}
    for c in completions:
        tenants.setdefault(c["tenant"], []).append(c)

    view: dict = {"now": round(float(now), 6), "tenants": {}}
    for tenant in sorted(tenants):
        recs = tenants[tenant]
        obj = objectives(tenant)
        counts = {"ok": 0, "failed": 0, "expired": 0}
        for c in recs:
            counts[c["outcome"]] += 1
        total = sum(counts.values())
        latencies = [c["elapsed_s"] for c in recs
                     if c["elapsed_s"] is not None]
        windows: dict[str, dict] = {}
        worst_burn = 0.0
        for w in obj.windows:
            in_w = [c for c in recs if c["ts"] >= now - w]
            n = len(in_w)
            bad = sum(1 for c in in_w if c["outcome"] != "ok")
            slow = sum(
                1 for c in in_w
                if c["elapsed_s"] is not None
                and c["elapsed_s"] > obj.latency_p95_s
            )
            avail_budget = 1.0 - obj.availability
            avail_burn = ((bad / n) / avail_budget
                          if n and avail_budget > 0 else
                          (float(bad > 0) * math.inf if n else 0.0))
            lat_burn = (slow / n) / _LATENCY_BUDGET if n else 0.0
            burn = max(avail_burn, lat_burn)
            worst_burn = max(worst_burn, burn)
            windows[f"{w:g}"] = {
                "total": n, "bad": bad, "slow": slow,
                "availability_burn": _round_burn(avail_burn),
                "latency_burn": _round_burn(lat_burn),
                "burn": _round_burn(burn),
            }
        view["tenants"][tenant] = {
            "objectives": obj.to_dict(),
            "jobs": {**counts, "total": total},
            "latency_p50_s": quantile(latencies, 0.50),
            "latency_p95_s": quantile(latencies, 0.95),
            "availability": (round(counts["ok"] / total, 6)
                            if total else None),
            "windows": windows,
            "burn": _round_burn(worst_burn),
            "breach": bool(worst_burn >= 1.0),
        }
    if canary["hosts"]:
        view["canary"] = canary
    return view


def _round_burn(x: float):
    if x == math.inf:
        return "inf"
    return round(x, 4)


def _burn_value(x) -> float:
    return math.inf if x == "inf" else float(x)


def breaches(view: dict) -> list[dict]:
    """Flattened (tenant, window, burn) triples for every window whose
    burn ≥ 1 — the daemon turns these into warn-only ``slo_burn`` ledger
    events."""
    out = []
    for tenant, entry in (view.get("tenants") or {}).items():
        for window, w in (entry.get("windows") or {}).items():
            if _burn_value(w.get("burn", 0.0)) >= 1.0:
                out.append({"tenant": tenant, "window": window,
                            "burn": w["burn"]})
    return out


def exit_code(view: dict) -> int:
    """The pinned ``tmx slo`` verdict for a report."""
    tenants = view.get("tenants") or {}
    if not tenants:
        return EXIT_NO_DATA
    if any(t.get("breach") for t in tenants.values()):
        return EXIT_BURN
    return EXIT_OK


def render(view: dict) -> str:
    """Human-readable per-tenant table for ``tmx slo``."""
    lines: list[str] = []
    tenants = view.get("tenants") or {}
    if not tenants:
        return "slo: no job-completion events (nothing to judge)\n"
    for tenant, t in tenants.items():
        obj = t["objectives"]
        jobs = t["jobs"]
        p50 = t["latency_p50_s"]
        p95 = t["latency_p95_s"]
        avail = t["availability"]
        flag = "  ** BURN **" if t["breach"] else ""
        lines.append(
            f"tenant {tenant:<12} jobs {jobs['total']:<4d} "
            f"(ok {jobs['ok']}, failed {jobs['failed']}, "
            f"expired {jobs['expired']})  "
            f"p50 {_fmt_s(p50)} p95 {_fmt_s(p95)} "
            f"(objective {obj['latency_p95_s']:g}s)  "
            f"avail {avail if avail is None else f'{avail:.2%}'} "
            f"(objective {obj['availability']:.2%})  "
            f"burn {t['burn']}{flag}"
        )
        for window, w in t["windows"].items():
            lines.append(
                f"  window {window:>8}s: jobs {w['total']:<4d} "
                f"bad {w['bad']:<3d} slow {w['slow']:<3d} "
                f"burn {w['burn']} (avail {w['availability_burn']}, "
                f"latency {w['latency_burn']})"
            )
    return "\n".join(lines) + "\n"


def _fmt_s(v) -> str:
    return "-" if v is None else f"{v:.3f}s"
