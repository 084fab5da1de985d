"""``tmx top`` — live fleet dashboard over a run's telemetry files.

Counterpart: ``tmlibrary_tpu/top.py``, which imports no JAX; the port keeps
its own copy, held equal to it on the same inputs by
``tests/test_torch_serve.py``.

The operator console the future streaming service needs (ROADMAP item 1,
acia-workflows' service-grade monitoring): one terminal view of a running
(or finished) workflow assembled purely from the files every run already
writes next to its ledger — per-host ``heartbeat*.json``, per-host
``metrics.<host>.json`` registry snapshots, and the run ledger itself.

Deliberately curses-free: a plain ANSI clear-and-repaint loop degrades to
sensible output in CI logs and over ssh, and ``--once`` renders a single
frame for tests.  Nothing here ever initialises a device — the
dashboard must be runnable from a watcher box that has no accelerator.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Any, TextIO

from tmlibrary_tpu_torch import telemetry

#: per-device utilization bar width (characters)
_BAR_WIDTH = 24


def _workflow_dir(root: Path) -> Path:
    root = Path(root)
    return root / "workflow" if (root / "workflow").is_dir() else root


def collect_fleet(root: Path) -> dict[str, Any]:
    """Poll one run root into a render-ready fleet view dict.

    Pure file reads (heartbeats, snapshots, ledger) — safe to call at any
    repaint frequency against a live run."""
    wf = _workflow_dir(root)
    view: dict[str, Any] = {"root": str(root), "hosts": [], "merged": None,
                            "status": {}, "degraded": None, "qc": None,
                            "preempted": None}
    for hb_path in sorted(wf.glob("heartbeat*.json")):
        hb = telemetry.read_heartbeat(hb_path)
        if not hb or "ts" not in hb:
            continue
        age = telemetry.heartbeat_age(hb_path)
        period = float(hb.get("period", 0) or 0)
        view["hosts"].append({
            "host": str(hb.get("host") or "host0"),
            "age_s": age,
            "period_s": period,
            "stale": bool(period > 0 and age is not None
                          and age > 2 * period),
            "rss_bytes": hb.get("rss_bytes"),
            "open_fds": hb.get("open_fds"),
            "device_bytes_in_use": hb.get("device_bytes_in_use"),
        })
    view["hosts"].sort(key=lambda h: h["host"])
    pairs = telemetry.load_fleet_snapshots(wf)
    if pairs:
        view["merged"] = telemetry.merge_snapshots(pairs)
    ledger_path = wf / "ledger.jsonl"
    if ledger_path.exists():
        from tmlibrary_tpu_torch.workflow.engine import RunLedger

        ledger = RunLedger(ledger_path)
        view["status"] = ledger.status()
        view["degraded"] = ledger.degraded_backend()
        view["preempted"] = ledger.preempted()
    # qc.py is numpy + stdlib only — no device touched (see module
    # docstring constraint)
    from tmlibrary_tpu_torch import qc as qc_mod

    qc_pairs = qc_mod.load_run_profiles(wf)
    if qc_pairs:
        view["qc"] = (qc_mod.merge_profiles(qc_pairs)
                      if len(qc_pairs) > 1 else qc_pairs[0][1])
    # serve roots (serve.py spool layout) gain a SERVE panel — pure file
    # reads again, works against a live or stopped daemon
    from tmlibrary_tpu_torch import serve as serve_mod

    view["serve"] = (serve_mod.serve_status_view(root)
                     if serve_mod.is_serve_root(root) else None)
    return view


def _gauges(merged: dict, name: str) -> list[dict]:
    return [g for g in merged.get("gauges", []) if g.get("name") == name]


def _counter_sum(merged: dict, name: str) -> float:
    return sum(c.get("value", 0.0) for c in merged.get("counters", [])
               if c.get("name") == name)


def _bar(frac: float, width: int = _BAR_WIDTH) -> str:
    frac = min(max(frac, 0.0), 1.0)
    filled = int(round(frac * width))
    return "█" * filled + "·" * (width - filled)


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if n < 1024 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}TiB"


def render_dashboard(view: dict, width: int = 80) -> str:
    """One frame of the dashboard as plain text (no cursor control —
    the caller owns screen clearing)."""
    lines: list[str] = []
    lines.append(f"tmx top — {view['root']}")
    lines.append("=" * min(width, 72))

    # ---- hosts: heartbeat health + sampled process resources
    if view["hosts"]:
        lines.append("hosts:")
        for h in view["hosts"]:
            age = f"{h['age_s']:.1f}s" if h["age_s"] is not None else "?"
            flag = "  ** STALE — run appears hung **" if h["stale"] else ""
            lines.append(
                f"  ♥ {h['host']:<8} heartbeat {age} ago"
                f" (period {h['period_s']:g}s)"
                f"  rss {_fmt_bytes(h['rss_bytes'])}"
                f"  fds {h['open_fds'] if h['open_fds'] is not None else '-'}"
                f"  devmem {_fmt_bytes(h['device_bytes_in_use'])}{flag}"
            )
    else:
        lines.append("hosts: no heartbeat files (run not started, or "
                     "sampler disabled)")

    # ---- step progress from the ledger
    if view["status"]:
        lines.append("steps:")
        for name, entry in view["status"].items():
            done = entry.get("batches_done", 0)
            total = entry.get("n_batches")
            state = entry.get("state", "?")
            frac = done / total if total else 0.0
            prog = f"{done}/{total}" if total else str(done)
            extra = ""
            if entry.get("watchdog_fires"):
                extra = f"  watchdog x{entry['watchdog_fires']}"
            lines.append(
                f"  {name:<16} {state:<9} [{_bar(frac, 16)}] {prog} batches"
                f"{extra}"
            )

    merged = view["merged"]
    if merged:
        # ---- throughput + pipeline depth
        thr = _gauges(merged, "tmx_step_units_per_sec")
        sites = _gauges(merged, "tmx_jterator_sites_per_sec")
        for g in thr:
            step = g["labels"].get("step", "?")
            host = g["labels"].get("host", "")
            tag = f" [{host}]" if host else ""
            lines.append(
                f"throughput: {step}{tag} {g.get('value', 0.0):.2f} units/s"
            )
        for g in sites:
            host = g["labels"].get("host", "")
            tag = f" [{host}]" if host else ""
            lines.append(
                f"throughput: jterator{tag} "
                f"{g.get('value', 0.0):.2f} sites/s"
            )
        for g in _gauges(merged, "tmx_pipeline_inflight"):
            host = g["labels"].get("host", "")
            tag = f" [{host}]" if host else ""
            lines.append(
                f"pipeline: {g['labels'].get('step', '?')}{tag} "
                f"{int(g.get('value', 0))} batch(es) in flight"
            )
        for g in _gauges(merged, "tmx_pipeline_depth"):
            host = g["labels"].get("host", "")
            tag = f" [{host}]" if host else ""
            lines.append(
                f"pipeline: {g['labels'].get('step', '?')}{tag} "
                f"depth {int(g.get('value', 0))}"
            )

        # ---- bucket occupancy
        occ = _gauges(merged, "tmx_jterator_slot_occupancy")
        routed = _counter_sum(merged, "tmx_jterator_bucket_routed_total")
        if occ:
            val = occ[0].get("value", 0.0)
            lines.append(
                f"buckets: occupancy [{_bar(val, 16)}] {val * 100:.0f}%"
                + (f"  routed {int(routed)}" if routed else "")
            )

        # ---- PACK row: the work-model scheduler (workflow/schedule.py)
        # — how many batches ran under a plan, how often the planned
        # capacity rung held without an escalation re-launch, and the
        # predicted-work skew the shard balancer left behind
        planned = _counter_sum(merged, "tmx_schedule_batches_total")
        if planned:
            hits = _counter_sum(merged, "tmx_schedule_plan_hit_total")
            rate = hits / planned if planned else 0.0
            line = (f"pack: planned {int(planned)} batch(es)  rung hits "
                    f"{int(hits)} [{_bar(rate, 16)}] {rate * 100:.0f}%")
            pskew = _gauges(merged, "tmx_predicted_work_skew")
            if pskew:
                line += (f"  predicted skew "
                         f"{pskew[0].get('value', 0.0):.1f} objects")
            lines.append(line)

        # ---- per-device utilization bars: each device's last batch wall
        # time relative to the slowest device (1.0 == the straggler)
        dev = _gauges(merged, "tmx_device_batch_seconds")
        if dev:
            slowest = max(g.get("value", 0.0) for g in dev) or 1.0
            lines.append("devices (last batch wall time, relative to "
                         "slowest):")
            for g in sorted(dev, key=lambda g: (
                    g["labels"].get("host", ""),
                    # numeric device-id order when possible
                    (g["labels"].get("device", "") or "").zfill(6))):
                labels = g["labels"]
                t = g.get("value", 0.0)
                name = f"{labels.get('host', '')}/d{labels.get('device')}"
                lines.append(
                    f"  {name:<14} [{_bar(t / slowest)}] {t * 1e3:8.1f}ms"
                )

        # ---- straggler skew
        for g in _gauges(merged, "tmx_straggler_skew_seconds"):
            host = g["labels"].get("host", "")
            tag = f" [{host}]" if host else ""
            lines.append(
                f"straggler skew{tag}: {g.get('value', 0.0) * 1e3:.1f}ms "
                f"(step {g['labels'].get('step', '?')})"
            )
        n_straggle = _counter_sum(merged, "tmx_stragglers_total")
        if n_straggle:
            lines.append(f"stragglers flagged: {int(n_straggle)}")

        coll = [h for h in merged.get("histograms", [])
                if h.get("name") == "tmx_collective_seconds"]
        for h in coll:
            lines.append(
                f"collective: {h['labels'].get('collective', '?'):<24} "
                f"n={h.get('count', 0)} p50={h.get('p50', 0) * 1e3:.1f}ms "
                f"p95={h.get('p95', 0) * 1e3:.1f}ms"
            )

        # ---- WARM row: the cold-start plane (aotstore) — critical-path
        # compiles vs speculative/imported executables, and the compile
        # seconds the store gave back
        cold = _counter_sum(merged, "tmx_compile_cold_total")
        spec = _counter_sum(merged, "tmx_compile_warm_total")
        imp = _counter_sum(merged, "tmx_compile_import_hit_total")
        exp = _counter_sum(merged, "tmx_compile_export_total")
        if cold or spec or imp or exp:
            line = (f"warm: compiles cold {int(cold)} warm {int(spec)} "
                    f"imported {int(imp)} exported {int(exp)}")
            saved = _gauges(merged, "tmx_compile_seconds_saved_total")
            if saved:
                line += f"  saved {saved[0].get('value', 0.0):.1f}s"
            ttfb = _gauges(merged, "tmx_time_to_first_batch_seconds")
            if ttfb:
                line += f"  first batch {ttfb[0].get('value', 0.0):.2f}s"
            lines.append(line)
    else:
        lines.append("metrics: no snapshot yet (telemetry off, or first "
                     "snapshot not written)")

    # ---- data quality: one line from the run's qc.json profile(s)
    qc = view.get("qc")
    if qc:
        guards = qc.get("guards") or {}
        nan_cols = len(guards.get("nan_columns") or [])
        flagged = int(qc.get("flagged_total") or 0)
        worst = None
        for metrics in (qc.get("channels") or {}).values():
            v = (metrics.get("focus_tenengrad") or {}).get("min")
            if v is not None and (worst is None or v < worst):
                worst = v
        bits = [f"flagged {flagged}", f"nan cols {nan_cols}"]
        if worst is not None:
            bits.append(f"worst focus {worst:.4g}")
        flag = ("  ** NON-FINITE FEATURES — inspect with tmx qc **"
                if nan_cols else "")
        lines.append("qc: " + "  ".join(bits) + flag)

    # ---- SERVE panel: admission queue + per-tenant accounting
    srv = view.get("serve")
    if srv:
        live = "LIVE" if srv.get("live") else "stopped"
        status = srv.get("status") or {}
        depth = status.get("depth", 0)
        high = status.get("high_watermark") or 1
        line = (f"serve [{live}]: queue [{_bar(depth / high, 16)}] "
                f"{depth}/{status.get('high_watermark', '?')}")
        if status.get("shedding"):
            line += "  ** SHEDDING **"
        age = status.get("oldest_job_age_s")
        if age is not None:
            line += f"  oldest {age:.1f}s"
        lines.append(line)
        live_tenants = status.get("tenants") or {}
        ledger_tenants = srv.get("tenants") or {}
        for name in sorted(set(live_tenants) | set(ledger_tenants)):
            lt = live_tenants.get(name, {})
            gt = ledger_tenants.get(name, {})
            lines.append(
                f"  tenant {name:<12} queued {lt.get('queued', 0):<3d} "
                f"admitted {gt.get('admitted', lt.get('admitted', 0)):<4d} "
                f"rejected {gt.get('rejected', lt.get('rejected', 0)):<4d} "
                f"done {gt.get('done', 0):<4d} "
                f"budget {lt.get('retry_budget_remaining', '-')} "
                f"breaker {lt.get('breaker', '-')}"
            )
        # ---- QUERY row: analytics serving — cache mix, index routing,
        # fusion, and query latency from the done-event extras
        q = srv.get("queries")
        if q:
            cache = q.get("cache") or {}
            cache_txt = " ".join(
                f"{name} {cache[name]}"
                for name in ("miss", "fused", "hit") if cache.get(name)
            ) or "-"
            index = q.get("index") or {}
            index_txt = " ".join(
                f"{name} {count}" for name, count in sorted(index.items())
            ) or "-"
            line = (f"  query jobs {q.get('total', 0):<4d} "
                    f"cache [{cache_txt}]  index [{index_txt}]")
            if q.get("fusion_events"):
                line += (f"  fused {q['fusion_jobs']} jobs/"
                         f"{q['fusion_events']} sweeps")
            if q.get("index_builds") or q.get("index_hits"):
                line += (f"  idx build {q.get('index_builds', 0)}"
                         f"/hit {q.get('index_hits', 0)}")
            if q.get("index_fallbacks"):
                line += f"  ** {q['index_fallbacks']} INDEX FALLBACKS **"
            el = q.get("elapsed_s")
            if el and el.get("p95") is not None:
                line += f"  p95 {el['p95']:.3f}s"
            lines.append(line)
        if srv.get("preemptions"):
            lines.append(f"  serve preemptions: {srv['preemptions']} "
                         "(drained + re-spooled)")
        # ---- FLEET row: per-host liveness/leases + reclaim/affinity
        fleet = srv.get("fleet") or {}
        fhosts = fleet.get("hosts") or {}
        if fhosts:
            aff = fleet.get("affinity") or {}
            rate = aff.get("hit_rate")
            host_bits = []
            for name in sorted(fhosts):
                h = fhosts[name]
                age = h.get("heartbeat_age_s")
                host_bits.append(
                    f"{name}"
                    f"[{'live' if h.get('live') else 'DEAD'}"
                    + (f" hb {age:.0f}s" if age is not None else "")
                    + f" leases {h.get('leases', 0)}]")
            lines.append(
                "  fleet " + " ".join(host_bits)
                + f"  reclaims {fleet.get('reclaims_total', 0)}"
                + f"  stale {fleet.get('stale_claims_total', 0)}"
                + "  affinity "
                + (f"{rate:.0%}" if rate is not None else "-"))
        # ---- WARM row: the fleet-shared executable store + this spool's
        # ledger-replayed import/cold split (DESIGN.md §28)
        warm = srv.get("warm") or {}
        pub = warm.get("published") or {}
        if (warm.get("entries") or warm.get("compile_imports")
                or warm.get("compiles_cold")):
            line = (f"  WARM store {warm.get('entries', 0)} entries "
                    f"{_fmt_bytes(warm.get('bytes', 0))}")
            if warm.get("stale_entries"):
                line += f" ({warm['stale_entries']} stale)"
            line += (f"  imports {warm.get('compile_imports', 0)}"
                     f"  cold {warm.get('compiles_cold', 0)}")
            if pub.get("seconds_saved"):
                line += f"  saved {pub['seconds_saved']:.1f}s"
            lines.append(line)
        # ---- SLO panel: per-tenant latency/availability vs objective
        slo_view = srv.get("slo") or {}
        waits = srv.get("queue_wait_s") or {}
        for name, t in sorted((slo_view.get("tenants") or {}).items()):
            p95 = t.get("latency_p95_s")
            obj = t.get("objectives") or {}
            avail = t.get("availability")
            wait_p95 = (waits.get(name) or {}).get("p95")
            burn_flag = "  ** SLO BURN **" if t.get("breach") else ""
            p95_txt = "-" if p95 is None else f"{p95:.3f}s"
            avail_txt = "-" if avail is None else f"{avail:.2%}"
            wait_txt = "-" if wait_p95 is None else f"{wait_p95:.3f}s"
            lines.append(
                f"  slo {name:<12} "
                f"p95 {p95_txt}/{float(obj.get('latency_p95_s', 0)):g}s "
                f"avail {avail_txt}/{float(obj.get('availability', 0)):.2%} "
                f"wait p95 {wait_txt} "
                f"burn {t.get('burn')}{burn_flag}"
            )
        # ---- CANARY row: per-host black-box probe health
        can = srv.get("canary") or {}
        if can.get("probes") or can.get("ok") or can.get("failed"):
            lat = can.get("latency_s") or {}
            p95 = lat.get("p95")
            lines.append(
                f"  canary probes {can.get('probes', 0)} "
                f"ok {can.get('ok', 0)} failed {can.get('failed', 0)} "
                f"degraded {can.get('degraded', 0)} "
                + ("lat p95 -" if p95 is None else f"lat p95 {p95:.3f}s"))
        # ---- ANOMALY row: latched detector hits per signal stream
        anom = srv.get("anomalies") or {}
        if anom:
            total = sum(anom.values())
            per = " ".join(f"{m}:{n}" for m, n in sorted(anom.items()))
            lines.append(f"  ANOMALY x{total}  {per}")

    # ---- breaker / degradation state
    deg = view["degraded"]
    if deg:
        lines.append(
            f"DEGRADED: backend fell back to {deg.get('backend')} at "
            f"'{deg.get('where')}' after {deg.get('failures')} failed "
            "device probes"
        )

    # ---- preemption drain boundary (cleared by the next run_started)
    pre = view.get("preempted")
    if pre:
        lines.append(
            f"PREEMPTED ({pre.get('reason', 'signal')}): drained "
            f"{pre.get('drained', 0)}/{pre.get('in_flight', 0)} in-flight "
            f"at '{pre.get('step')}', abandoned {pre.get('abandoned', 0)} "
            "— resume with `tmx workflow submit --resume`"
        )
    return "\n".join(lines) + "\n"


def run_top(root: Path, interval: float = 2.0, once: bool = False,
            iterations: int | None = None,
            out: TextIO | None = None, as_json: bool = False) -> int:
    """Dashboard loop.  ``once`` renders a single frame (tests/CI);
    ``iterations`` bounds the loop for tests; ``as_json`` emits one
    machine-readable ``collect_fleet`` view instead of the text frame
    (implies a single frame); Ctrl-C exits cleanly."""
    out = out or sys.stdout
    root = Path(root)
    if not _workflow_dir(root).is_dir():
        print(f"error: no workflow directory under {root}",
              file=sys.stderr)
        return 1
    if as_json:
        import json

        out.write(json.dumps(collect_fleet(root), indent=2, default=str)
                  + "\n")
        out.flush()
        return 0
    n = 0
    try:
        while True:
            frame = render_dashboard(collect_fleet(root))
            if once or iterations is not None:
                out.write(frame)
            else:
                # ANSI clear + home, then the frame — a repaint, not a
                # scroll, but still plain text when piped to a file
                out.write("\x1b[2J\x1b[H" + frame)
            out.flush()
            n += 1
            if once or (iterations is not None and n >= iterations):
                return 0
            time.sleep(interval)
    except KeyboardInterrupt:
        return 0
