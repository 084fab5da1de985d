"""The port's SLO accounting, anomaly detector, time series and QC
telemetry mirror against the JAX package's.

Seeded serve-ledger streams (numpy) with per-tenant latencies, failures,
expiries, canary probes (some degraded), queue waits, scheduling delays,
reclaims and burns go through both packages: ``slo.report`` (at several
``now``), ``breaches``, ``exit_code``, ``render``, ``canary_report``,
``quantile``, ``canary.signal_samples`` and ``anomaly_report`` (and its
prefix stability), objectives from the environment, probe specs and
checksums.  The time series: the same registry snapshots flushed by both
packages give the same ``tsdb.<host>.jsonl`` records, compaction,
merges, series, rates, quantiles, sparklines and the ledger fallback.
The QC session's registry mirror sets the reference's series.
"""

import json

import numpy as np
import pytest

from test_torch_telemetry import synthetic_events
from tmlibrary_tpu import canary as j_canary
from tmlibrary_tpu import qc as j_qc
from tmlibrary_tpu import slo as j_slo
from tmlibrary_tpu import telemetry as j_tel
from tmlibrary_tpu import timeseries as j_ts
from tmlibrary_tpu_torch import canary, qc, slo, telemetry, timeseries


def serve_stream(seed: int, n: int = 120, hosts=("host0",)) -> list[dict]:
    """Job completions and canary probes with a latency step part way."""
    rng = np.random.default_rng(seed)
    ts, out = 1_700_000_000.0, []
    for i in range(n):
        ts += float(rng.uniform(1, 120))
        host = hosts[i % len(hosts)]
        hl = {"host": host} if len(hosts) > 1 else {}
        step = 8.0 if i > n * 0.7 else 1.0
        tenant = str(rng.choice(["prod", "dev", "batch"]))
        r = rng.uniform()
        if r < 0.25:
            out.append({"event": "job_done", "kind": "canary", "tenant": "_canary",
                        "elapsed_s": round(float(rng.uniform(0.01, 0.03) * step), 3),
                        "degraded": bool(rng.uniform() < 0.1), "ts": ts, **hl})
        elif r < 0.35:
            out.append({"event": "job_failed", "tenant": tenant, "ts": ts, **hl})
        elif r < 0.4:
            out.append({"event": "job_expired", "tenant": tenant, "ts": ts, **hl})
        elif r < 0.45:
            out.append({"event": "job_reclaimed", "tenant": tenant, "job": f"j{i}",
                        "ts": ts, **hl})
        elif r < 0.5:
            out.append({"event": "slo_burn", "tenant": tenant, "window": 3600.0,
                        "burn": float(rng.uniform(0, 40)), "ts": ts, **hl})
        else:
            out.append({"event": "job_admitted", "tenant": tenant, "ts": ts,
                        "queue_wait_s": round(float(rng.uniform(0, 3) * step), 3), **hl})
            out.append({"event": "job_started", "tenant": tenant, "ts": ts + 0.1,
                        "sched_delay_s": round(float(rng.uniform(0, 1)), 3), **hl})
            out.append({"event": "job_done", "tenant": tenant, "ts": ts + 0.2,
                        "elapsed_s": round(float(rng.lognormal(1, 1) * step), 3), **hl})
    return out


STREAMS = [(0, ("host0",)), (1, ("h0", "h1")), (2, ("host0",))]


@pytest.mark.parametrize("seed,hosts", STREAMS)
def test_slo_reports_equal_the_references(seed, hosts, monkeypatch):
    events = serve_stream(seed, hosts=hosts) + synthetic_events(seed)
    end = max(e["ts"] for e in events)
    for now in (end, end + 3000.0, end + 30_000.0):
        ours = slo.report(events, now=now)
        ref = j_slo.report(events, now=now)
        assert ours == ref
        assert slo.breaches(ours) == j_slo.breaches(ref)
        assert slo.exit_code(ours) == j_slo.exit_code(ref)
        assert slo.render(ours) == j_slo.render(ref)
    assert slo.canary_report(events) == j_slo.canary_report(events)
    assert slo.job_completions(events) == j_slo.job_completions(events)
    values = [float(v) for v in np.random.default_rng(seed).lognormal(size=37)]
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert slo.quantile(values, q) == j_slo.quantile(values, q)
    assert slo.quantile([], 0.5) == j_slo.quantile([], 0.5)
    # objectives from the environment, per tenant
    monkeypatch.setenv("TMX_SLO_LATENCY_P95_S", "2.5")
    monkeypatch.setenv("TMX_SLO_AVAILABILITY_PROD", "0.5")
    monkeypatch.setenv("TMX_SLO_WINDOWS", "60,600")
    for tenant in ("prod", "dev"):
        assert slo.objectives(tenant).to_dict() == j_slo.objectives(tenant).to_dict()
    assert slo.report(events, now=end) == j_slo.report(events, now=end)


@pytest.mark.parametrize("seed,hosts", STREAMS)
def test_anomaly_reports_equal_the_references(seed, hosts):
    events = serve_stream(seed, hosts=hosts)
    assert canary.signal_samples(events) == j_canary.signal_samples(events)
    ours = canary.anomaly_report(events)
    assert ours == j_canary.anomaly_report(events)
    assert ours  # the latency step is detected
    half = events[: len(events) // 2]
    prefix = canary.anomaly_report(half)
    assert ours[: len(prefix)] == prefix  # prefix-stable
    for kw in ({"alpha": 0.5}, {"min_samples": 3}, {"threshold": 2.0}):
        assert canary.anomaly_report(events, **kw) == j_canary.anomaly_report(events, **kw)


def test_probe_specs_and_checksums_equal_the_references(tmp_path):
    for seq in range(5):
        a = canary.make_probe_spec(tmp_path, "h0", seq, now=1000.5 + seq)
        b = j_canary.make_probe_spec(tmp_path, "h0", seq, now=1000.5 + seq)
        assert a.to_dict() == b.to_dict()
        assert canary.run_probe(a.payload) == j_canary.run_probe(b.payload)
    assert canary.CANARY_KIND == j_canary.CANARY_KIND


def snapshots(seed: int, n: int = 6) -> list[dict]:
    rng = np.random.default_rng(seed)
    reg = telemetry.MetricsRegistry(enabled=True)
    out = []
    for i in range(n):
        for t in ("prod", "dev"):
            reg.counter("tmx_serve_jobs_done_total", tenant=t).inc(float(rng.integers(0, 4)))
            reg.histogram("tmx_serve_job_seconds", tenant=t).observe(float(rng.uniform(0, 9)))
        reg.gauge("tmx_serve_queue_depth").set(float(rng.integers(0, 16)))
        snap = reg.snapshot()
        snap["captured_at"] = 1_700_000_000.0 + 400.0 * i
        out.append(snap)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_time_series_segments_equal_the_references(seed, tmp_path):
    snaps = snapshots(seed)
    for mod, name in ((timeseries, "port"), (j_ts, "ref")):
        for host in ("host0", "h1"):
            store = mod.TimeSeriesStore(tmp_path / name, host=host)
            for snap in snaps:
                store.record_snapshot(snap, ts=snap["captured_at"])
    for host in ("host0", "h1"):
        a = timeseries.tsdb_path(tmp_path / "port", host)
        b = j_ts.tsdb_path(tmp_path / "ref", host)
        assert a.name == b.name and a.read_text() == b.read_text()
    ours, ref = timeseries.load_tsdb(tmp_path / "port"), j_ts.load_tsdb(tmp_path / "ref")
    assert ours == ref
    merged = timeseries.merge_tsdb(ours)
    assert merged == j_ts.merge_tsdb(ref)
    now = snaps[-1]["captured_at"] + 9000.0
    assert timeseries.compact_records(merged, now, retention_s=3000.0) == \
        j_ts.compact_records(merged, now, retention_s=3000.0)
    series = timeseries.series_index(merged)
    assert series == j_ts.series_index(merged)
    for points in series.values():
        assert timeseries.rate(points) == j_ts.rate(points)
        assert timeseries.rate(points, 900.0) == j_ts.rate(points, 900.0)
        assert timeseries.delta(points) == j_ts.delta(points)
        assert timeseries.quantile_over_time(points, 0.95) == \
            j_ts.quantile_over_time(points, 0.95)
        assert timeseries.sparkline([v for _, v in points], 12) == \
            j_ts.sparkline([v for _, v in points], 12)
    events = synthetic_events(seed, ("h0", "h1"))
    assert timeseries.synthesize_from_ledger(events) == j_ts.synthesize_from_ledger(events)


def test_flush_registry_writes_the_references_records(tmp_path, monkeypatch):
    for mod, tel, name in ((timeseries, telemetry, "port"), (j_ts, j_tel, "ref")):
        tel.reset_registry(enabled=True)
        reg = tel.get_registry()
        reg.counter("tmx_runs_total").inc(3)
        reg.gauge("tmx_serve_queue_depth", host="h0").set(4)
        mod.flush_registry(tmp_path / name, host="host0", now=1_700_000_000.0)
        tel.reset_registry()
    strip = lambda p: [{k: v for k, v in json.loads(line).items() if k != "ts"}
                       for line in p.read_text().splitlines()]
    assert strip(timeseries.tsdb_path(tmp_path / "port", "host0")) == \
        strip(j_ts.tsdb_path(tmp_path / "ref", "host0"))


def test_the_qc_mirror_sets_the_references_series():
    rng = np.random.default_rng(3)
    sites = [0, 1, 2]
    image_stats = {"DAPI": {k: rng.uniform(0, 1, 3).astype(np.float32)
                            for k in ("focus_tenengrad", "saturation_frac", "background")}}
    counts = {"nuclei": np.array([3, 0, 5], np.int32)}
    measurements = {"nuclei": {"Intensity_mean": rng.uniform(0, 9, (3, 6)).astype(np.float32)}}
    snaps = []
    for mod, tel in ((qc, telemetry), (j_qc, j_tel)):
        tel.reset_registry(enabled=True)
        session = mod.QCSession()
        session.observe_batch("jterator", sites, image_stats=image_stats, counts=counts,
                              measurements=measurements, saturated=False)
        session.observe_illumination("DAPI", [1.0, 99.9], [10.0, 900.0])
        snap = tel.get_registry().snapshot()
        snap.pop("captured_at"), snap.pop("sequence")
        snaps.append(snap)
        tel.reset_registry()
    assert snaps[0] == snaps[1]
    assert {g["name"] for g in snaps[0]["gauges"]} >= {"tmx_qc_worst_focus",
                                                        "tmx_qc_illum_p_top"}
