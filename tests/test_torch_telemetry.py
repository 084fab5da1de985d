"""The port's telemetry, fault and trace layers against the JAX package's.

Seeded event streams (numpy) shaped like run and serve ledgers -- batch,
step, span, QC, straggler, watchdog, job lifecycle, fleet and query
events, with and without fleet ``host`` labels -- go through both
packages: ``registry_from_ledger`` rendered with ``render_prometheus``
(byte for byte) and ``render_json``, ``parse_prometheus`` round trips,
``merge_snapshots``, ``build_span_tree`` + ``annotate_critical_path``,
``phase_totals``, ``traceexport.chrome_trace`` JSON and the fault plans'
firing sequences.  Then the live layers: the registry's instruments, the
flight recorder, heartbeats, the resource sampler on the CPU, trace
context, ``call_with_timeout``, ``CircuitBreaker``, preemption and
``PhaseWatchdog``, and the engine with telemetry on: the same store as
with telemetry off, bit for bit, and the reference's span events.
"""

import json
import shutil
import time

import numpy as np
import pytest
import torch

from tmlibrary_tpu import faults as j_faults
from tmlibrary_tpu import resilience as j_resilience
from tmlibrary_tpu import telemetry as j_tel
from tmlibrary_tpu import traceexport as j_trace
from tmlibrary_tpu_torch import aotstore, faults, resilience, telemetry, timeseries, traceexport
from tmlibrary_tpu_torch.errors import FaultInjected, ProbeTimeoutError, WatchdogTimeout

torch.set_num_threads(1)

TENANTS = ("prod", "dev")
STEPS = ("metaconfig", "imextract", "jterator")
PHASES = ("prefetch_wait", "dispatch", "device_block", "persist")


def synthetic_events(seed: int, hosts=(None,), n_jobs: int = 12) -> list[dict]:
    """A ledger-shaped event stream from a seed: one run per host with
    spans for run, steps, batches and phases, QC and straggler evidence,
    then serve lifecycle events for ``n_jobs`` jobs."""
    rng = np.random.default_rng(seed)
    ts = 1_700_000_000.0
    out: list[dict] = []

    def emit(**ev):
        nonlocal ts
        ts += float(rng.uniform(0.001, 0.5))
        ev["ts"] = round(ts, 6)
        out.append(ev)

    for host in hosts:
        hl = {"host": host} if host else {}
        emit(event="run_started", description_hash="abc", resume=False, **hl)
        for step in STEPS:
            emit(step=step, event="init_done", n_batches=3, **hl)
            for b in range(3):
                for ph in PHASES:
                    emit(step=step, event="span", span=ph, batch=b, t0=ts,
                         elapsed=round(float(rng.uniform(0, 0.2)), 6),
                         resource="device" if ph in ("dispatch", "device_block") else "host",
                         **hl)
                emit(step=step, event="span", span="batch", batch=b, t0=ts,
                     elapsed=round(float(rng.uniform(0.1, 1)), 6), **hl)
                result = {"n_sites": int(rng.integers(1, 9)),
                          "objects": {"nuclei": int(rng.integers(0, 50))},
                          "bucket_capacity": int(rng.choice([16, 32])),
                          "slot_occupancy": round(float(rng.uniform(0, 1)), 4)}
                if rng.uniform() < 0.3:
                    result["qc"] = {"flagged_total": int(rng.integers(0, 3)),
                                    "nan_columns": 0, "worst_focus": 1.5,
                                    "count_z_max": 0.5}
                emit(step=step, event="batch_done", batch=b,
                     elapsed=round(float(rng.uniform(0.1, 1)), 6),
                     attempts=int(rng.integers(1, 3)), result=result, **hl)
                if rng.uniform() < 0.3:
                    emit(step=step, event="straggler", batch=b, skew_s=0.2,
                         device_wall_times={"0": 0.1, "1": 0.3}, **hl)
            if rng.uniform() < 0.2:
                emit(step=step, event="batch_failed", batch=2, error="x",
                     exception="OSError", attempts=3, classification="transient", **hl)
                emit(step=step, event="step_partial", elapsed=2.0, quarantined=[2], **hl)
            else:
                emit(step=step, event="step_done", elapsed=round(float(rng.uniform(1, 3)), 6),
                     pipeline_stats={"depth": 2, "source": "default", "n_batches": 3,
                                     "phases": {"dispatch": {"total_s": 0.5, "max_s": 0.2,
                                                             "count": 3}}},
                     **hl)
            emit(step=step, event="span", span="step", path="run/step", t0=ts,
                 elapsed=round(float(rng.uniform(1, 3)), 6), **hl)
        emit(step="jterator", event="first_batch", first_batch_index=0,
             time_to_first_batch_s=1.25, **hl)
        emit(step="jterator", event="watchdog", phase="block", batch=1, budget_s=1.0,
             elapsed_s=1.5, **hl)
        emit(event="span", span="run", path="run", t0=ts, elapsed=9.5, **hl)
        emit(event="serve_started", recovered=0, lease_s=15.0, max_queue=16, **hl)
        for j in range(n_jobs):
            tenant = TENANTS[int(rng.integers(0, 2))]
            tag = {"job": f"{host}-{j}", "tenant": tenant, "trace_id": f"t{j}", **hl}
            fate = rng.uniform()
            if fate < 0.15:
                emit(event="job_rejected", reason=str(rng.choice(
                    ["queue_full", "tenant_quota", "retry_budget", "duplicate"])),
                    retry_after_s=5.0, **tag)
                continue
            emit(event="span", span="queue_wait", t0=ts, elapsed=0.25, **tag)
            emit(event="job_admitted", attempt=0, epoch=1,
                 queue_wait_s=round(float(rng.uniform(0, 2)), 3),
                 affinity=str(rng.choice(["hit", "miss"])), **tag)
            emit(event="job_started", attempt=0,
                 sched_delay_s=round(float(rng.uniform(0, 1)), 3), **tag)
            elapsed = round(float(rng.uniform(0.5, 30)), 3)
            emit(event="span", span="job", path="job", t0=ts - elapsed, elapsed=elapsed,
                 attempt=0, **tag)
            if fate < 0.25:
                emit(event="job_failed", error="boom", exception="WorkflowError", **tag)
            elif fate < 0.32:
                emit(event="job_expired", step="jterator", **tag)
            elif fate < 0.45:
                emit(event="job_done", kind="query", tool="knn",
                     cache=str(rng.choice(["hit", "miss", "fused"])),
                     query_elapsed_s=0.125, elapsed_s=elapsed, epoch=1,
                     index="ivf", index_cache="build", **tag)
            else:
                emit(event="job_done", elapsed_s=elapsed, epoch=1, resumed=False,
                     compiles_cold=int(rng.integers(0, 3)), **tag)
        emit(event="job_requeued", job="x", tenant="prod", phase="drain", **hl)
        emit(event="job_reclaimed", job="y", tenant="dev", from_host="h9", epoch=2,
             attempt=0, **hl)
        emit(event="stale_claim", job="y", tenant="dev", epoch=1, outcome="done", **hl)
        emit(event="query_fused", job="q", tenant="dev", window=3, jobs=["a", "b"], **hl)
        emit(event="slo_burn", tenant="dev", window=3600.0, burn=2.5, **hl)
        emit(event="anomaly", metric="canary_latency", stream_host="host0", seq=4, **hl)
        emit(event="serve_preempted", reason="SIGTERM", requeued=2, **hl)
        emit(event="run_preempted", step="jterator", reason="SIGTERM", in_flight=2,
             drained=2, abandoned=1, **hl)
    return out


STREAMS = [(0, (None,)), (1, ("h0", "h1")), (2, (None,)), (3, ("h0",))]


@pytest.mark.parametrize("seed,hosts", STREAMS)
def test_ledger_metrics_render_as_the_references_byte_for_byte(seed, hosts):
    events = synthetic_events(seed, hosts)
    ours = telemetry.registry_from_ledger(events).snapshot()
    ref = j_tel.registry_from_ledger(events).snapshot()
    assert telemetry.render_prometheus(ours) == j_tel.render_prometheus(ref)
    strip = lambda s: {k: v for k, v in s.items() if k not in ("captured_at", "sequence")}
    assert json.loads(telemetry.render_json(strip(ours))) == \
        json.loads(j_tel.render_json(strip(ref)))
    text = telemetry.render_prometheus(ours)
    assert telemetry.parse_prometheus(text) == j_tel.parse_prometheus(text)
    # a round trip through the text keeps every sample
    again = telemetry.parse_prometheus(telemetry.render_prometheus(ours))
    assert len(again) == len(text.strip().splitlines()) - text.count("# TYPE")


@pytest.mark.parametrize("seed,hosts", STREAMS)
def test_span_trees_and_phase_totals_equal_the_references(seed, hosts):
    events = synthetic_events(seed, hosts)
    ours = telemetry.annotate_critical_path(telemetry.build_span_tree(events))
    ref = j_tel.annotate_critical_path(j_tel.build_span_tree(events))
    assert ours == ref
    assert telemetry.render_span_tree(ours) == j_tel.render_span_tree(ref)
    assert telemetry.phase_totals(events) == j_tel.phase_totals(events)


@pytest.mark.parametrize("seed,hosts", STREAMS)
def test_chrome_traces_equal_the_references(seed, hosts):
    events = synthetic_events(seed, hosts)
    ours = traceexport.chrome_trace(events)
    assert json.dumps(ours, sort_keys=True) == json.dumps(j_trace.chrome_trace(events),
                                                          sort_keys=True)
    assert traceexport.validate_chrome_trace(ours) == []
    flows = {e["id"] for e in ours["traceEvents"] if e.get("ph") == "s"}
    assert flows  # one flow a trace id with more than one event
    one = traceexport.chrome_trace(events, trace_id="t1")
    assert one == j_trace.chrome_trace(events, trace_id="t1")


def test_merged_snapshots_equal_the_references():
    rng = np.random.default_rng(5)
    pairs = []
    for h in ("host0", "host1", "host1"):
        reg = telemetry.MetricsRegistry(enabled=True)
        for i in range(6):
            reg.counter("tmx_c", step=f"s{i % 2}").inc(float(rng.integers(1, 5)))
            reg.gauge("tmx_g", step=f"s{i % 3}").set(float(rng.uniform()))
            reg.histogram("tmx_h", step="s0").observe(float(rng.uniform()))
        reg.gauge("tmx_dev", device="0", host="hx").set(1.0)
        snap = reg.snapshot()
        snap["captured_at"] = 100.0 + len(pairs)
        pairs.append((h, snap))
    assert telemetry.merge_snapshots(pairs) == j_tel.merge_snapshots(pairs)
    merged = telemetry.merge_snapshots(pairs)
    assert telemetry.render_prometheus(merged) == j_tel.render_prometheus(merged)


def test_live_instruments_snapshot_as_the_references():
    ours, ref = telemetry.MetricsRegistry(enabled=True), j_tel.MetricsRegistry(enabled=True)
    rng = np.random.default_rng(11)
    values = rng.uniform(0, 3, size=700)
    for reg in (ours, ref):
        for i, v in enumerate(values):
            reg.counter("tmx_a_total", tenant=TENANTS[i % 2]).inc(float(v))
            reg.gauge("tmx_b", step="x").set(float(v))
            reg.histogram("tmx_c_seconds", step="x").observe(float(v))
        reg.throughput("tmx_rate").add(5, 2.0)
    a, b = ours.snapshot(), ref.snapshot()
    for s in (a, b):
        s.pop("captured_at"), s.pop("sequence")
    assert a == b
    off = telemetry.MetricsRegistry(enabled=False)
    off.counter("x").inc()
    off.histogram("y").observe(1.0)
    assert off.snapshot()["counters"] == [] and off.snapshot()["histograms"] == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fault_plans_fire_as_the_references(seed):
    rng = np.random.default_rng(seed)
    specs = [{"site": str(rng.choice(["batch_run", "persist", "admission", "claim"])),
              "kind": str(rng.choice(["device_loss", "io_error", "crash"])),
              "step": str(rng.choice(["jterator", "prod", ""])) or None,
              "batch": int(rng.integers(0, 6)) if rng.uniform() < 0.5 else None,
              "event": f"j{int(rng.integers(0, 4))}" if rng.uniform() < 0.3 else None,
              "probability": float(rng.choice([1.0, 0.5])),
              "times": int(rng.integers(1, 4))} for _ in range(4)]
    plan_doc = {"faults": [{k: v for k, v in s.items() if v is not None} for s in specs],
                "seed": seed}
    calls = [(str(rng.choice(["batch_run", "persist", "admission", "claim"])),
              {"step": str(rng.choice(["jterator", "prod"])), "batch": int(rng.integers(0, 6)),
               "event": f"j{int(rng.integers(0, 4))}"}) for _ in range(60)]
    seqs = []
    for mod in (faults, j_faults):
        plan = mod.FaultPlan.from_dict(plan_doc)
        seq = []
        for site, ctx in calls:
            spec = plan.match(site, **ctx)
            seq.append(None if spec is None else (spec.site, spec.kind, spec.fired))
        seqs.append((seq, plan.fire_counts(), plan.forces_sequential()))
    assert seqs[0] == seqs[1]
    assert any(s is not None for s in seqs[0][0])


def test_fault_kinds_raise_the_references_classes(monkeypatch):
    for kind, cls in (("device_loss", "TransientDeviceError"), ("io_error", "OSError"),
                      ("crash", "FaultInjected"), ("crash_append", "FaultInjected")):
        plan = faults.FaultPlan.from_dict({"faults": [{"site": "batch_run", "kind": kind}]})
        faults.install(plan)
        try:
            with pytest.raises(Exception) as err:
                faults.maybe_fire("batch_run", step="a", batch=0)
            assert type(err.value).__name__ == cls
            assert resilience.classify(err.value) == ("permanent" if kind.startswith("crash")
                                                      else "transient")
        finally:
            faults.clear()
    monkeypatch.setenv("TMX_FAULT_PLAN", json.dumps({"faults": [{"site": "enqueue",
                                                                 "kind": "io_error"}]}))
    monkeypatch.setattr(faults, "_ENV_CHECKED", False)  # a fresh process reads the plan
    with pytest.raises(OSError):
        faults.maybe_fire("enqueue", step="t", event="j")
    monkeypatch.delenv("TMX_FAULT_PLAN")
    faults.clear()


def test_flight_recorder_heartbeat_and_trace_context(tmp_path, monkeypatch):
    monkeypatch.setenv("TMX_FLIGHTREC_N", "8")
    telemetry.reset_flight_recorder()
    for i in range(20):
        telemetry.flight_record({"event": "x", "i": i})
    assert [e["i"] for e in telemetry.flight_events()] == list(range(12, 20))
    path = telemetry.flight_dump(telemetry.flightrec_path(tmp_path), reason="test")
    dump = json.loads(open(path).read())
    assert dump["reason"] == "test" and len(dump["events"]) == 8
    telemetry.reset_flight_recorder()
    assert telemetry.flight_dump(tmp_path / "none.json") is None
    hb = telemetry.heartbeat_path(tmp_path)
    assert hb == j_tel.heartbeat_path(tmp_path)
    telemetry.write_heartbeat(hb, 1.0, extra={"queue_depth": 3})
    assert telemetry.heartbeat_age(hb) < 5
    assert j_tel.read_heartbeat(hb)["queue_depth"] == 3
    monkeypatch.setenv("TMX_HOST_ID", "h7")
    assert telemetry.host_id() == "h7" and telemetry.fleet_active()
    assert telemetry.heartbeat_path(tmp_path) == j_tel.heartbeat_path(tmp_path)
    assert telemetry.snapshot_path(tmp_path) == j_tel.snapshot_path(tmp_path)
    monkeypatch.delenv("TMX_HOST_ID")
    assert telemetry.host_id() == "host0" and not telemetry.fleet_active()
    with telemetry.trace_scope(trace_id="t", job="j", tenant=None):
        assert telemetry.trace_context() == {"trace_id": "t", "job": "j"}
        with telemetry.trace_scope(tenant="p"):
            assert telemetry.trace_context() == {"trace_id": "t", "job": "j", "tenant": "p"}
    assert telemetry.trace_context() == {}



def test_a_failed_telemetry_write_raises(tmp_path):
    """The flight dump and the tsdb flush raise where the reference logs
    and goes on: a run whose telemetry did not land fails."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    telemetry.reset_flight_recorder()
    telemetry.flight_record({"event": "x"})
    with pytest.raises(OSError):
        telemetry.flight_dump(blocker / "flightrec.host0.json")
    telemetry.reset_flight_recorder()
    reg = telemetry.reset_registry(enabled=True)
    reg.counter("tmx_runs_total").inc()
    try:
        with pytest.raises(OSError):
            timeseries.flush_registry(blocker / "tsdb", host="host0")
    finally:
        telemetry.reset_registry()


def test_aotstore_reports_the_directory_it_is_given(tmp_path, monkeypatch):
    monkeypatch.delenv("TMX_AOT_STORE_DIR", raising=False)
    monkeypatch.delenv("TM_AOT_STORE_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    aotstore.reset_counts()
    try:
        aotstore.set_process_default_dir(None)
        assert aotstore.store_stats()["dir"] == str(
            tmp_path / "home" / ".cache" / "tmlibrary_tpu_torch" / "aot")
        aotstore.set_process_default_dir(tmp_path / "serve")
        assert aotstore.store_stats()["dir"] == str(tmp_path / "serve")
        assert aotstore.store_stats(tmp_path / "other")["dir"] == str(tmp_path / "other")
        assert aotstore.note_program("p1") and not aotstore.note_program("p1")
        aotstore.note_program("p2")
        # warm digests are the store's entries, most recently used first
        assert aotstore.warm_digests() == []
        assert aotstore.counts_snapshot() == {"cold": 2.0}
        assert aotstore.seconds_saved() == 0.0
    finally:
        aotstore.set_process_default_dir(None)
        aotstore.reset_counts()

def test_resource_sampler_on_the_cpu(tmp_path):
    reg = telemetry.MetricsRegistry(enabled=True)
    sample = telemetry.ResourceSampler(0.1, heartbeat_path=tmp_path / "hb.json",
                                       registry=reg).sample_once()
    assert sample["rss_bytes"] > 0 and sample["open_fds"] > 0
    assert "device_bytes_in_use" not in sample  # no card initialised here
    assert telemetry._device_memory_bytes() is None
    assert telemetry.device_wall_times(time.perf_counter(), "cpu") == []  # one rank
    names = {g["name"] for g in reg.snapshot()["gauges"]}
    assert {"tmx_process_rss_bytes", "tmx_process_open_fds"} <= names
    with telemetry.ResourceSampler(0.05, heartbeat_path=tmp_path / "hb2.json",
                                   registry=reg):
        time.sleep(0.12)
    assert telemetry.read_heartbeat(tmp_path / "hb2.json")["period"] == 0.1


def test_spans_bridge_to_nvtx_only_when_asked(monkeypatch):
    events = []
    was = telemetry.enabled()
    telemetry.set_enabled(True)
    try:
        with telemetry.span("outer", emit=lambda **e: events.append(e)):
            with telemetry.span("inner", emit=lambda **e: events.append(e), batch=3):
                pass
        telemetry.set_trace_bridge(True)  # no card: the bridge stays silent
        with telemetry.span("bridged", emit=lambda **e: events.append(e)):
            pass
        telemetry.set_trace_bridge(False)
        telemetry.set_enabled(False)
        with telemetry.span("off", emit=lambda **e: events.append(e)):
            pass
    finally:
        telemetry.set_enabled(was)
    assert [(e["span"], e["path"]) for e in events] == \
        [("inner", "outer/inner"), ("outer", "outer"), ("bridged", "bridged")]
    assert events[0]["batch"] == 3


def test_timeouts_breakers_preemption_and_watchdog():
    with pytest.raises(ProbeTimeoutError):
        resilience.call_with_timeout(lambda: time.sleep(1), 0.05, "probe")
    assert resilience.call_with_timeout(lambda: 7, 1.0) == 7
    clock = [0.0]
    ours = resilience.CircuitBreaker(failure_threshold=2, cooldown=10, clock=lambda: clock[0])
    ref = j_resilience.CircuitBreaker(failure_threshold=2, cooldown=10, clock=lambda: clock[0])
    states = []
    for step, ok in enumerate([False, False, None, False, None, True, False]):
        clock[0] = step * 6.0
        for b in (ours, ref):
            if ok is True:
                b.record_success()
            elif ok is False:
                b.record_failure()
        states.append((ours.state, ours.allow(), ours.cooldown))
        assert states[-1] == (ref.state, ref.allow(), ref.cooldown)
    assert resilience.EXIT_PREEMPTED == j_resilience.EXIT_PREEMPTED == 75
    resilience.clear_preemption()
    assert not resilience.preemption_requested()
    resilience.request_preemption("SIGTERM")
    resilience.request_preemption("again")  # idempotent
    assert resilience.preemption_requested() and resilience.preemption_reason() == "SIGTERM"
    resilience.clear_preemption()
    wd = resilience.PhaseWatchdog({"block": 0.05, "persist": 0})
    with wd.arm("launch"):
        pass  # unarmed phase
    with pytest.raises(WatchdogTimeout):
        with wd.arm("block", step="jterator", batch=2):
            time.sleep(0.3)
    wd.stop()
    assert [(e["event"], e["phase"], e["batch"]) for e in wd.drain_events()] == \
        [("watchdog", "block", 2)]
    renewed = []
    lr = resilience.LeaseRenewer(lambda: renewed.append(1), period=0.05)
    lr.start()
    time.sleep(0.2)
    lr.stop()
    assert renewed
    assert resilience.watchdog_from_config() is None


def test_watchdog_from_the_environment(monkeypatch):
    monkeypatch.setenv("TMX_WATCHDOG", "1")
    monkeypatch.setenv("TMX_WATCHDOG_BLOCK_S", "0")
    ours, ref = resilience.watchdog_from_config(), j_resilience.watchdog_from_config()
    assert ours.deadlines == ref.deadlines == {"launch": 300.0, "persist": 600.0}
    ours.stop()
    ref.stop()
    assert isinstance(FaultInjected("x"), Exception)


# --------------------------------------------------- the engine, telemetry on
def test_engine_spans_and_bit_identical_stores_with_telemetry_on(tmp_path):
    from test_torch_engine import STEP_ARGS, reset_routers
    from test_torch_workflow_steps import copy_store, make_store
    from tmlibrary_tpu.models.store import ExperimentStore as JStore
    from tmlibrary_tpu.workflow.engine import Workflow as JWorkflow
    from tmlibrary_tpu.workflow.engine import WorkflowDescription as JDescription
    from tmlibrary_tpu_torch.models.store import ExperimentStore
    from tmlibrary_tpu_torch.workflow.engine import RunLedger, Workflow, WorkflowDescription

    make_store(tmp_path / "src")
    desc = WorkflowDescription.canonical(STEP_ARGS)
    desc.save(tmp_path / "wf.json")
    runs = {}
    for name, on in (("on", True), ("off", False), ("ref", True)):
        copy_store(tmp_path / "src", tmp_path / name)
        reset_routers()
        if name == "ref":
            was = j_tel.enabled()
            j_tel.set_enabled(True)
            try:
                JWorkflow(JStore.open(tmp_path / name),
                          JDescription.load(tmp_path / "wf.json")).run()
            finally:
                j_tel.set_enabled(was)
            continue
        telemetry.reset_registry(enabled=on)
        try:
            runs[name] = Workflow(ExperimentStore.open(tmp_path / name), desc,
                                  device="cpu").run()
        finally:
            telemetry.reset_registry()
    for sub in ("segmentations", "features"):
        for f in sorted((tmp_path / "off" / sub).rglob("*")):
            if f.is_file():
                g = tmp_path / "on" / f.relative_to(tmp_path / "off")
                assert f.read_bytes() == g.read_bytes(), f
    seq = lambda name: [(e["event"], e.get("step"), e.get("batch"), e.get("span"))
                        for e in RunLedger(tmp_path / name / "workflow" /
                                           "ledger.jsonl").events()
                        if e.get("span") != "compile"]
    assert seq("on") == seq("ref")
    assert not any(e[0] == "span" for e in seq("off"))
    wf = tmp_path / "on" / "workflow"
    snap = json.loads((wf / "metrics.json").read_text())
    names = {c["name"] for c in snap["counters"]}
    assert {"tmx_runs_total", "tmx_batches_done_total", "tmx_steps_done_total",
            "tmx_jterator_sites_total"} <= names
    assert (wf / "metrics.host0.json").exists() and (wf / "tsdb.host0.jsonl").exists()
    shutil.rmtree(tmp_path / "src")
