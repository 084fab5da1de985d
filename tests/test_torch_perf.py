"""The port's performance attribution (``tmlibrary_tpu_torch/perf.py``)
against the JAX package's, and its per-program store on a CPU run.

- The bench-history sentinel: ``compare_history`` on the same numpy-seeded
  histories gives the reference's verdicts, deltas, ages, exit codes and
  re-capture labels, through its backend and methodology classes and a
  separate baseline file; the staleness rows and gauges and the
  re-capture queue are the reference's.
- The cost model: the bytes and FLOPs of a call counted under the
  dispatch modes, the modelled bytes of kernel rows 1-4 (PERF.md's,
  ``shootout.py``'s), the card's peaks and ridge.
- The store: the first call of a program is its compile (once, timed,
  not wrapped), its cost is counted only under ``counting`` (once a
  key), later calls run unwrapped, telemetry off records nothing; two
  counted calls overlapping on two threads keep their own kernels'
  bytes; a CPU run of config 3 through ``workflow submit --profile``
  writes ``workflow/perf.json``,
  which ``perf --root --json`` reproduces with the ledger's phase split;
  ``perf history`` exits with the sentinel's code.
"""

import io
import json
import contextlib
import threading

import numpy as np
import pytest
import torch

from tmlibrary_tpu import perf as j_perf
from tmlibrary_tpu import telemetry as j_telemetry
from tmlibrary_tpu_torch import capacity, cli, perf, shootout, telemetry
from tmlibrary_tpu_torch.workflow.engine import RunLedger, WorkflowDescription

torch.set_num_threads(1)

NOW = 1_800_000_000.0
METHODS = ["", "pipelined-depth8", "pipelined-depth16+bucketed", "pipelined+strategy=fused",
           "pipelined+schedule=pack+model=ab12", "analytics-tools+index=ivf+recall=0.97",
           "host-sync"]
BACKENDS = ["tpu", "tpu_cached", "cpu", "cpu_forced", "cuda"]


def history(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rec = {"metric": str(rng.choice(["sites", "qps"])), "config": str(rng.integers(2, 4)),
               "backend": str(rng.choice(BACKENDS)),
               "timing_methodology": str(rng.choice(METHODS)),
               "value": float(np.round(rng.uniform(50, 150), 2)),
               "recorded_at_unix": NOW - float(rng.uniform(0, 200)) * 3600}
        if rng.random() < 0.1:
            rec["error"] = "boom"
        if rng.random() < 0.1:
            rec["sweep"] = True
        out.append(rec)
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("scope", [{}, {"config": "2"}, {"metric": "qps", "threshold": 0.2},
                                   {"stale_hours": 10.0}])
def test_compare_history_gives_the_references_verdict(seed, scope):
    hist = history(seed, 4 + 6 * seed)
    assert perf.compare_history(hist, now=NOW, **scope) == \
        j_perf.compare_history(hist, now=NOW, **scope)


@pytest.mark.parametrize("latest,want", [(60.0, 1), (100.0, 0), (130.0, 0), (None, 3)])
def test_each_exit_code_and_a_baseline_file(latest, want):
    base = [{"metric": "sites", "config": "3", "backend": "cuda", "value": 100.0,
             "recorded_at_unix": NOW - 3600}]
    hist = base + ([] if latest is None else
                   [{**base[0], "value": latest, "recorded_at_unix": NOW - 3600}])
    for kw in ({}, {"baseline": base}):
        got = perf.compare_history(hist if latest else [], now=NOW, **kw)
        assert got == j_perf.compare_history(hist if latest else [], now=NOW, **kw)
        assert got["exit_code"] == want
    stale = perf.compare_history(hist if latest else [], now=NOW, stale_hours=0.5)
    assert stale["exit_code"] == (3 if latest is None else {0: 2}.get(want, want))


def test_staleness_rows_gauges_and_the_recapture_queue(tmp_path, monkeypatch):
    cache = {"records": {
        "2": {"measured_at_unix": NOW - 10 * 3600, "measured_at": "a",
              "record": {"metric": "m2", "backend": "tpu"}},
        "3": {"measured_at_unix": NOW - 100 * 3600, "record": {"metric": "m3",
                                                               "backend": "cuda"}},
        "x": {"measured_at": "no time"}, "y": "junk"}}
    path = tmp_path / "cache.json"
    path.write_text(json.dumps(cache))
    monkeypatch.setenv("BENCH_TPU_CACHE", str(path))
    rows = perf.bench_record_staleness(now=NOW)
    assert rows == j_perf.bench_record_staleness(now=NOW)
    assert [r["stale"] for r in rows] == [False, True]
    assert [r["config"] for r in perf.bench_record_staleness(now=NOW, backend="cuda")] == ["3"]
    reg, j_reg = telemetry.MetricsRegistry(enabled=True), j_telemetry.MetricsRegistry(
        enabled=True)
    perf.set_bench_staleness_gauges(reg, now=NOW)
    j_perf.set_bench_staleness_gauges(j_reg, now=NOW)
    assert reg.snapshot()["gauges"] == j_reg.snapshot()["gauges"]
    path.write_text("[1, 2]")
    assert perf.bench_record_staleness(now=NOW) == []
    queue = {"port": tmp_path / "p" / "RECAPTURE.json", "ref": tmp_path / "r" / "RECAPTURE.json"}
    for mod, q in ((perf, queue["port"]), (j_perf, queue["ref"])):
        mod.write_recapture(["bench:3", "sweep:2"], str(q), reason="r")
        mod.write_recapture(["bench:3", "bench:4"], str(q))
        assert mod.load_recapture(str(q)) == ["bench:3", "sweep:2", "bench:4"]
        mod.clear_recapture("sweep:2", str(q))
    assert perf.load_recapture(str(queue["port"])) == \
        j_perf.load_recapture(str(queue["ref"])) == ["bench:3", "bench:4"]
    for label in ("bench:3", "bench:4"):
        perf.clear_recapture(label, str(queue["port"]))
    assert not queue["port"].exists() and perf.load_recapture(str(queue["port"])) == []


def test_the_cost_model_counts_bytes_and_flops():
    x = torch.arange(1000, dtype=torch.float32)
    out, cost, seconds = perf.measure_call(lambda t: (t + 1) * 2, x, device="cpu")
    assert torch.equal(out, (x + 1) * 2) and seconds >= 0
    assert cost.flops == 0.0 and cost.bytes == 4 * 4000  # two ops, each in and out
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    _, cost, _ = perf.measure_call(lambda p, q: p @ q, a, b, device="cpu")
    assert cost.flops == 2 * 8 * 16 * 4
    assert cost.bound_by() == "memory" and cost.arithmetic_intensity < perf.ridge_point()
    # views move nothing
    _, cost, _ = perf.measure_call(lambda t: t.view(10, 100)[2:4], x, device="cpu")
    assert cost.bytes is None


def test_the_modelled_kernel_bytes_are_perf_mds():
    rng = np.random.default_rng(0)
    mask = torch.from_numpy(rng.random((2, 32, 32)) > 0.5)
    labels = torch.from_numpy(rng.integers(0, 20, (2, 32, 32)).astype(np.int32))
    sums = torch.zeros(2, 16, 3)
    assert perf.kernel_bytes("cc_min_propagate", (mask, None)) == shootout.cc_bytes(mask)
    assert perf.kernel_bytes("fill_holes_flood", (mask, mask)) == mask.numel() * 2
    assert perf.kernel_bytes("watershed_flood", (mask.float(),)) == mask.numel() * 13
    assert perf.kernel_bytes("grouped_stats", (labels, None, sums, sums, sums)) == \
        shootout.grouped_stats_bytes(labels, 3, 16)
    assert perf.kernel_bytes("glcm_all", (labels, sums)) == labels.numel() * 4 + 96 * 4


@pytest.mark.parametrize("name,hbm,ridge", [("NVIDIA H100 80GB HBM3", 3.35e12, 20.0),
                                            ("NVIDIA H100 PCIe", 2.0e12, 25.5)])
def test_the_cards_peaks(name, hbm, ridge):
    peaks = perf.card_peaks(name)
    assert peaks["peak_hbm_bps"] == hbm
    assert peaks["ridge_flops_per_byte"] == pytest.approx(ridge)
    assert perf.backend_peaks("cuda") == (67e12, 3.35e12)
    assert perf.backend_peaks("cpu") == (None, None)


def test_a_program_compiles_once_and_runs_unwrapped_after(monkeypatch):
    telemetry.reset_registry(enabled=True)
    perf.reset_profiles()
    measured = []
    real = perf.measure_call
    monkeypatch.setattr(perf, "measure_call", lambda *a, **k: measured.append(1) or real(*a, **k))
    try:
        x = torch.ones(64)
        # outside `counting` the first call is timed, not wrapped
        for cap in (8, 8, 16):
            out = perf.instrument_call(torch.add, x, x, program="p", capacity=cap,
                                       strategy="fused", device="cpu")
            assert torch.equal(out, x + x)
        assert measured == []
        rows = {r["capacity"]: r for r in perf.perf_profiles()}
        assert set(rows) == {8, 16} and rows[8]["compiles"] == 1
        assert rows[8]["compile_seconds_total"] > 0 and rows[8]["bytes"] is None
        # under `counting` each key's first counted call is measured once,
        # and a call counted after its compile is no second compile
        with perf.counting():
            for cap in (8, 8, 8, 32):
                out = perf.instrument_call(torch.add, x, x, program="p", capacity=cap,
                                           strategy="fused", device="cpu")
                assert torch.equal(out, x + x)
        perf.instrument_call(torch.add, x, x, program="p", capacity=64, device="cpu")
        assert len(measured) == 2
        rows = {r["capacity"]: r for r in perf.perf_profiles()}
        assert set(rows) == {8, 16, 32, 64}
        assert rows[8]["compiles"] == rows[32]["compiles"] == 1
        assert rows[8]["bytes"] == rows[32]["bytes"] == 64 * 4 * 3
        assert rows[8]["bound_by"] == "memory" and rows[16]["bytes"] is None
        assert rows[64]["bytes"] is None
        # the kernel library's build or load belongs to no step: no ledger span
        perf.record_compile(program="cuda_kernels", step=None, backend="cuda", compile_s=9.0)
        spans = perf.pop_compile_spans()
        assert [s["program"] for s in spans] == ["p"] * 4 and perf.pop_compile_spans() == []
        counters = {(c["name"], c["labels"].get("capacity")): c["value"]
                    for c in telemetry.get_registry().snapshot()["counters"]}
        assert counters[("tmx_perf_compiles_total", "8")] == 1
        telemetry.set_enabled(False)
        with perf.counting():
            perf.instrument_call(torch.add, x, x, program="q", device="cpu")
        assert len(measured) == 2 and "q" not in {r["program"] for r in perf.perf_profiles()}
    finally:
        perf.reset_profiles()
        telemetry.reset_registry()


def test_overlapping_counted_calls_keep_their_own_kernel_bytes():
    """Two first calls of different keys, counted at once on two threads
    (the engine thread and a persist worker's escalation), each get their
    own ops' and kernels' bytes."""
    telemetry.reset_registry(enabled=True)
    perf.reset_profiles()
    both = threading.Barrier(2)
    sizes = {"a": 100, "b": 300}

    def program(name):
        t = torch.ones(sizes[name])
        both.wait()  # both calls are counting now
        perf.note_kernel_launch("glcm_all", (t,))
        both.wait()  # both launches are noted before either call ends
        return t * 2

    errors = []

    def call(name):
        try:
            perf.instrument_call(program, name, program=name, capacity=8, device="cpu")
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    try:
        with perf.counting():
            threads = [threading.Thread(target=call, args=(n,)) for n in sizes]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not errors
        rows = {r["program"]: r for r in perf.perf_profiles()}
        # ones (out), mul (in and out) and the kernel's bound tensor
        assert {n: rows[n]["bytes"] for n in sizes} == {n: 4.0 * k * 4 for n, k in sizes.items()}
        perf.note_kernel_launch("glcm_all", (torch.ones(1),))  # nothing counts it
    finally:
        perf.reset_profiles()
        telemetry.reset_registry()


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    from test_torch_workflow_steps import CORILLA, JTERATOR, make_store

    telemetry.reset_registry(enabled=True)
    perf.reset_profiles()
    base = tmp_path_factory.mktemp("perf")
    make_store(base / "st")
    WorkflowDescription.canonical({"corilla": CORILLA, "jterator": {
        **JTERATOR, "pipe": "cp.pipe.json"}}).save(base / "wf.json")
    capacity.reset_routing_history()
    # a compile recorded outside any run reaches no run's ledger
    perf.record_compile(program="outside", step="jterator", backend="cpu", compile_s=1.0)
    try:
        assert cli.main(["workflow", "submit", "--root", str(base / "st"), "--description",
                         str(base / "wf.json"), "--device", "cpu", "--profile",
                         str(base / "trace")]) == 0
    finally:
        # the routing history is process-wide: leave none for later tests
        capacity.reset_routing_history()
        telemetry.reset_registry()
    return base


def run_cli(argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def test_perf_json_reproduces_the_runs_store(cpu_run):
    snap = json.loads((cpu_run / "st" / "workflow" / "perf.json").read_text())
    jt = [p for p in snap["programs"] if p["program"].startswith("jterator:")]
    assert jt and all(p["compiles"] >= 1 and p["compile_seconds_total"] > 0 and
                      p["bytes"] > 0 and p["flops"] is not None and
                      p["bound_by"] == "memory" and p["backend"] == "cpu" and
                      p["strategy"] == "fused" for p in jt)
    rc, out = run_cli(["perf", "--root", str(cpu_run / "st"), "--json"])
    doc = json.loads(out)
    assert rc == 0 and doc["programs"] == snap["programs"][:10]
    events = RunLedger(cpu_run / "st" / "workflow" / "ledger.jsonl").events()
    stats = next(e["pipeline_stats"] for e in events
                 if e.get("event") == "step_done" and e["step"] == "jterator")
    assert doc["phases"] == [{"step": "jterator", "depth": stats["depth"],
                              "phases": {p: v["total_s"] for p, v in stats["phases"].items()},
                              "device_s": stats["device_s"], "host_s": stats["host_s"]}]
    compiles = [e for e in events if e.get("span") == "compile"]
    assert sorted(e["program"] for e in compiles) == sorted(p["program"] for p in jt)
    rc, out = run_cli(["perf", "--root", str(cpu_run / "st")])
    assert rc == 0 and "bound-by" in out and "phases: jterator" in out


@pytest.mark.parametrize("values,code", [((100.0, 60.0), 1), ((100.0, 101.0), 0),
                                         ((100.0,), 3)])
def test_perf_history_exits_with_the_sentinels_code(tmp_path, values, code):
    path = tmp_path / "h.jsonl"
    path.write_text("".join(json.dumps({"metric": "sites", "config": "3", "backend": "cuda",
                                        "value": v, "recorded_at_unix": 1e12}) + "\n"
                            for v in values))
    rc, out = run_cli(["perf", "history", "--history", str(path)])
    verdict = j_perf.compare_history([json.loads(line) for line in path.read_text().splitlines()])
    assert rc == verdict["exit_code"] == code
    assert f"verdict: {verdict['status']}" in out
    assert run_cli(["perf", "history", "--history", str(tmp_path / "none")])[0] == 1
