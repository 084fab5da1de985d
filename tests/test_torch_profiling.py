"""The port's profiling module (``tmlibrary_tpu_torch/profiling.py``)
against the JAX package's.

``PipelineStats.summary()`` for the same numpy-seeded phase records
equals the reference's (its keys, the 4-decimal rounding, the p50/p95 of
the telemetry histograms and the device/host split), and so do the
``tmx_perf_*`` gauges it sets.  ``device_trace`` on the CPU writes a
Chrome trace in which each telemetry span, with the registry on or off,
is a ``record_function`` range, and counts first calls while it runs;
without a directory it does nothing.
"""

import json

import numpy as np
import pytest
import torch

from tmlibrary_tpu import profiling as j_profiling
from tmlibrary_tpu import telemetry as j_telemetry
from tmlibrary_tpu_torch import perf, profiling, telemetry
from tmlibrary_tpu_torch.workflow import pipelined

torch.set_num_threads(1)


def records(seed: int, n: int) -> list[tuple[str, float, int]]:
    rng = np.random.default_rng(seed)
    phases = rng.choice(profiling.PIPELINE_PHASES, size=n)
    return [(str(p), float(s), int(b)) for p, s, b in
            zip(phases, rng.exponential(0.05, n), rng.integers(0, 8, n))]


@pytest.fixture
def registries():
    j_telemetry.reset_registry(enabled=True)
    telemetry.reset_registry(enabled=True)
    yield
    j_telemetry.reset_registry()
    telemetry.reset_registry()


def gauges(snapshot: dict) -> dict:
    return {(g["name"], tuple(sorted(g["labels"].items()))): g["value"]
            for g in snapshot["gauges"] if g["name"].startswith("tmx_perf_")}


@pytest.mark.parametrize("seed,n,clamp", [(0, 1, False), (1, 40, False), (2, 700, True),
                                          (3, 0, False)])
def test_the_summary_is_the_references(registries, seed, n, clamp):
    ref = j_profiling.PipelineStats(8, "tuning", step="jterator")
    port = profiling.PipelineStats(8, "tuning", step="jterator")
    for phase, seconds, batch in records(seed, n):
        ref.record(phase, seconds, batch=batch, t0=1.0)
        port.record(phase, seconds, batch=batch, t0=1.0)
    for stats in (ref, port):
        for _ in range(n // 3):
            stats.batch_done()
        if clamp:
            stats.record_clamp(8, 4)
    want, got = ref.summary(), port.summary()
    # the port always carries its clamps, empty without one
    assert got.pop("depth_clamps") == want.pop("depth_clamps", [])
    assert got == want
    assert gauges(telemetry.get_registry().snapshot()) == \
        gauges(j_telemetry.get_registry().snapshot())
    for b in range(8):
        assert port.pop_batch_spans(b) == ref.pop_batch_spans(b)


def test_the_executor_keeps_its_names():
    assert pipelined.PipelineStats is profiling.PipelineStats
    assert pipelined.PHASE_RESOURCE == j_profiling.PHASE_RESOURCE
    assert pipelined.PIPELINE_PHASES == j_profiling.PIPELINE_PHASES


def test_no_directory_no_trace():
    with profiling.device_trace(None, device="cpu") as prof:
        assert prof is None
        assert not telemetry._trace_bridge.is_set()
        assert not perf._COUNT_ON[0]


@pytest.mark.parametrize("enabled", [True, False])
def test_the_trace_holds_each_span_as_a_range(tmp_path, enabled):
    telemetry.reset_registry(enabled=enabled)
    emitted = []
    try:
        with profiling.device_trace(tmp_path / "trace", device="cpu"):
            assert telemetry._trace_bridge.is_set()
            assert perf._COUNT_ON[0]  # first calls are counted for `perf`
            with telemetry.span("run", emit=lambda **e: emitted.append(e)):
                with telemetry.span("step", trace_label="jterator"):
                    with telemetry.trace_range("batch:0"):
                        torch.ones(8, 8).sum()
        assert not telemetry._trace_bridge.is_set() and not perf._COUNT_ON[0]
    finally:
        telemetry.reset_registry()
    (path,) = (tmp_path / "trace").glob("*.pt.trace.json")
    doc = json.loads(path.read_text())
    ranges = {e["name"] for e in doc["traceEvents"] if e.get("cat") == "user_annotation"}
    assert {"run", "run/step:jterator", "batch:0"} <= ranges
    assert any(e.get("cat") == "cpu_op" for e in doc["traceEvents"])
    # only an enabled registry writes the ledger's span event
    assert [e["span"] for e in emitted] == (["run"] if enabled else [])
