"""The port's tuning reader (``tmlibrary_tpu_torch/tuning.py``) against
the JAX package's on the same fixture files, and the port's divergence:
every tuned value is backend-scoped, so a verdict measured on another
backend (the repo's ``tuning/TUNING.json`` is a TPU's) sets nothing on
``cuda``.

For the ``cpu`` and ``tpu`` backends the per-backend verdicts
(reduction strategy, object capacity, schedule, analytics index) equal
the reference's; ``best_batch``/``best_pipeline`` equal the reference's
where the file's backend is the asking one, and are None elsewhere
(the reference reads them whatever the file's backend).  The resolution
chains that consume them (the executor's depth, the jterator step's
batch size, the schedule, the reduction strategy and the analytics
index) hold the same verdicts on the CPU and keep their defaults on
``cuda`` with the repo's file.
"""

import json
import types
from pathlib import Path

import pytest
import torch

from tmlibrary_tpu import tuning as j_tuning
from tmlibrary_tpu.analytics import index as j_index
from tmlibrary_tpu.ops import reduction as j_reduction
from tmlibrary_tpu.workflow import pipelined as j_pipelined
from tmlibrary_tpu.workflow import schedule as j_schedule
from tmlibrary_tpu_torch import tuning
from tmlibrary_tpu_torch.analytics import index
from tmlibrary_tpu_torch.ops import reduction
from tmlibrary_tpu_torch.workflow import schedule
from tmlibrary_tpu_torch.workflow.pipelined import resolve_pipeline_depth
from tmlibrary_tpu_torch.workflow.steps.jterator import ImageAnalysisRunner

REPO_TUNING = Path(__file__).resolve().parent.parent / "tuning" / "TUNING.json"
STAMP = {"written_by": "scripts/tune_tpu.py write_results"}

FIXTURES = {
    "repo": None,
    "tpu_plain": {**STAMP, "backend": "tpu", "best_batch": 96, "best_pipeline": 12,
                  "reduction_strategy": "onehot", "object_capacity": 32,
                  "schedule": "off", "analytics_index": "ivf"},
    "cpu_plain": {**STAMP, "backend": "cpu", "best_batch": 16, "best_pipeline": 3,
                  "reduction_strategy": "sort", "object_capacity": 16,
                  "schedule": "off", "analytics_index": "brute"},
    "per_backend": {**STAMP, "backend": "tpu", "best_batch": 128,
                    "reduction_strategy": {"cpu": "scatter", "tpu": "onehot", "cuda": "fused"},
                    "object_capacity": {"cpu": 8, "tpu": 64, "cuda": 16},
                    "schedule": {"cpu": "pack", "tpu": "off"},
                    "analytics_index": {"cpu": "ivf", "cuda": "brute"}},
    "cuda": {**STAMP, "backend": "cuda", "best_batch": 48, "best_pipeline": 6,
             "reduction_strategy": "fused", "object_capacity": 64, "schedule": "off",
             "analytics_index": "ivf"},
    "malformed": {**STAMP, "backend": "cpu", "best_batch": -4, "best_pipeline": "8",
                  "reduction_strategy": "fastest", "object_capacity": 0,
                  "schedule": "maybe", "analytics_index": 3},
    "smoke": {**STAMP, "backend": "cpu", "best_batch": 8,
              "timing_methodology": "SMOKE(dry run)"},
    "unstamped": {"backend": "cpu", "best_batch": 8, "reduction_strategy": "sort"},
}


@pytest.fixture(params=sorted(FIXTURES))
def fixture(request, tmp_path, monkeypatch):
    doc = FIXTURES[request.param]
    if doc is None:
        path = REPO_TUNING
        doc = json.loads(path.read_text())
    else:
        path = tmp_path / "TUNING.json"
        path.write_text(json.dumps(doc))
    monkeypatch.setenv("TMX_TUNING_JSON", str(path))
    return request.param, doc


VERDICTS = ("tuned_reduction_strategy", "tuned_object_capacity", "tuned_schedule",
            "tuned_analytics_index")


@pytest.mark.parametrize("backend", ["cpu", "tpu"])
def test_the_per_backend_verdicts_are_the_references(fixture, backend):
    for name in VERDICTS:
        assert getattr(tuning, name)(backend) == getattr(j_tuning, name)(backend), name
    ref = j_tuning.load_tuning()
    assert tuning.load_tuning() == ref
    scoped = ref is not None and ref.get("backend") == backend
    assert tuning.tuned_batch_size(backend) == (j_tuning.tuned_batch_size() if scoped else None)
    assert tuning.tuned_pipeline_depth(backend) == \
        (j_tuning.tuned_pipeline_depth() if scoped else None)


def test_a_verdict_of_another_backend_sets_nothing_on_cuda(fixture):
    name, doc = fixture
    values = [getattr(tuning, v)("cuda") for v in VERDICTS] + \
        [tuning.tuned_batch_size("cuda"), tuning.tuned_pipeline_depth("cuda")]
    if name == "cuda":
        assert values == ["fused", 64, "off", "ivf", 48, 6]
    elif name == "per_backend":
        assert values == ["fused", 16, None, "brute", None, None]
    else:
        assert values == [None] * 6
    # the default backend is the card's
    assert tuning.tuned_batch_size() == tuning.tuned_batch_size("cuda")


def test_the_consumers_on_the_card_with_the_repos_file(monkeypatch):
    monkeypatch.setenv("TMX_TUNING_JSON", str(REPO_TUNING))
    assert j_pipelined.resolve_pipeline_depth(None, backend="tpu") == (16, "tuning")
    assert resolve_pipeline_depth(None, "cuda") == (8, "default")
    cuda_step = types.SimpleNamespace(device=torch.device("cuda"))
    assert ImageAnalysisRunner._auto_batch_size(cuda_step) == 32
    assert schedule.resolve_schedule(None, "cuda") == ("pack", "default")
    assert reduction.resolve_reduction_strategy("auto", "cuda") == "fused"
    assert index.resolve_index_mode(None, 10, device="cuda") == ("brute", "auto")


def test_the_consumers_follow_a_cuda_verdict(tmp_path, monkeypatch):
    path = tmp_path / "TUNING.json"
    path.write_text(json.dumps(FIXTURES["cuda"]))
    monkeypatch.setenv("TMX_TUNING_JSON", str(path))
    assert resolve_pipeline_depth(None, "cuda") == (6, "tuning")
    assert resolve_pipeline_depth(4, "cuda") == (4, "cli")
    assert resolve_pipeline_depth(None, "cpu") == (2, "default")
    assert ImageAnalysisRunner._auto_batch_size(
        types.SimpleNamespace(device=torch.device("cuda"))) == 48
    assert ImageAnalysisRunner._auto_batch_size(
        types.SimpleNamespace(device=torch.device("cpu"))) == 32
    assert schedule.resolve_schedule(None, "cuda") == ("off", "tuning")
    assert schedule.resolve_schedule("pack", "cuda") == ("pack", "cli")
    assert index.resolve_index_mode(None, 10, device="cuda") == ("ivf", "tuned")
    assert index.resolve_index_mode(None, 10, device="cpu") == ("brute", "auto")


@pytest.mark.parametrize("name", ["cpu_plain", "per_backend", "malformed", "smoke"])
def test_the_cpu_chains_resolve_as_the_references(tmp_path, monkeypatch, name):
    path = tmp_path / "TUNING.json"
    path.write_text(json.dumps(FIXTURES[name]))
    monkeypatch.setenv("TMX_TUNING_JSON", str(path))
    for key in ("TMX_SCHEDULE", "TMX_REDUCTION_STRATEGY", "TMX_ANALYTICS_INDEX",
                "TM_SCHEDULE", "TM_REDUCTION_STRATEGY", "TM_ANALYTICS_INDEX"):
        monkeypatch.delenv(key, raising=False)
    assert schedule.resolve_schedule(None, "cpu") == j_schedule.resolve_schedule(None)
    assert reduction.resolve_reduction_strategy("auto", "cpu") == \
        (j_reduction.resolve_reduction_strategy("auto")
         if tuning.tuned_reduction_strategy("cpu") else "fused")
    for n in (10, 100000):
        want = j_index.resolve_index_mode(None, n_objects=n)
        assert index.resolve_index_mode(None, n, device="cpu") == want
    with pytest.raises(ValueError):
        reduction.resolve_reduction_strategy("fastest", "cpu")


SWEEPS = [
    ("3", {"backend": "cpu", "best_strategy": "scatter", "best_capacity": 32, "rows": [1]}),
    ("3", {"backend": "tpu", "best_strategy": "onehot", "best_schedule": "pack"}),
    ("analytics", {"backend": "cpu", "best_index": "ivf", "model_digest": "ab12"}),
    ("4", {"backend": "cuda", "best_strategy": "fused", "best_capacity": 64,
           "best_schedule": "off", "best_index": "brute"}),
    ("5", {"backend": "cpu", "best_strategy": "bogus", "best_capacity": -1}),
]


@pytest.mark.parametrize("start", [None, "legacy"])
def test_sweeps_merge_into_the_references_document(tmp_path, monkeypatch, start):
    docs = {}
    for who, mod in (("ref", j_tuning), ("port", tuning)):
        path = tmp_path / who / "TUNING.json"
        path.parent.mkdir()
        if start == "legacy":
            path.write_text(json.dumps({**STAMP, "backend": "tpu", "reduction_strategy": "sort",
                                        "best_batch": 64}))
        monkeypatch.setenv("TMX_TUNING_JSON", str(path))
        for config, entry in SWEEPS:
            mod.record_config_sweep(config, entry)
        docs[who] = path.read_text()
        assert mod.config_sweep("analytics", model_digest="ab12") is not None
        assert mod.config_sweep("analytics", model_digest="ffff") is None
        assert mod.config_sweep("3")["backend"] == "tpu"
        assert mod.config_sweep("missing") is None
    assert docs["port"] == docs["ref"]


def test_bench_history_and_paths_as_the_references(tmp_path, monkeypatch):
    monkeypatch.setenv("TMX_TUNING_JSON", str(tmp_path / "t" / "TUNING.json"))
    for var in ("BENCH_HISTORY", "BENCH_TPU_CACHE", "WATCH_RECAPTURE"):
        monkeypatch.delenv(var, raising=False)
    for fn in ("tuning_json_path", "bench_cache_path", "bench_history_path", "recapture_path"):
        assert getattr(tuning, fn)() == getattr(j_tuning, fn)()
    path = tmp_path / "hist.jsonl"
    for i, rec in enumerate([{"metric": "m", "value": 1.5}, {"metric": "m", "value": 2.0}]):
        assert (tuning if i % 2 else j_tuning).append_bench_history(rec, str(path)) == str(path)
    with open(path, "a") as f:
        f.write("{torn\n\n[1]\n")
    assert tuning.load_bench_history(str(path)) == j_tuning.load_bench_history(str(path))
    assert [r["value"] for r in tuning.load_bench_history(str(path))] == [1.5, 2.0]
    assert tuning.load_bench_history(str(tmp_path / "none.jsonl")) == []
    assert tuning.append_bench_history({"x": object()}, str(path)) is None
