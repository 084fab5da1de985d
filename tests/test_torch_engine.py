"""The port's ``Workflow`` engine, run ledger and CLI against the JAX
package's.

One description (corilla -> align -> jterator with config 3 corrected
and aligned, from ``test_torch_workflow_steps``) runs under both engines
over two copies of one 16-site store of 64x64: the stores are equal
(labels exact, features within ``CORRECTED_FEATURE_TIERS``) and so are
the ledgers' (event, step, batch) sequences, with the reference's
telemetry off.  Then resume, an interrupted run resumed, quarantine,
drift, the ledgers read across packages, descriptions, refusals and the
CLI on the CPU.  Last, the canonical workflow from a directory of TIFFs
(metaconfig -> imextract -> corilla -> illuminati -> jterator) under both
engines: equal manifests, mappings, OME-XML, pixels, statistics, labels,
features (``CORRECTED_FEATURE_TIERS``), ledger sequences and tiles.
Then the DL segmenters' pipeline with QC on under both engines: equal
ledger sequences with the ``qc_batch``/``qc_site`` events, both profiles
written, the port's equal to the reference's (counts, flags, guards,
illumination and the ``__model__`` streams; values within the head and QC
tiers), the same run with QC off writing no profile and the same store,
and the ``qc`` verb's exit code against the reference's profile.
"""

import json
import shutil
import zlib

import numpy as np
import pytest
import torch

from chip_smoke import HEAD_TIER, QC_TIERS, feature_tier
from test_torch_workflow_steps import (
    ALIGN,
    CORILLA,
    JTERATOR,
    assert_same_features,
    assert_same_labels,
    copy_store,
    make_store,
)
from tmlibrary_tpu import capacity as j_capacity
from tmlibrary_tpu import qc as j_qc
from tmlibrary_tpu import resilience as j_resilience
from tmlibrary_tpu import telemetry
from tmlibrary_tpu.models.store import ExperimentStore as JStore
from tmlibrary_tpu.workflow.engine import RunLedger as JLedger
from tmlibrary_tpu.workflow.engine import Workflow as JWorkflow
from tmlibrary_tpu.workflow.engine import WorkflowDescription as JDescription
from tmlibrary_tpu.models.experiment import Experiment as JExperiment
from tmlibrary_tpu_torch import benchmarks, capacity, cli, qc, resilience
from tmlibrary_tpu_torch.errors import DeviceError, NotSupportedError, WorkflowError
from tmlibrary_tpu_torch.io import png
from tmlibrary_tpu_torch.models.store import ExperimentStore
from tmlibrary_tpu_torch.workflow.engine import RunLedger, Workflow, WorkflowDescription
from tmlibrary_tpu_torch.workflow.steps.jterator import ImageAnalysisRunner
from tmlibrary_tpu_torch.writers import ImageWriter

torch.set_num_threads(1)

STEP_ARGS = {"corilla": CORILLA, "align": ALIGN, "jterator": JTERATOR}


def sequence(root) -> list[tuple]:
    return [(e.get("event"), e.get("step"), e.get("batch"))
            for e in RunLedger(root / "workflow" / "ledger.jsonl").events()]


def reset_routers():
    j_capacity.reset_routing_history()
    capacity.reset_routing_history()


def run_port(root, desc=None, resume=False, **kw):
    reset_routers()
    desc = desc or WorkflowDescription.canonical(STEP_ARGS)
    return Workflow(ExperimentStore.open(root), desc, device="cpu", **kw).run(resume=resume)


def run_reference(root, desc_path, resume=False):
    reset_routers()
    was = telemetry.enabled()
    telemetry.set_enabled(False)
    try:
        return JWorkflow(JStore.open(root), JDescription.load(desc_path)).run(resume=resume)
    finally:
        telemetry.set_enabled(was)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("engine")
    make_store(base / "src")
    for name in ("ref", "port"):
        copy_store(base / "src", base / name)
    WorkflowDescription.canonical(STEP_ARGS).save(base / "wf.json")
    ref = run_reference(base / "ref", base / "wf.json")
    port = run_port(base / "port", WorkflowDescription.load(base / "wf.json"))
    reset_routers()
    return {"base": base, "ref": ref, "port": port}


# ---------------------------------------------------------- both engines
def test_both_engines_write_equal_stores(runs):
    base = runs["base"]
    ref, port = JStore.open(base / "ref"), ExperimentStore.open(base / "port")
    assert_same_labels(port, ref)
    for name in ("nuclei", "cells"):
        assert_same_features(ref.read_features(name), port.read_features(name))
    np.testing.assert_array_equal(port.read_shifts(1), ref.read_shifts(1))
    assert port.read_intersection() == ref.read_intersection()
    for ch in range(2):
        a, b = port.read_illumstats(1, ch), ref.read_illumstats(1, ch)
        np.testing.assert_array_equal(a["n"], b["n"])
    assert runs["port"]["jterator"]["collected"]["objects_total"] == \
        runs["ref"]["jterator"]["collected"]["objects_total"]
    assert list(runs["port"]) == list(runs["ref"]) == ["corilla", "align", "jterator"]


def test_both_ledgers_carry_the_same_events(runs):
    base = runs["base"]
    want = sequence(base / "ref")
    assert sequence(base / "port") == want
    assert want[0] == ("run_started", None, None)
    assert ("first_batch", "jterator", None) in want
    assert want[-1] == ("step_done", "jterator", None)


def test_each_status_reads_the_other_ledger(runs):
    for name in ("ref", "port"):
        path = runs["base"] / name / "workflow" / "ledger.jsonl"
        assert RunLedger(path).status() == JLedger(path).status()
        assert RunLedger(path).completed_steps() == JLedger(path).completed_steps()
        assert RunLedger(path).last_description_hash() == JLedger(path).last_description_hash()
    port = RunLedger(runs["base"] / "port" / "workflow" / "ledger.jsonl").status()
    assert {s: e["state"] for s, e in port.items()} == \
        {"corilla": "done", "align": "done", "jterator": "done"}
    assert port["jterator"]["pipeline_stats"]["n_batches"] == 4


def test_description_hashes_and_json_agree_with_the_reference(runs):
    path = runs["base"] / "wf.json"
    ours = WorkflowDescription.load(path)
    ref = JDescription.load(path)  # the reference's YAML loader reads the JSON
    assert ref.to_dict() == ours.to_dict()
    assert Workflow(ExperimentStore.open(runs["base"] / "port"), ours,
                    device="cpu").description_hash() == \
        JWorkflow(JStore.open(runs["base"] / "ref"), ref).description_hash()
    events = JLedger(runs["base"] / "ref" / "workflow" / "ledger.jsonl").events()
    assert events[0]["description_hash"] == \
        RunLedger(runs["base"] / "port" / "workflow" / "ledger.jsonl").events()[0][
            "description_hash"]
    for wtype in ("canonical", "multiplexing"):
        assert WorkflowDescription.for_type(wtype, STEP_ARGS).to_dict() == \
            JDescription.for_type(wtype, STEP_ARGS).to_dict()


# ---------------------------------------------------------------- resume
def test_resume_after_a_completed_run_reruns_nothing(runs, tmp_path):
    for name in ("ref", "port"):
        shutil.copytree(runs["base"] / name, tmp_path / name)
    shards = sorted((tmp_path / "port" / "features").rglob("*.parquet"))
    stamps = [p.stat().st_mtime_ns for p in shards]
    before = sequence(tmp_path / "port")
    assert run_port(tmp_path / "port", resume=True) == {}
    assert run_reference(tmp_path / "ref", runs["base"] / "wf.json", resume=True) == {}
    assert sequence(tmp_path / "port") == before + [("run_started", None, None)]
    assert sequence(tmp_path / "port") == sequence(tmp_path / "ref")
    assert [p.stat().st_mtime_ns for p in shards] == stamps


@pytest.fixture
def fail_batch(monkeypatch):
    """Make the jterator step's launch of ``state["batch"]`` raise while
    ``state["on"]``."""
    state = {"on": True, "batch": 2}
    launch = ImageAnalysisRunner.launch_batch

    def failing(self, batch, prefetched=None):
        if state["on"] and batch["index"] == state["batch"]:
            raise RuntimeError("injected launch failure")
        return launch(self, batch, prefetched)

    monkeypatch.setattr(ImageAnalysisRunner, "launch_batch", failing)
    return state


def test_an_interrupted_run_resumes_to_the_uninterrupted_store(runs, tmp_path, fail_batch):
    copy_store(runs["base"] / "src", tmp_path / "x")
    strict = resilience.ResilienceConfig(max_batch_failures=0)
    with pytest.raises(WorkflowError, match="quarantine budget"):
        run_port(tmp_path / "x", resilience=strict)
    status = RunLedger(tmp_path / "x" / "workflow" / "ledger.jsonl").status()
    assert status["jterator"]["state"] == "failed"
    assert status["jterator"]["quarantined"] == [2]
    assert RunLedger(tmp_path / "x" / "workflow" / "ledger.jsonl").completed_batches(
        "jterator") == {0, 1}
    assert JLedger(tmp_path / "x" / "workflow" / "ledger.jsonl").status() == status
    fail_batch["on"] = False
    summary = run_port(tmp_path / "x", resume=True)
    assert list(summary) == ["jterator"]
    resumed = [s for s in sequence(tmp_path / "x") if s[1] == "jterator"]
    assert resumed[-4:] == [("batch_done", "jterator", 2), ("first_batch", "jterator", None),
                            ("batch_done", "jterator", 3), ("step_done", "jterator", None)]
    got, want = ExperimentStore.open(tmp_path / "x"), ExperimentStore.open(runs["base"] / "port")
    assert_same_labels(got, want)
    for name in ("nuclei", "cells"):
        a, b = got.read_features(name), want.read_features(name)
        order_a = np.lexsort((a["label"], a["site_index"]))
        order_b = np.lexsort((b["label"], b["site_index"]))
        for k in a:
            np.testing.assert_array_equal(a[k][order_a], b[k][order_b], err_msg=k)


def test_a_failing_batch_is_quarantined_and_retried_first_on_resume(runs, tmp_path,
                                                                    fail_batch):
    copy_store(runs["base"] / "src", tmp_path / "x")
    summary = run_port(tmp_path / "x")
    assert summary["jterator"]["quarantined"] == [2]
    ledger = RunLedger(tmp_path / "x" / "workflow" / "ledger.jsonl")
    failed = [e for e in ledger.events() if e["event"] == "batch_failed"]
    assert len(failed) == 1 and failed[0]["classification"] == "permanent"
    assert failed[0]["exception"] == "RuntimeError"
    assert ledger.status()["jterator"]["state"] == "partial"
    assert ledger.quarantined_batches("jterator") == {2}
    fail_batch["on"] = False
    run_port(tmp_path / "x", resume=True)
    assert ledger.quarantined_batches("jterator") == set()
    assert sequence(tmp_path / "x")[-3:] == [("batch_done", "jterator", 2),
                                             ("first_batch", "jterator", None),
                                             ("step_done", "jterator", None)]


def test_a_changed_description_drifts_and_replans(runs, tmp_path):
    copy_store(runs["base"] / "src", tmp_path / "x")
    run_port(tmp_path / "x")
    changed = WorkflowDescription.canonical({**STEP_ARGS,
                                             "jterator": {**JTERATOR, "batch_size": 8}})
    summary = run_port(tmp_path / "x", changed, resume=True)
    assert summary == {}  # every step had completed: nothing re-runs
    seq = sequence(tmp_path / "x")
    assert seq[-2:] == [("description_drift", None, None), ("run_started", None, None)]


# ----------------------------------------------------------- the ledger
def test_ledger_lines_are_sealed_as_the_reference_seals_them(tmp_path):
    body = json.dumps({"step": "jterator", "event": "batch_done", "batch": 3, "ts": 1.5})
    assert RunLedger._seal(body) == JLedger._seal(body)
    sealed = RunLedger._seal(body)
    assert sealed.endswith(f'"crc": "{zlib.crc32(body.encode()):08x}"}}')
    assert RunLedger._line_ok(sealed) and JLedger._line_ok(sealed)
    assert not RunLedger._line_ok(sealed.replace('"batch": 3', '"batch": 4'))
    path = tmp_path / "ledger.jsonl"
    ours = RunLedger(path)
    ours.append(step="a", event="init_done", n_batches=2)
    assert ours.append_batch_done("a", 0, elapsed=0.1)
    assert not ours.append_batch_done("a", 0, elapsed=0.1)  # idempotent
    JLedger(path).append(step="a", event="batch_done", batch=1)
    with open(path, "a") as f:
        f.write('{"step": "a", "event": "batch_done", "batch": 9, "crc": "00')  # torn
    assert RunLedger(path).completed_batches("a") == {0, 1}
    fresh = RunLedger(path)
    assert fresh.recover() > 0
    assert path.read_text().endswith("\n")
    fresh.append(step="a", event="step_done")
    assert [e["event"] for e in JLedger(path).events()] == \
        ["init_done", "batch_done", "batch_done", "step_done"]
    assert RunLedger(path).status() == JLedger(path).status()


def test_resilience_matches_the_reference():
    for exc in (TimeoutError(), OSError("nfs"), MemoryError(), ValueError("x"), KeyError(1),
                RuntimeError("CUDA out of memory"), RuntimeError("device lost"),
                RuntimeError("bug"), ConnectionError()):
        assert resilience.classify(exc) == j_resilience.classify(exc), exc
    assert resilience.classify(DeviceError("no card")) == "permanent"
    assert resilience.classify(NotSupportedError("later")) == "permanent"
    ours, ref = resilience.RetryPolicy(seed=3), j_resilience.RetryPolicy(seed=3)
    assert [ours.delay(a) for a in range(1, 6)] == [ref.delay(a) for a in range(1, 6)]
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TimeoutError("slow")
        return "ok"

    out = resilience.retry_call(flaky, ours, sleep=lambda s: None)
    assert out.ok and out.value == "ok" and out.attempts == 3
    out = resilience.retry_call(lambda: 1 / 0, ours, sleep=lambda s: None)
    assert not out.ok and out.attempts == 1 and out.classification == "permanent"
    for budget, n, want in ((0.5, 4, 2), (0, 9, 0), (3, 100, 3)):
        assert resilience.ResilienceConfig(max_batch_failures=budget).failure_budget(n) == \
            j_resilience.ResilienceConfig(max_batch_failures=budget).failure_budget(n) == want


# ------------------------------------------------------------- refusals
def test_descriptions_and_refusals(tmp_path):
    for step in ("metaconfig", "imextract", "illuminati"):  # ported: all five steps active
        desc = WorkflowDescription.canonical({**STEP_ARGS, step: {}})
        desc.validate()
        assert [s.name for st in desc.stages for s in st.steps if s.active] == \
            [s.name for st in JDescription.canonical({**STEP_ARGS, step: {}}).stages
             for s in st.steps if s.active]
    WorkflowDescription.for_type("multiplexing", STEP_ARGS).validate()  # inactive: accepted
    desc = WorkflowDescription.canonical(STEP_ARGS)
    desc.stages[0].steps.append(type(desc.stages[0].steps[0])(name="nope"))
    with pytest.raises(WorkflowError, match="unknown step"):
        desc.validate()
    with pytest.raises(WorkflowError):
        WorkflowDescription.for_type("nope")
    # YAML both ways: the reference's file loads, and the port writes its bytes
    JDescription.canonical(STEP_ARGS).save(tmp_path / "wf.yaml")
    assert WorkflowDescription.load(tmp_path / "wf.yaml").to_dict() == \
        JDescription.load(tmp_path / "wf.yaml").to_dict()
    WorkflowDescription.canonical(STEP_ARGS).save(tmp_path / "port.yaml")
    assert (tmp_path / "port.yaml").read_bytes() == (tmp_path / "wf.yaml").read_bytes()
    make_store(tmp_path / "s")
    with pytest.raises(DeviceError):  # the default device is the card
        Workflow(ExperimentStore.open(tmp_path / "s"), WorkflowDescription.canonical(STEP_ARGS))


# ------------------------------------------------------------------ CLI
def test_cli_submit_status_and_log_on_the_cpu(runs, tmp_path, capsys):
    copy_store(runs["base"] / "src", tmp_path / "x")
    root = str(tmp_path / "x")
    desc = str(runs["base"] / "wf.json")
    reset_routers()
    assert cli.main(["workflow", "submit", "--root", root, "--description", desc,
                     "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["jterator"]["collected"]["objects_total"] == \
        runs["port"]["jterator"]["collected"]["objects_total"]
    assert sequence(tmp_path / "x") == sequence(runs["base"] / "port")
    assert cli.main(["workflow", "resume", "--root", root, "--description", desc,
                     "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out) == {}
    assert cli.main(["workflow", "status", "--root", root]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[:2] for line in out if not line.startswith(" ")] == \
        [["corilla", "done"], ["align", "done"], ["jterator", "done"]]
    assert any("pipeline depth 2 (default) over 4 batches" in line for line in out)
    assert cli.main(["log", "--root", root, "--tail", "3"]) == 0
    tail = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [e["event"] for e in tail] == ["batch_done", "step_done", "run_started"]
    assert cli.main(["jterator", "info", "--root", root, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.count("batch ") == 4
    assert cli.main(["corilla", "args"]) == 0
    assert [a["name"] for a in json.loads(capsys.readouterr().out)] == \
        ["chunk_size", "n_devices", "smooth_sigma", "prefetch_chunks"]
    assert_same_labels(ExperimentStore.open(tmp_path / "x"),
                       ExperimentStore.open(runs["base"] / "port"))


def test_cli_step_verbs_and_refusals(runs, tmp_path, capsys):
    copy_store(runs["base"] / "src", tmp_path / "x")
    root = str(tmp_path / "x")
    assert cli.main(["corilla", "init", "--root", root, "--device", "cpu",
                     "--chunk-size", "6"]) == 0
    assert "planned 4 batches" in capsys.readouterr().out
    assert cli.main(["corilla", "run", "--root", root, "--device", "cpu", "--job", "0"]) == 0
    assert capsys.readouterr().out.startswith("corilla batch 0: {")
    assert cli.main(["corilla", "collect", "--root", root, "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out) == {}
    assert cli.main(["illuminati", "init", "--root", root]) == 1  # ported; no card here
    assert "is_available" in capsys.readouterr().err
    # n_devices > 1 used to be refused; it clamps to the process group
    assert cli.main(["illuminati", "init", "--root", root, "--device", "cpu",
                     "--n-devices", "2"]) == 0
    assert "illuminati: planned 2 batches" in capsys.readouterr().out
    assert cli.main(["workflow", "submit", "--root", root, "--description",
                     str(runs["base"] / "wf.json")]) == 1  # no card here
    assert "is_available" in capsys.readouterr().err
    assert cli.main(["workflow", "submit", "--root", root, "--device", "cpu"]) == 1
    assert "no workflow description" in capsys.readouterr().err


# ------------------------------------------------- the canonical workflow
CANONICAL_PIPE = dict(benchmarks.CELL_PAINTING_PIPE, input={"channels": [
    {"name": "DAPI", "correct": True, "align": False},
    {"name": "Actin", "correct": True, "align": False}]})


def canonical_args(src) -> dict:
    """metaconfig -> imextract -> corilla -> illuminati -> jterator over a
    directory of TIFFs; illuminati stretches the raw mosaic (its corrected
    tiles are held in ``test_torch_illuminati_step``)."""
    return {"metaconfig": {"source_dir": str(src), "sites_per_well_x": 2},
            "imextract": {"batch_size": 12},
            "corilla": {"chunk_size": 6},
            "illuminati": {"correct": False, "batch_size": 5},
            "jterator": {"pipe": "cp.pipe.json", "batch_size": 4, "max_objects": 64}}


@pytest.fixture(scope="module")
def canonical(tmp_path_factory):
    base = tmp_path_factory.mktemp("canonical")
    src = base / "src"
    data = benchmarks.synthetic_cell_painting_batch(16, size=64, n_cells=10, seed=2)
    for i in range(16):
        well = ("A01", "A02", "B01", "B02")[i // 4]
        for ch in ("DAPI", "Actin"):
            with ImageWriter(src / f"{well}_s{i % 4}_{ch}.tif") as w:
                w.write(data[ch][i].astype(np.uint16))
    WorkflowDescription.canonical(canonical_args(src)).save(base / "wf.json")
    assert cli.main(["create", "--root", str(base / "port"), "--name", "canon"]) == 0
    assert cli.main(["create", "--root", str(base / "port"), "--name", "canon"]) == 1
    JStore.create(base / "ref", JExperiment(name="canon", plates=[], channels=[],
                                            site_height=1, site_width=1))
    for name in ("port", "ref"):
        (base / name / "cp.pipe.json").write_text(json.dumps(CANONICAL_PIPE))
    ref = run_reference(base / "ref", base / "wf.json")
    reset_routers()
    port = Workflow(ExperimentStore.open(base / "port"),
                    WorkflowDescription.load(base / "wf.json"), device="cpu").run()
    reset_routers()
    return {"base": base, "ref": ref, "port": port, "data": data}


def test_the_canonical_workflow_gives_the_references_store(canonical):
    base = canonical["base"]
    steps = ["metaconfig", "imextract", "corilla", "illuminati", "jterator"]
    assert list(canonical["port"]) == list(canonical["ref"]) == steps
    for step in steps[:-1]:
        assert canonical["port"][step] == canonical["ref"][step], step
    ref, port = JStore.open(base / "ref"), ExperimentStore.open(base / "port")
    assert (base / "port" / "manifest.json").read_text() == \
        (base / "ref" / "manifest.json").read_text()
    for name in ("file_mapping.json", "experiment.ome.xml"):
        assert (base / "port" / "workflow" / "metaconfig" / name).read_text() == \
            (base / "ref" / "workflow" / "metaconfig" / name).read_text()
    for ch, name in enumerate(("Actin", "DAPI")):  # channels sorted by name
        pixels = port.read_sites(None, channel=ch)
        np.testing.assert_array_equal(pixels, ref.read_sites(None, channel=ch))
        by_site = {(r.well_row, r.well_column, r.site_y * 2 + r.site_x): i
                   for i, r in enumerate(port.experiment.sites())}
        for i in range(16):
            site = by_site[(i // 4 // 2, i // 4 % 2, i % 4)]
            np.testing.assert_array_equal(pixels[site], canonical["data"][name][i]
                                          .astype(np.uint16))
        a, b = port.read_illumstats(0, ch), ref.read_illumstats(0, ch)
        for k in ("n", "percentile_keys", "percentile_values"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert_same_labels(port, ref)
    for name in ("nuclei", "cells"):
        assert_same_features(ref.read_features(name), port.read_features(name))
    assert sequence(base / "port") == sequence(base / "ref")
    tiles = sorted(p.relative_to(base / "ref") for p in (base / "ref").rglob("*.png"))
    assert len(tiles) == 2 and tiles == sorted(p.relative_to(base / "port")
                                               for p in (base / "port").rglob("*.png"))
    for rel in tiles:
        np.testing.assert_array_equal(png.read(base / "port" / rel),
                                      png.read(base / "ref" / rel), err_msg=str(rel))
    for rel in ("pyramids/channel00/layer.json", "pyramids/channel01/layer.json",
                "mapobject_types.json"):
        assert json.loads((base / "port" / rel).read_text()) == \
            json.loads((base / "ref" / rel).read_text())


def test_the_canonical_workflow_resumes_and_runs_through_the_cli(canonical, tmp_path, capsys):
    base = canonical["base"]
    shutil.copytree(base / "port", tmp_path / "x")
    before = sequence(tmp_path / "x")
    root = str(tmp_path / "x")
    assert cli.main(["workflow", "resume", "--root", root, "--description",
                     str(base / "wf.json"), "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out) == {}
    assert sequence(tmp_path / "x") == before + [("run_started", None, None)]
    # the new steps' verbs
    assert cli.main(["metaconfig", "args"]) == 0
    assert [a["name"] for a in json.loads(capsys.readouterr().out)] == \
        ["source_dir", "handler", "pattern", "sites_per_well_x", "plate_cols"]
    assert cli.main(["illuminati", "init", "--root", root, "--device", "cpu",
                     "--no-correct"]) == 0
    assert "planned 2 batches" in capsys.readouterr().out
    assert cli.main(["illuminati", "run", "--root", root, "--device", "cpu", "--job", "1"]) == 0
    assert '"n_tiles": 1' in capsys.readouterr().out
    assert cli.main(["illuminati", "collect", "--root", root, "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out) == \
        {"static_mapobjects": {"Plates": 1, "Wells": 4, "Sites": 16}}
    assert cli.main(["imextract", "info", "--root", root, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.count("batch ") == 3
    np.testing.assert_array_equal(
        png.read(tmp_path / "x" / "pyramids" / "channel01" / "0" / "0_0.png"),
        png.read(base / "port" / "pyramids" / "channel01" / "0" / "0_0.png"))


# ------------------------------------------------ the DL pipeline with QC
#: the DL segmenters over cycle 1, aligned; one capacity, so the
#: reference compiles one program
DL_STEP_ARGS = {"corilla": CORILLA, "align": ALIGN,
                "jterator": {**JTERATOR, "pipe": "dl.pipe.json", "object_buckets": "off"}}


@pytest.fixture(scope="module")
def qc_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("qc")
    make_store(base / "src")
    for name in ("ref", "port", "off"):
        copy_store(base / "src", base / name)
    desc = WorkflowDescription.canonical(DL_STEP_ARGS)
    desc.save(base / "wf.json")
    for mod in (qc, j_qc):
        mod.set_enabled(True)
        mod.reset_session()
    try:
        run_reference(base / "ref", base / "wf.json")
        run_port(base / "port", desc)
    finally:
        for mod in (qc, j_qc):
            mod.set_enabled(None)
            mod.reset_session()
    qc.set_enabled(False)
    try:
        run_port(base / "off", desc)
    finally:
        qc.set_enabled(None)
    reset_routers()
    return base


def test_the_qc_events_match_the_reference_engine(qc_runs):
    want = sequence(qc_runs / "ref")
    assert sequence(qc_runs / "port") == want
    assert [e for e in want if e[0] == "qc_batch"] == \
        [("qc_batch", "jterator", i) for i in range(4)]
    off = sequence(qc_runs / "off")
    assert off == [e for e in want if e[0] not in ("qc_batch", "qc_site", "qc_budget_exceeded")]


def test_the_qc_profile_matches_the_reference(qc_runs):
    wf, jwf = qc_runs / "port" / "workflow", qc_runs / "ref" / "workflow"
    assert sorted(p.name for p in wf.glob("qc*.json")) == ["qc.host0.json", "qc.json"]
    got, want = qc.load_profile(wf / "qc.json"), qc.load_profile(jwf / "qc.json")
    assert got == qc.load_profile(wf / "qc.host0.json")
    for k in ("schema_version", "host", "steps", "illumination", "flagged_total"):
        assert got[k] == want[k], k
    assert got["steps"]["jterator"] == {"batches": 4, "sites": 16, "flagged": 0}
    assert sorted(got["illumination"]) == ["Actin", "DAPI"]
    assert got["guards"]["nan_columns"] == want["guards"]["nan_columns"]
    assert got["guards"]["count_z_max"] == want["guards"]["count_z_max"]
    assert sorted(got["features"]) == sorted(want["features"])
    model = [k for k in got["features"] if k.startswith("__model__.")]
    assert sorted(model) == ["__model__.cell_prob", "__model__.cell_prob_secondary",
                             "__model__.flow_mag"]
    for key, sk in want["features"].items():
        g = got["features"][key]
        assert (g["count"], g["nan"], g["inf"]) == (sk["count"], sk["nan"], sk["inf"]), key
        # each statistic moves with the values: the feature's own tier (the
        # model streams the head's) scaled to the column's largest value
        scale = max(abs(sk["max"]), abs(sk["min"]), 1.0)
        rtol, atol = (HEAD_TIER * 8, 0.0) if key in model else \
            feature_tier(key.split(".", 1)[1])
        for stat in ("min", "max", "p50", "p95", "mean"):
            assert abs(g[stat] - sk[stat]) <= rtol * scale + atol, (key, stat)
    assert model and all(got["features"][k]["count"] == 16 * 64 for k in model)
    assert sorted(got["channels"]) == sorted(want["channels"]) == ["DAPI"]
    for metric, agg in want["channels"]["DAPI"].items():
        rtol, atol = QC_TIERS[metric]
        for stat in ("min", "max", "mean"):
            np.testing.assert_allclose(got["channels"]["DAPI"][metric][stat], agg[stat],
                                       rtol=rtol, atol=atol)


def test_qc_off_writes_no_profile_and_the_same_store(qc_runs):
    assert not list((qc_runs / "off" / "workflow").glob("qc*.json"))
    on, off = ExperimentStore.open(qc_runs / "port"), ExperimentStore.open(qc_runs / "off")
    assert_same_labels(on, off)
    for name in ("nuclei", "cells"):
        a, b = on.read_features(name), off.read_features(name)
        assert list(a) == list(b)
        for k in a:
            assert np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f"), k
    ref = JStore.open(qc_runs / "ref")
    assert_same_labels(on, ref)
    for name in ("nuclei", "cells"):
        assert_same_features(ref.read_features(name), on.read_features(name))


def test_the_qc_verb_judges_the_run_against_the_reference(qc_runs, capsys, monkeypatch):
    monkeypatch.delenv("TMX_QC_BASELINE", raising=False)
    root, ref = str(qc_runs / "port"), str(qc_runs / "ref" / "workflow" / "qc.json")
    for kind in ("run", "model"):
        rc = cli.main(["qc", "--root", root, "--json", "--reference", ref,
                       "--profile-kind", kind])
        out = json.loads(capsys.readouterr().out)
        want = qc.compare_profiles(
            qc.filter_profile_kind(qc.load_profile(qc_runs / "port" / "workflow" / "qc.json"),
                                   kind),
            qc.filter_profile_kind(qc.load_profile(ref), kind))
        assert rc == out["verdict"]["exit_code"] == want["exit_code"] == qc.EXIT_OK
        assert out["verdict"]["checked"] == want["checked"] > 0
    assert cli.main(["qc", "--root", str(qc_runs / "off")]) == 1
    assert cli.main(["qc", "--root", root]) == qc.EXIT_NO_REFERENCE


def test_cli_submit_qc_sets_the_gate(qc_runs, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TMX_QC", "0")
    copy_store(qc_runs / "src", tmp_path / "x")
    reset_routers()
    qc.reset_session()
    try:
        assert cli.main(["workflow", "submit", "--root", str(tmp_path / "x"), "--description",
                         str(qc_runs / "wf.json"), "--device", "cpu", "--qc"]) == 0
        assert qc.enabled()
    finally:
        qc.reset_session()
    capsys.readouterr()
    assert sequence(tmp_path / "x") == sequence(qc_runs / "port")
    assert (tmp_path / "x" / "workflow" / "qc.json").exists()
    assert cli.main(["workflow", "submit", "--root", str(tmp_path / "x"), "--description",
                     str(qc_runs / "wf.json"), "--device", "cpu", "--no-qc"]) == 0
    assert not qc.enabled()
