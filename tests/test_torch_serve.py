"""The port's serve daemon against the JAX package's, over one spool.

Two copies of one serve root, one for each package: two tenants of real
workflow jobs (metaconfig -> imextract -> jterator, config 3) over
experiments of 4 sites of 64x64 written as PNGs, a ``kind: query`` job
over a store with features, a job whose deadline expires mid-run, a
duplicate submission and a burst that sheds at ``max_queue`` 6.  The
port's daemon runs with ``device="cpu"``, the reference's as it runs on
the CPU.  A fake clock in each ``serve`` module jumps a day ahead when
the deadline job's first jterator batch persists, so the deadline lands
mid-run at the same batch boundary in both.  Held:

- the admitted and rejected sets with their reasons, and the done,
  failed and expired sets, equal the reference's;
- each job's store equals the reference's (labels exact, features within
  ``FEATURE_TIERS``), and the expired job persisted the same batches;
- each package's ``serve_status_view``, ``slo.report`` and
  ``registry_from_ledger`` read the other's serve ledger as their own;
- the live registry's ``tmx_serve_*``/``tmx_slo_*`` counters equal the
  ledger replay's;
- the verbs over the port's root: ``serve status``, ``metrics`` (live and
  ledger), ``top --once``, ``timeline --json``, ``trace --export chrome``
  (one flow per trace id) and ``slo``;
- ``affinity_key_for`` gives the reference's digest.
"""

import json
import shutil
import time

import numpy as np
import pytest
import torch

from chip_smoke import FEATURE_TIERS
from test_torch_workflow_steps import assert_same_features, assert_same_labels
from tmlibrary_tpu import capacity as j_capacity
from tmlibrary_tpu import resilience as j_resilience
from tmlibrary_tpu import serve as j_serve
from tmlibrary_tpu import slo as j_slo
from tmlibrary_tpu import telemetry as j_tel
from tmlibrary_tpu.models.experiment import Experiment as JExperiment
from tmlibrary_tpu.models.store import ExperimentStore as JStore
from tmlibrary_tpu.workflow import admission as j_adm
from tmlibrary_tpu.workflow import engine as j_engine
from tmlibrary_tpu_torch import benchmarks, capacity, cli, resilience, serve, slo, telemetry
from tmlibrary_tpu_torch import yamlio
from tmlibrary_tpu_torch.io import png
from tmlibrary_tpu_torch.models.store import ExperimentStore
from tmlibrary_tpu_torch.workflow import admission, engine
from tmlibrary_tpu_torch.workflow.engine import Workflow, WorkflowDescription

torch.set_num_threads(1)

#: experiment name -> (seed, jterator batch size)
EXPERIMENTS = {"p1": (1, 2), "p2": (2, 2), "d1": (3, 2), "late": (4, 1), "q": (5, 2)}
WEIGHTS = {"prod": 3.0, "dev": 1.0}
MAX_QUEUE = 6
#: submission times of the spooled jobs (both spools use the same ones)
T0 = time.time()


def write_sources(src, seed: int) -> None:
    data = benchmarks.synthetic_cell_painting_batch(4, size=64, n_cells=8, seed=seed)
    src.mkdir(parents=True)
    for i in range(4):
        for ch in ("DAPI", "Actin"):
            png.write(src / f"A01_s{i}_{ch}.png", data[ch][i].astype(np.uint16))


def make_experiment(root, src, batch_size: int, reference: bool) -> None:
    """An empty store whose workflow.yaml runs metaconfig -> imextract ->
    jterator (config 3 from ``cp.pipe.yaml``) over the PNGs in ``src``."""
    if reference:
        JStore.create(root, JExperiment(name=root.name, plates=[], channels=[],
                                        site_height=1, site_width=1))
    else:
        assert cli.main(["create", "--root", str(root), "--name", root.name]) == 0
    (root / "cp.pipe.yaml").write_text(yamlio.safe_dump(benchmarks.CELL_PAINTING_PIPE))
    WorkflowDescription.canonical({
        "metaconfig": {"source_dir": str(src), "sites_per_well_x": 2},
        "imextract": {},
        "jterator": {"pipe": "cp.pipe.yaml", "batch_size": batch_size, "max_objects": 32},
    }).save(root / "workflow" / "workflow.yaml")


def job_specs(mod, exps: dict) -> list:
    """The spool's jobs (file name, spec) for one package's experiments."""
    spec = lambda jid, tenant, exp, i, **kw: mod.JobSpec(
        job_id=jid, tenant=tenant, root=str(exps[exp]), submitted_at=T0 + i,
        trace_id=f"trace-{jid}", **kw)
    jobs = [("a-p1", spec("a-p1", "prod", "p1", 0)),
            ("a-p2", spec("a-p2", "prod", "p2", 1)),
            ("a-d1", spec("a-d1", "dev", "d1", 2)),
            ("a-late", spec("a-late", "dev", "late", 3, deadline=T0 + 3_600.0)),
            ("a-q", spec("a-q", "dev", "q", 4, kind="query",
                         payload={"tool": "knn", "objects_name": "nuclei", "k": 3,
                                  "index": "brute"})),
            # the same job id again under another file name: a duplicate
            ("a-p1x", spec("a-p1", "prod", "p1", 5))]
    jobs += [(f"z-b{i:02d}", spec(f"z-b{i:02d}", "burst", "p1", 10 + i)) for i in range(8)]
    return jobs


class FakeClock:
    """``time`` for a serve module: the wall clock plus ``offset``."""

    def __init__(self):
        self.offset = 0.0
        self.monotonic, self.sleep, self.perf_counter = (time.monotonic, time.sleep,
                                                         time.perf_counter)

    def time(self) -> float:
        return time.time() + self.offset


def run_daemon(pkg, serve_root, exps, tel, ledger_cls, adm, mp, **kw) -> int:
    """Spool the jobs and run one package's daemon over them, jumping the
    serve clock a day ahead at the deadline job's first jterator batch."""
    clock = FakeClock()
    mp.setattr(pkg, "time", clock)
    original = ledger_cls.append_batch_done

    def append_batch_done(self, step, batch, **fields):
        out = original(self, step, batch, **fields)
        if step == "jterator" and tel.trace_context().get("job") == "a-late":
            clock.offset = 2 * 86_400.0
        return out

    mp.setattr(ledger_cls, "append_batch_done", append_batch_done)
    pkg.ensure_layout(serve_root)
    for name, spec in job_specs(adm, exps):
        from tmlibrary_tpu_torch.atomicio import atomic_write_json

        atomic_write_json(pkg.spool_dir(serve_root, "incoming") / f"{name}.json",
                          spec.to_dict())
    return pkg.run_serve(serve_root, admission=adm.AdmissionConfig(
        max_queue=MAX_QUEUE, tenant_weights=dict(WEIGHTS)), poll_s=0.01, max_jobs=6,
        install_handlers=False, **kw)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    base = tmp_path_factory.mktemp("serve")
    for name, (seed, _) in EXPERIMENTS.items():
        write_sources(base / "src" / name, seed)
    exps = {}
    for side in ("port", "ref"):
        exps[side] = {name: base / side / name for name in EXPERIMENTS}
        for name, (_, bs) in EXPERIMENTS.items():
            if name != "q":
                make_experiment(exps[side][name], base / "src" / name, bs, side == "ref")
    # the query store: the port writes the shards, the reference gets a copy
    make_experiment(exps["port"]["q"], base / "src" / "q", 2, False)
    capacity.reset_routing_history()
    Workflow(ExperimentStore.open(exps["port"]["q"]), WorkflowDescription.load(
        exps["port"]["q"] / "workflow" / "workflow.yaml"), device="cpu").run()
    shutil.copytree(exps["port"]["q"], exps["ref"]["q"])

    mp = pytest.MonkeyPatch()
    try:
        telemetry.reset_registry(enabled=True)
        capacity.reset_routing_history()
        rc_port = run_daemon(serve, base / "port" / "srv", exps["port"], telemetry,
                             engine.RunLedger, admission, mp, device="cpu")
        live = telemetry.get_registry().snapshot()
        j_tel.reset_registry(enabled=True)
        j_capacity.reset_routing_history()
        rc_ref = run_daemon(j_serve, base / "ref" / "srv", exps["ref"], j_tel,
                            j_engine.RunLedger, j_adm, mp)
    finally:
        mp.undo()
        telemetry.reset_registry()
        j_tel.reset_registry()
        capacity.reset_routing_history()
        j_capacity.reset_routing_history()
    return {"base": base, "exps": exps, "rc": (rc_port, rc_ref), "live": live,
            "port": base / "port" / "srv", "ref": base / "ref" / "srv"}


def outcomes(root) -> dict:
    """Job file name -> terminal spool state."""
    out = {}
    for state in ("done", "failed", "expired", "rejected", "incoming", "admitted"):
        for f in serve.spool_dir(root, state).glob("*.json"):
            out[f.stem] = state
    return out


def decisions(root) -> list:
    events = serve.serve_ledger_events(root)
    return sorted((e["event"], e["job"], e.get("tenant"), e.get("reason"))
                  for e in events if e.get("event") in (
                      "job_admitted", "job_rejected", "job_done", "job_failed",
                      "job_expired"))


def test_outcomes_equal_the_references(served):
    assert served["rc"] == (0, 0)
    ours, ref = outcomes(served["port"]), outcomes(served["ref"])
    assert ours == ref
    assert {k for k, v in ours.items() if v == "done"} == \
        {"a-p1", "a-p2", "a-d1", "a-q", "z-b00"}
    assert ours["a-late"] == "expired" and ours["a-p1x"] == "rejected"
    assert decisions(served["port"]) == decisions(served["ref"])
    reasons = [d[3] for d in decisions(served["port"]) if d[0] == "job_rejected"]
    assert reasons.count("queue_full") == 7 and reasons.count("duplicate") == 1
    expired = [e for e in serve.serve_ledger_events(served["port"])
               if e.get("event") == "job_expired"]
    assert expired[0]["step"] == "jterator"


def test_each_job_store_equals_the_references(served):
    exps = served["exps"]
    for name in ("p1", "p2", "d1"):
        port, ref = ExperimentStore.open(exps["port"][name]), JStore.open(exps["ref"][name])
        assert_same_labels(port, ref)
        for objects in ("nuclei", "cells"):
            assert_same_features(ref.read_features(objects), port.read_features(objects),
                                 tiers=FEATURE_TIERS)
    done = lambda side: sorted(e["batch"] for e in engine.RunLedger(
        exps[side]["late"] / "workflow" / "ledger.jsonl").events()
        if e.get("event") == "batch_done" and e.get("step") == "jterator")
    assert done("port") == done("ref") and len(done("port")) < 4
    q = json.loads((serve.spool_dir(served["port"], "done") / "a-q.json").read_text())
    qr = json.loads((serve.spool_dir(served["ref"], "done") / "a-q.json").read_text())
    assert q["summary"]["key"] == qr["summary"]["key"]
    assert q["summary"]["n_objects"] == qr["summary"]["n_objects"]


def _static(view):
    """A status view without the fields that age with the wall clock, and
    without the reader's own toolchain fingerprint (JAX's, or None)."""
    if isinstance(view, dict):
        return {k: _static(v) for k, v in view.items()
                if "age" not in k and k not in ("ts", "live", "fingerprint")}
    if isinstance(view, list):
        return [_static(v) for v in view]
    return view


@pytest.mark.parametrize("side", ["port", "ref"])
def test_each_package_reads_the_others_serve_ledger(served, side):
    root = served[side]
    assert _static(serve.serve_status_view(root)) == _static(j_serve.serve_status_view(root))
    ours, theirs = serve.serve_ledger_events(root), j_serve.serve_ledger_events(root)
    assert ours == theirs
    now = time.time()
    assert slo.report(ours, now=now) == j_slo.report(ours, now=now)
    assert telemetry.render_prometheus(telemetry.registry_from_ledger(ours).snapshot()) == \
        j_tel.render_prometheus(j_tel.registry_from_ledger(ours).snapshot())


def test_live_counters_equal_the_ledger_replay(served):
    replay = telemetry.registry_from_ledger(serve.serve_ledger_events(served["port"]))
    pick = lambda snap: {(c["name"], tuple(sorted(c["labels"].items()))): c["value"]
                         for c in snap["counters"]
                         if c["name"].startswith(("tmx_serve_", "tmx_slo_"))}
    want = pick(replay.snapshot())
    assert want and pick(served["live"]) == want
    names = {c["name"] for c in served["live"]["counters"]}
    assert {"tmx_analytics_queries_total", "tmx_runs_total",
            "tmx_jterator_sites_total"} <= names


def test_the_verbs_over_the_port_root(served, tmp_path, capsys):
    root = str(served["port"])
    assert cli.main(["serve", "status", "--root", root]) == 0
    out = capsys.readouterr().out
    assert "serve root:" in out and "prod" in out and "burst" in out
    assert cli.main(["serve", "status", "--root", root, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["spool"]["done"] == 5
    assert cli.main(["metrics", "--root", root, "--source", "live"]) == 0
    live = capsys.readouterr().out
    assert cli.main(["metrics", "--root", root, "--source", "ledger", "--format", "json"]) == 0
    assert json.loads(capsys.readouterr().out)["counters"]
    assert "tmx_serve_jobs_done_total" in live
    assert telemetry.parse_prometheus(live)
    assert cli.main(["top", "--root", root, "--once"]) == 0
    assert "slo prod" in capsys.readouterr().out
    assert cli.main(["timeline", "--root", root, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["series"]
    out = tmp_path / "trace.json"
    assert cli.main(["trace", "--root", root, "--export", "chrome", str(out)]) == 0
    capsys.readouterr()
    doc = json.loads(out.read_text())
    from tmlibrary_tpu_torch import traceexport

    assert traceexport.validate_chrome_trace(doc) == []
    starts = [e["id"] for e in doc["traceEvents"] if e.get("ph") == "s"]
    assert len(starts) == len(set(starts)) > 0  # one flow a trace id
    assert cli.main(["trace", "--root", root]) == 0
    assert "job" in capsys.readouterr().out
    assert cli.main(["slo", "--root", root]) == j_slo.exit_code(
        j_slo.report(j_serve.serve_ledger_events(served["port"])))
    assert cli.main(["slo", "--root", str(tmp_path)]) == slo.EXIT_NO_DATA


def test_affinity_keys_equal_the_references(served):
    for name in EXPERIMENTS:
        root = served["exps"]["port"][name]
        key = serve.affinity_key_for(root)
        assert key is not None and key == j_serve.affinity_key_for(root)
        assert serve.affinity_key_for(root, "workflow/workflow.yaml") == key
    assert serve.affinity_key_for(served["base"] / "nowhere") is None


def test_enqueue_verb_writes_the_references_spec(tmp_path, capsys):
    root = tmp_path / "srv"
    assert cli.main(["enqueue", "--root", str(root), "--experiment", str(tmp_path),
                     "--tenant", "prod", "--job-id", "j1", "--deadline", "30",
                     "--trace-id", "t1"]) == 0
    assert "enqueued j1" in capsys.readouterr().out
    spec = json.loads((serve.spool_dir(root, "incoming") / "j1.json").read_text())
    ref = j_adm.JobSpec.from_dict(spec)
    assert ref.tenant == "prod" and ref.trace_id == "t1" and ref.deadline > time.time()
    assert cli.main(["enqueue", "--root", str(root), "--experiment", str(tmp_path),
                     "--kind", "query", "--tool", "knn", "--objects", "nuclei"]) == 0
    capsys.readouterr()
    assert len(list(serve.spool_dir(root, "incoming").glob("*.json"))) == 2


def test_a_missing_card_fails_the_job_not_the_daemon(tmp_path):
    src = tmp_path / "src"
    write_sources(src, 9)
    make_experiment(tmp_path / "e", src, 2, False)
    sroot = tmp_path / "srv"
    serve.enqueue_job(sroot, admission.JobSpec(job_id="j", root=str(tmp_path / "e"),
                                               submitted_at=T0))
    assert serve.run_serve(sroot, poll_s=0.01, max_jobs=1, install_handlers=False,
                           device="cuda") == 0  # no card here
    failed = [e for e in serve.serve_ledger_events(sroot) if e.get("event") == "job_failed"]
    assert failed and failed[0]["exception"] == "DeviceError"
    assert not (tmp_path / "e" / "workflow" / "ledger.jsonl").exists()
    resilience.clear_preemption()
    j_resilience.clear_preemption()


def test_atomic_writes_from_threads_of_one_process(tmp_path):
    """Threads of one process writing one path (the daemon's lease
    renewer and main loop on its heartbeat) never take each other's temp
    file: every write lands whole and none is left behind."""
    import threading

    from tmlibrary_tpu_torch.atomicio import atomic_write_json

    path = tmp_path / "heartbeat.h1.json"
    errors = []

    def writer(k):
        try:
            for i in range(300):
                atomic_write_json(path, {"writer": k, "i": i})
        except OSError as e:
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert json.loads(path.read_text())["i"] == 299
    assert sorted(p.name for p in tmp_path.iterdir()) == [path.name]
