"""The port's serve daemon under preemption, hard kills and a fleet.

Every daemon process is ``python -m tmlibrary_tpu_torch.cli serve run
--device cpu`` under ``subprocess.run(..., timeout=...)``; the faults
land at pinned points through ``TMX_FAULT_PLAN`` (the reference's
harness): ``sigterm`` at a jterator batch delivers a real SIGTERM to the
daemon mid-job, ``kill`` hard-exits it there (``os._exit(41)``: no
cleanup, no drain, as SIGKILL leaves it).

- SIGTERM mid-job: exit 75, every job back in ``incoming/``; the restart
  converges to the store an uninterrupted run writes (labels and feature
  tables exact).
- A hard kill mid-job: the restart's startup recovery re-spools the
  admitted job and finishes it to the same store.
- Two hosts on one spool: ``h0`` is held mid-job (a stalled persist)
  and SIGKILLed once ``h1`` is up; ``h1`` reaps the job once the lease
  and ``h0``'s heartbeat are stale and finishes it (``job_reclaimed``
  from ``h0``, exactly one ``job_done``).
- A stale host: a daemon that pauses past its lease in the
  ``done_rename`` window while a peer reclaims and finishes the job gets
  ``stale_claim``; the peer's result stands.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_serve import T0, make_experiment, write_sources
from tmlibrary_tpu_torch import capacity, faults, resilience, serve, telemetry
from tmlibrary_tpu_torch.models.store import ExperimentStore
from tmlibrary_tpu_torch.workflow.admission import JobSpec
from tmlibrary_tpu_torch.workflow.engine import RunLedger, Workflow, WorkflowDescription

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def daemon(serve_root, *args, plan=None, timeout=180):
    """One ``serve run --device cpu`` process to its end."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("TMX_FAULT_PLAN", None)
    if plan is not None:
        env["TMX_FAULT_PLAN"] = json.dumps({"faults": [plan]})
    return subprocess.run(
        [sys.executable, "-m", "tmlibrary_tpu_torch.cli", "serve", "run", "--root",
         str(serve_root), "--device", "cpu", "--poll", "0.02", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def experiments(tmp_path, names, seed0=20) -> dict:
    out = {}
    for i, name in enumerate(names):
        write_sources(tmp_path / "src" / name, seed0 + i)
        make_experiment(tmp_path / name, tmp_path / "src" / name, 2, False)
        out[name] = tmp_path / name
    return out


def enqueue(serve_root, jobs) -> None:
    for i, (jid, tenant, root) in enumerate(jobs):
        serve.enqueue_job(serve_root, JobSpec(job_id=jid, tenant=tenant, root=str(root),
                                              submitted_at=T0 + i, trace_id=f"t-{jid}"))


def uninterrupted(tmp_path, name, seed) -> ExperimentStore:
    """The store a clean in-process run writes over the same sources."""
    root = tmp_path / f"clean_{name}"
    write_sources(tmp_path / "src" / f"clean_{name}", seed)
    make_experiment(root, tmp_path / "src" / f"clean_{name}", 2, False)
    capacity.reset_routing_history()
    Workflow(ExperimentStore.open(root), WorkflowDescription.load(
        root / "workflow" / "workflow.yaml"), device="cpu").run()
    return ExperimentStore.open(root)


def assert_same_store(a: ExperimentStore, b: ExperimentStore) -> None:
    """Labels and feature tables exact.  Rows compare by (site, label):
    the work-aware scheduler may pack a process's later jobs of the same
    pipeline from the sites' history, which orders the shards' rows, not
    their values."""
    for name in ("nuclei", "cells"):
        np.testing.assert_array_equal(a.read_labels(None, name), b.read_labels(None, name))
        x, y = a.read_features(name), b.read_features(name)
        assert list(x) == list(y)
        ox = np.lexsort((x["label"], x["site_index"]))
        oy = np.lexsort((y["label"], y["site_index"]))
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k])[ox], np.asarray(y[k])[oy],
                                          err_msg=k)


def spool(serve_root, state) -> list[str]:
    return sorted(p.stem for p in serve.spool_dir(serve_root, state).glob("*.json"))


def events_of(serve_root, kind) -> list[dict]:
    return [e for e in serve.serve_ledger_events(serve_root) if e.get("event") == kind]


def test_sigterm_mid_job_exits_75_and_the_restart_converges(tmp_path):
    exps = experiments(tmp_path, ["a", "b"])
    sroot = tmp_path / "srv"
    enqueue(sroot, [("a-1", "prod", exps["a"]), ("b-1", "dev", exps["b"])])
    # at the first jterator batch of the first job: the drain stops before its second
    first = daemon(sroot, plan={"site": "batch_run", "kind": "sigterm", "step": "jterator",
                                "batch": 0})
    assert first.returncode == 75, first.stderr[-2000:]
    assert "serve preempted" in first.stderr
    assert spool(sroot, "incoming") == ["a-1", "b-1"] and spool(sroot, "admitted") == []
    pre = events_of(sroot, "serve_preempted")
    assert len(pre) == 1 and pre[0]["requeued"] == 2 and pre[0]["reason"] == "SIGTERM"
    again = daemon(sroot, "--max-jobs", "2")
    assert again.returncode == 0, again.stderr[-2000:]
    assert spool(sroot, "done") == ["a-1", "b-1"]
    done = {e["job"]: e for e in events_of(sroot, "job_done")}
    assert sum(bool(e.get("resumed")) for e in done.values()) == 1  # the interrupted one
    for name, seed in (("a", 20), ("b", 21)):
        assert_same_store(ExperimentStore.open(exps[name]), uninterrupted(tmp_path, name, seed))
        batches = [e["batch"] for e in RunLedger(exps[name] / "workflow" / "ledger.jsonl")
                   .events() if e.get("event") == "batch_done" and e.get("step") == "jterator"]
        assert sorted(batches) == [0, 1]  # nothing ran twice


def test_a_hard_kill_is_recovered_at_startup(tmp_path):
    exps = experiments(tmp_path, ["a"], seed0=30)
    sroot = tmp_path / "srv"
    enqueue(sroot, [("a-1", "prod", exps["a"])])
    dead = daemon(sroot, plan={"site": "batch_run", "kind": "kill", "step": "jterator",
                               "batch": 1})
    assert dead.returncode == 41, dead.stderr[-2000:]
    assert spool(sroot, "admitted") == ["a-1"]  # left behind by the dead daemon
    again = daemon(sroot, "--max-jobs", "1")
    assert again.returncode == 0, again.stderr[-2000:]
    assert spool(sroot, "done") == ["a-1"]
    assert events_of(sroot, "serve_started")[-1]["recovered"] == 1
    assert_same_store(ExperimentStore.open(exps["a"]), uninterrupted(tmp_path, "a", 30))


def jterator_batches(root) -> list:
    return sorted(e["batch"] for e in RunLedger(root / "workflow" / "ledger.jsonl").events()
                  if e.get("event") == "batch_done" and e.get("step") == "jterator")


def wait_for(cond, what: str, timeout: float = 120.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


def test_a_sigkilled_fleet_peer_is_reaped_and_its_job_finished(tmp_path):
    exps = experiments(tmp_path, ["a"], seed0=40)
    sroot = tmp_path / "srv"
    enqueue(sroot, [("a-1", "prod", exps["a"])])
    # h0 claims the job and is held mid-job (its second batch's persist
    # stalls) while it renews its lease; h1 comes up, then h0 gets
    # SIGKILL: the reaper, not startup recovery, must take the job back.
    # A lease of 3 s: a loaded machine can delay a renewal by a second
    box = {}
    stall = {"site": "persist", "kind": "hang", "step": "jterator", "batch": 1,
             "seconds": 150}
    h0 = threading.Thread(target=lambda: box.update(h0=daemon(
        sroot, "--host", "h0", "--lease", "3", plan=stall)))
    h0.start()
    wait_for(lambda: jterator_batches(exps["a"]), "h0 never persisted a batch")
    h1 = threading.Thread(target=lambda: box.update(h1=daemon(
        sroot, "--host", "h1", "--lease", "3", "--max-jobs", "1", "--idle-exit", "60")))
    h1.start()
    wait_for(lambda: serve.heartbeat_file(sroot, "h1").exists(), "h1 never came up")
    os.kill(telemetry.read_heartbeat(serve.heartbeat_file(sroot, "h0"))["pid"],
            signal.SIGKILL)
    killed = time.time()
    h0.join(timeout=180)
    h1.join(timeout=180)
    assert box["h0"].returncode == -signal.SIGKILL
    assert box["h1"].returncode == 0, box["h1"].stderr[-2000:]
    assert spool(sroot, "done") == ["a-1"] and serve.job_claims(sroot) == []
    started = events_of(sroot, "serve_started")
    assert [(e["host"], e["recovered"]) for e in started] == [("h0", 0), ("h1", 0)]
    reclaimed = events_of(sroot, "job_reclaimed")
    assert [(e["job"], e["from_host"], e["host"]) for e in reclaimed] == [("a-1", "h0", "h1")]
    assert reclaimed[0]["ts"] >= killed
    assert [(e["job"], e["host"]) for e in events_of(sroot, "job_done")] == [("a-1", "h1")]
    assert {p.name for p in serve.serve_ledger_paths(sroot)} == {"ledger.h0.jsonl",
                                                                 "ledger.h1.jsonl"}
    assert jterator_batches(exps["a"]) == [0, 1]  # h1 resumed h0's persisted batch
    assert_same_store(ExperimentStore.open(exps["a"]), uninterrupted(tmp_path, "a", 40))


def test_a_stale_host_gets_stale_claim_not_a_clobbered_result(tmp_path):
    exps = experiments(tmp_path, ["a"], seed0=50)
    sroot = tmp_path / "srv"
    enqueue(sroot, [("a-1", "prod", exps["a"])])
    telemetry.reset_registry(enabled=True)
    faults.install(faults.FaultPlan([faults.FaultSpec(site="done_rename", kind="hang",
                                                      seconds=1.5)]))
    try:
        victim = serve.ServeDaemon(sroot, poll_s=0.01, install_handlers=False, host="h1",
                                   lease_s=0.3, device="cpu")
        victim._scan_incoming()
        job = victim.queue.take()
        result = {}
        worker = threading.Thread(target=lambda: result.update(out=victim._execute(job)))
        worker.start()
        peer = serve.ServeDaemon(sroot, poll_s=0.01, install_handlers=False, host="h2",
                                 lease_s=5.0, device="cpu")
        deadline = time.monotonic() + 30
        while not peer._reap_expired():
            assert time.monotonic() < deadline, "the peer never reclaimed the paused job"
            time.sleep(0.05)
        faults.clear()
        peer._scan_incoming()
        assert peer._execute(peer.queue.take()) == "done"
        winner = (serve.spool_dir(sroot, "done") / "a-1.json").read_bytes()
        worker.join(timeout=30)
        assert not worker.is_alive() and result["out"] == "stale"
    finally:
        faults.clear()
        resilience.clear_preemption()
    assert (serve.spool_dir(sroot, "done") / "a-1.json").read_bytes() == winner
    stale = events_of(sroot, "stale_claim")
    assert [(e["job"], e["host"], e["outcome"]) for e in stale] == [("a-1", "h1", "done")]
    assert [e["host"] for e in events_of(sroot, "job_done")] == ["h2"]
    assert telemetry.get_registry().counter("tmx_serve_stale_claims_total", tenant="prod",
                                            host="h1").value == 1
    telemetry.reset_registry()
