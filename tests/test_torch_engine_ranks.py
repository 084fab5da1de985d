"""The engine's retries, pipelining and stops at several ranks, on two
gloo ranks held against one rank.

Config 3 (``test_torch_workflow_steps``' 16 sites of 64x64, the jterator
step sharded over ``n_devices=2``, buckets ``2,4`` so batches escalate
in their persists) runs on two ranks spawned once (``file://`` init),
in three scenarios over fresh copies of one store:

- a ``batch_run`` fault on rank 1 alone at batch 2 (rank 0's plan only
  forces the sequential path): rank 0 decides the retry for both ranks,
  the batch is retried and the store equals the one-rank store;
- a ``persist`` fault on rank 0 alone at batch 1 in the pipelined window
  (which runs at several ranks now), before the persist whose
  escalation re-launches the batch, a collective: the fault is agreed
  before it, the failure is yielded in its turn on both ranks, retried
  on both, and the store is the one-rank store;
- a stop on rank 0 once a batch is done: both ranks drain at the same
  batch and raise the same :class:`PreemptedError`, rank 0 records
  ``run_preempted``, and a resume on two ranks completes to the one-rank
  store.
"""

import os
import pickle
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from test_torch_workflow_steps import copy_store, corrected_aligned_pipe, make_store
from tmlibrary_tpu_torch import capacity
from tmlibrary_tpu_torch.models.store import ExperimentStore
from tmlibrary_tpu_torch.workflow.engine import RunLedger, Workflow, WorkflowDescription

torch.set_num_threads(1)

JTERATOR = {"pipe": "plain.pipe.json", "cycle": 0, "batch_size": 4, "max_objects": 64,
            "n_devices": 2, "object_buckets": "2,4"}
NEVER = {"site": "batch_run", "step": "jterator", "batch": 999}
PLANS = {
    "retry_sequential": ({"faults": [NEVER]},
                         {"faults": [{"site": "batch_run", "kind": "device_loss",
                                      "step": "jterator", "batch": 2}]}),
    "retry_pipelined": ({"faults": [{"site": "persist", "kind": "io_error",
                                     "step": "jterator", "batch": 1}]}, None),
    "stop": (None, None),
}


def description() -> WorkflowDescription:
    return WorkflowDescription.canonical({"jterator": JTERATOR})


def fresh(src, dst):
    copy_store(src, dst)
    return dst


def _worker(rank: int, world: int, init: str, base: str) -> None:
    from tmlibrary_tpu_torch import faults
    from tmlibrary_tpu_torch.errors import PreemptedError
    from tmlibrary_tpu_torch.parallel import distributed

    distributed.initialize(f"file://{init}", world, rank, device="cpu")
    out = {}
    try:
        for name, plans in PLANS.items():
            capacity.reset_routing_history()
            plan = plans[rank]
            if plan is not None:
                faults.install(faults.FaultPlan.from_dict(plan))
            root = os.path.join(base, name)
            stop = None
            if name == "stop" and rank == 0:
                ledger = RunLedger(os.path.join(root, "workflow", "ledger.jsonl"))
                stop = lambda: len(ledger.completed_batches("jterator")) >= 1  # noqa: E731
            wf = Workflow(ExperimentStore.open(root), description(), device="cpu",
                          should_stop=stop)
            try:
                out[name] = wf.run()
            except PreemptedError as exc:
                out[name] = ("preempted", exc.step, exc.in_flight, exc.drained, exc.abandoned)
            finally:
                faults.clear()
            if name == "stop":
                capacity.reset_routing_history()
                out["resume"] = Workflow(ExperimentStore.open(root), description(),
                                         device="cpu").run(resume=True)
        with open(os.path.join(base, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        distributed.shutdown()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("ranks")
    make_store(base / "src")
    (base / "src" / "plain.pipe.json").write_text(
        __import__("json").dumps(corrected_aligned_pipe(correct=False)))
    for name in (*PLANS, "one"):
        fresh(base / "src", base / name)
    capacity.reset_routing_history()
    try:
        Workflow(ExperimentStore.open(base / "one"), description(), device="cpu").run()
    finally:
        # the routing history is process-wide: leave none for later tests
        capacity.reset_routing_history()
    mp.spawn(_worker, args=(2, str(base / "init"), str(base)), nprocs=2)
    ranks = []
    for r in range(2):
        with open(base / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return base, ranks


def same_store(a: ExperimentStore, b: ExperimentStore) -> None:
    for name in ("nuclei", "cells"):
        np.testing.assert_array_equal(a.read_labels(None, name), b.read_labels(None, name))
        fa, fb = a.read_features(name), b.read_features(name)
        assert list(fa) == list(fb)
        for col in fa:
            np.testing.assert_array_equal(np.asarray(fa[col]), np.asarray(fb[col]),
                                          err_msg=f"{name}.{col}")


def events(root, kind):
    return [e for e in RunLedger(root / "workflow" / "ledger.jsonl").events()
            if e.get("event") == kind]


@pytest.mark.parametrize("name,batch", [("retry_sequential", 2), ("retry_pipelined", 1)])
def test_a_fault_on_one_rank_is_retried_on_both(runs, name, batch):
    base, ranks = runs
    assert ranks[1][name] == {}
    assert ranks[0][name]["jterator"]["n_batches"] == 4
    same_store(ExperimentStore.open(base / name), ExperimentStore.open(base / "one"))
    attempts = {e["batch"]: e["attempts"] for e in events(base / name, "batch_done")}
    assert attempts == {b: (2 if b == batch else 1) for b in range(4)}
    assert not events(base / name, "batch_failed")
    done = next(e for e in events(base / name, "step_done"))
    assert ("pipeline_stats" in done) == (name == "retry_pipelined")


def test_a_stop_drains_both_ranks_at_one_batch_and_resumes(runs):
    base, ranks = runs
    # depth 2: batches 0-2 launched, 0 persisted, the stop before batch 3
    # drains 1 and 2 and abandons 3
    assert ranks[0]["stop"] == ranks[1]["stop"] == ("preempted", "jterator", 2, 2, 1)
    (pre,) = events(base / "stop", "run_preempted")
    assert (pre["step"], pre["drained"], pre["abandoned"]) == ("jterator", 2, 1)
    assert ranks[0]["resume"]["jterator"]["n_batches"] == 4 and ranks[1]["resume"] == {}
    same_store(ExperimentStore.open(base / "stop"), ExperimentStore.open(base / "one"))
