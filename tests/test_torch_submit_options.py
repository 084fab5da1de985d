"""``workflow submit``'s last options on the CPU: ``--reduction-strategy``,
``--object-buckets`` and ``--schedule`` set the jterator step's arguments
of those names for the run, and ``--profile DIR`` traces it; none of
them moves the store.  Config 3 over ``test_torch_workflow_steps``' 16
sites of 64x64 (corilla, then jterator corrected), run with the defaults,
with the three options set together, and traced: labels and every
feature column equal bit for bit, the options land in the batch
arguments, and the trace holds the step's and the batches' ranges.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_workflow_steps import CORILLA, JTERATOR, copy_store, make_store
from tmlibrary_tpu_torch import capacity, cli
from tmlibrary_tpu_torch.models.store import ExperimentStore
from tmlibrary_tpu_torch.workflow.engine import WorkflowDescription

torch.set_num_threads(1)

OPTIONS = {"defaults": [], "options": ["--reduction-strategy", "fused", "--object-buckets",
                                       "off", "--schedule", "off"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("options")
    make_store(base / "src")
    WorkflowDescription.canonical({"corilla": CORILLA, "jterator": JTERATOR}).save(
        base / "wf.json")
    try:
        for name, extra in {**OPTIONS, "profiled": ["--profile", str(base / "trace")]}.items():
            copy_store(base / "src", base / name)
            capacity.reset_routing_history()
            assert cli.main(["workflow", "submit", "--root", str(base / name), "--description",
                             str(base / "wf.json"), "--device", "cpu", *extra]) == 0
    finally:
        # the routing history is process-wide: leave none for later tests
        capacity.reset_routing_history()
    return base


def same_store(a: ExperimentStore, b: ExperimentStore) -> None:
    for name in ("nuclei", "cells"):
        np.testing.assert_array_equal(a.read_labels(None, name), b.read_labels(None, name))
        fa, fb = a.read_features(name), b.read_features(name)
        assert list(fa) == list(fb)
        for col in fa:
            np.testing.assert_array_equal(np.asarray(fa[col]), np.asarray(fb[col]), err_msg=col)


@pytest.mark.parametrize("name", ["options", "profiled"])
def test_the_store_is_the_defaults(runs, name):
    same_store(ExperimentStore.open(runs / name), ExperimentStore.open(runs / "defaults"))


def test_the_options_are_the_steps_arguments(runs):
    batch = json.loads(next((runs / "options").glob("**/jterator/batch_000.json")).read_text())
    args = batch["args"]
    assert (args["reduction_strategy"], args["object_buckets"], args["schedule"]) == \
        ("fused", "off", "off")
    default = json.loads(next((runs / "defaults").glob("**/jterator/batch_000.json"))
                         .read_text())["args"]
    assert default["object_buckets"] == JTERATOR["object_buckets"]


def test_the_profiled_run_writes_a_trace_with_its_ranges(runs):
    (path,) = (runs / "trace").glob("*.pt.trace.json")
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"run", "run/step:corilla", "run/step:jterator", "batch:0", "batch:3"} <= names
