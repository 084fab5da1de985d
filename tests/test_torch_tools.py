"""The port's tools, request manager and ``tool`` verbs against the JAX
package's, on the CPU.

Each tool runs through both packages' ``ToolRequestManager`` over copies
of the same shard files: heatmap and spatial exact, clustering and
classification decisions by ``decision_hold`` with centroids and weights
by ``ANALYTICS_RTOL``, knn by ``knn_hold``, pca by ``ANALYTICS_RTOL``,
the embedding by ``EMBEDDING_MIN_COS``.  Classification's
``randomforest`` (scikit-learn's forest in the reference, reproduced
tree for tree) is held exactly, values and attributes; ``svm`` by
``ovo_hold`` against scikit-learn's one-vs-one decision values at
``SVM_TIER``.  Then the request lifecycle, a background request in its
own process, a reader polling a request while it is rewritten, the
label layer's export and the ``tool`` verbs.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from chip_smoke import (
    EMBEDDING_MIN_COS, SVM_TIER, decision_hold, knn_hold, ovo_hold, rel_hold, subspace_cos,
)
from test_torch_analytics import feature_table, twin_stores
from tmlibrary_tpu_torch.errors import NotSupportedError, RegistryError
from tmlibrary_tpu_torch.tools import ToolRequestManager, get_tool, list_tools
from tmlibrary_tpu_torch.tools.classification import _kbest_anova, softmax_train

torch.set_num_threads(2)

EXAMPLES = [{"site_index": 0, "label": 1, "class": "dim"},
            {"site_index": 0, "label": 2, "class": "dim"},
            {"site_index": 1, "label": 3, "class": "dim"},
            {"site_index": 0, "label": 11, "class": "bright"},
            {"site_index": 0, "label": 12, "class": "bright"},
            {"site_index": 1, "label": 13, "class": "bright"}]


@pytest.fixture
def twins(tmp_path):
    port, ref = twin_stores(tmp_path, {"batch_000": feature_table(np.random.default_rng(21))})
    return port, ref


def both(twins, tool, payload):
    from tmlibrary_tpu.tools import ToolRequestManager as JManager

    port, ref = twins
    return (ToolRequestManager(port, device="cpu").submit(tool, payload),
            JManager(ref).submit(tool, payload))


def same_identity(got, want):
    for c in ("site_index", "label", "plate", "well_row", "well_col"):
        assert np.asarray(got.values[c]).tolist() == want.values[c].tolist(), c


def test_registry_matches_the_reference():
    from tmlibrary_tpu.tools import list_tools as j_list_tools

    assert list_tools() == j_list_tools()
    with pytest.raises(RegistryError):
        get_tool("nope")


def test_heatmap_matches_the_reference_exactly(twins):
    got, want = both(twins, "heatmap", {"objects_name": "nuclei",
                                        "feature": "Intensity_mean_DAPI"})
    same_identity(got, want)
    np.testing.assert_array_equal(got.values["value"], want.values["value"].to_numpy())
    assert got.attributes == want.attributes and got.layer_type == want.layer_type
    (gp,), (wp,) = got.plots, want.plots
    assert gp.type == wp.type == "plate_heatmap"
    gw, ww = gp.figure["wells"], wp.figure["wells"]
    assert [{k: v for k, v in w.items() if k != "mean"} for w in gw] == \
        [{k: v for k, v in w.items() if k != "mean"} for w in ww]
    np.testing.assert_allclose([w["mean"] for w in gw], [w["mean"] for w in ww], rtol=1e-12)
    with pytest.raises(NotSupportedError, match="not found"):
        both(twins, "heatmap", {"objects_name": "nuclei", "feature": "Bogus"})


def test_heatmap_keeps_an_all_nan_well_with_null_mean(tmp_path):
    table = feature_table(np.random.default_rng(2), sites=[0, 1], labels=range(1, 4))
    table["well_col"] = table["site_index"].copy()
    table["Morphology_area"] = np.where(table["well_col"] == 1, np.nan, 100.0 + table["label"])
    port, _ = twin_stores(tmp_path, {"batch_000": table})
    result = ToolRequestManager(port, device="cpu").submit(
        "heatmap", {"objects_name": "nuclei", "feature": "Morphology_area"})
    wells = {w["well_col"]: w["mean"] for w in result.plots[0].figure["wells"]}
    assert wells[1] is None
    np.testing.assert_allclose(wells[0], 102.0)
    json.loads(json.dumps(result.plots[0].figure))


def test_clustering_matches_the_reference(twins):
    got, want = both(twins, "clustering", {"objects_name": "nuclei", "k": 2})
    same_identity(got, want)
    x = np.asarray(got.attributes["centroids"])
    rel_hold("centroids", x, np.asarray(want.attributes["centroids"]))
    assert got.attributes["cluster_sizes"] == want.attributes["cluster_sizes"]
    assert sorted(got.attributes["cluster_sizes"].values()) == [40, 40]
    np.testing.assert_array_equal(got.values["value"], want.values["value"].to_numpy())
    assert abs(got.attributes["inertia"] - want.attributes["inertia"]) <= \
        1e-4 * want.attributes["inertia"]
    assert {k: got.attributes[k] for k in ("k", "features", "index", "index_source")} == \
        {k: want.attributes[k] for k in ("k", "features", "index", "index_source")}


def test_clustering_on_the_ivf_codebook_matches_the_reference(twins):
    got, want = both(twins, "clustering", {"objects_name": "nuclei", "k": 3, "index": "ivf"})
    assert got.attributes["index"] == want.attributes["index"] == "ivf"
    rel_hold("codebook", np.asarray(got.attributes["centroids"]),
             np.asarray(want.attributes["centroids"]))
    np.testing.assert_array_equal(got.values["value"], want.values["value"].to_numpy())


def logits(x, w, b):
    return np.asarray(x, np.float64) @ np.asarray(w, np.float64) + np.asarray(b, np.float64)


def test_softmax_train_matches_the_reference():
    from tmlibrary_tpu.tools.classification import softmax_train as j_train

    r = np.random.default_rng(4)
    x = r.normal(size=(60, 5)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.int32) + (x[:, 2] > 1).astype(np.int32)
    w, b = softmax_train(x, y, 3, device="cpu")
    jw, jb = j_train(x, y, 3)
    rel_hold("weights", w.numpy(), np.asarray(jw))
    rel_hold("bias", b.numpy(), np.asarray(jb))
    z = logits(x, jw, jb)
    decision_hold("predictions", logits(x, w.numpy(), b.numpy()).argmax(1), z.argmax(1), z,
                  np.abs(z).max(axis=1))


def svm_decisions(port, examples):
    """The one-vs-one decision values (libsvm's sign) over the store's
    objects of the port's SVM on the CPU and of the reference's
    scikit-learn SVC, both trained on the examples."""
    from sklearn.svm import SVC

    from tmlibrary_tpu_torch.analytics.store import FeatureStore
    from tmlibrary_tpu_torch.tools import svm

    ids, x, _ = FeatureStore.ensure(port, "nuclei").standardized()
    lookup = {t: i for i, t in enumerate(zip(ids["site_index"].tolist(), ids["label"].tolist()))}
    classes = sorted({e["class"] for e in examples})
    rows = [lookup[(e["site_index"], e["label"])] for e in examples]
    y = [classes.index(e["class"]) for e in examples]
    ref = SVC(kernel="rbf", gamma="scale", decision_function_shape="ovo").fit(x[rows], y)
    dec = ref.decision_function(x)
    own = svm.svc_decision(svm.fit_svc(x[rows], y, device="cpu"), x).numpy()
    return own, (-dec[:, None] if len(classes) == 2 else dec)


@pytest.mark.parametrize("method", ["logreg", "knn", "randomforest", "svm"])
def test_classification_matches_the_reference(twins, method):
    payload = {"objects_name": "nuclei", "method": method, "training_examples": EXAMPLES}
    got, want = both(twins, "classification", payload)
    same_identity(got, want)
    classes = got.attributes["classes"]
    assert classes == want.attributes["classes"]
    keys = ("method", "features", "n_training", "training_accuracy", "class_counts")
    if method == "svm":
        flips = ovo_hold("svm classes", got.values["value"], want.values["value"].to_numpy(),
                         *svm_decisions(twins[0], EXAMPLES), SVM_TIER)
        if flips:
            keys = ("method", "features", "n_training")
    else:
        np.testing.assert_array_equal(got.values["value"], want.values["value"].to_numpy())
    if method == "randomforest":
        assert got.attributes == want.attributes and got.layer_type == want.layer_type
    assert {k: got.attributes[k] for k in keys} == {k: want.attributes[k] for k in keys}
    v = got.values
    bright = [classes[i] for i in v["value"][v["label"] > 10]]
    assert np.mean([c == "bright" for c in bright]) > 0.95


def test_classification_refuses_the_scikit_learn_methods(twins):
    """What the tool still refuses, now that ``svm`` and ``randomforest``
    run: an unknown method, and any method without training examples."""
    port, _ = twins
    mgr = ToolRequestManager(port, device="cpu")
    with pytest.raises(NotSupportedError, match="unknown classification method 'lda'"):
        mgr.submit("classification", {"objects_name": "nuclei", "method": "lda",
                                       "training_examples": EXAMPLES})
    for method in ("logreg", "svm", "randomforest"):
        with pytest.raises(NotSupportedError, match="training_examples"):
            mgr.submit("classification", {"objects_name": "nuclei", "method": method})
    failed = [r for r in mgr.list_requests() if r["state"] == "failed"]
    assert len(failed) == 4


def test_select_k_best_and_anova_match_the_reference(twins):
    from tmlibrary_tpu.tools.classification import _kbest_anova as j_kbest

    r = np.random.default_rng(5)
    y = np.repeat(np.asarray([0, 1], np.int32), 10)
    x = np.column_stack([r.normal(size=20), y.astype(np.float64), r.normal(size=20),
                         np.ones(20)])
    for k in (1, 2, 3):
        np.testing.assert_array_equal(_kbest_anova(x, y, 2, k), j_kbest(x, y, 2, k))
    got, want = both(twins, "classification", {"objects_name": "nuclei",
                                               "training_examples": EXAMPLES,
                                               "select_k_best": 1})
    assert got.attributes["features"] == want.attributes["features"]
    np.testing.assert_array_equal(got.values["value"], want.values["value"].to_numpy())


def test_analytics_tools_match_the_reference(twins):
    port, _ = twins
    from tmlibrary_tpu_torch.analytics.store import FeatureStore

    _, x, _ = FeatureStore.ensure(port, "nuclei").standardized()
    got, want = both(twins, "knn", {"objects_name": "nuclei", "k": 4})
    same_identity(got, want)
    cols = lambda res, p: np.stack([np.asarray(res.values[f"{p}{j}"]) for j in range(4)], 1)  # noqa: E731
    print("knn tool:", knn_hold(x, x, (cols(got, "nn"), cols(got, "nnd")),
                                (cols(want, "nn"), cols(want, "nnd"))))
    assert got.attributes["tile_rows"] == want.attributes["tile_rows"]

    got, want = both(twins, "pca", {"objects_name": "nuclei", "n_components": 2})
    rel_hold("pca scores", np.stack([got.values["pc0"], got.values["pc1"]], 1),
             np.stack([want.values["pc0"], want.values["pc1"]], 1))
    rel_hold("pca components", got.attributes["components"], want.attributes["components"])
    rel_hold("pca ratio", got.attributes["explained_variance_ratio"],
             want.attributes["explained_variance_ratio"])

    got, want = both(twins, "embedding", {"objects_name": "nuclei", "k": 5})
    assert subspace_cos(np.stack([got.values["emb0"], got.values["emb1"]], 1),
                        np.stack([want.values["emb0"], want.values["emb1"]], 1)) \
        >= EMBEDDING_MIN_COS

    for payload in ({"statistic": "density", "grid": 8, "windows": [[0, 0, 0, 8, 8],
                                                                    [3, 1, 2, 5, 7]]},
                    {"statistic": "enrichment", "grid": 8, "radius": 1,
                     "mark_feature": "Intensity_mean_DAPI"}):
        got, want = both(twins, "spatial", {"objects_name": "nuclei", **payload})
        np.testing.assert_array_equal(got.values["value"], want.values["value"].to_numpy())
        assert got.attributes == want.attributes
    with pytest.raises(NotSupportedError, match="window sites"):
        both(twins, "spatial", {"objects_name": "nuclei", "windows": [[99, 0, 0, 4, 4]]})
    with pytest.raises(NotSupportedError, match="statistic"):
        both(twins, "spatial", {"objects_name": "nuclei", "statistic": "ripley"})


# -------------------------------------------------------- request manager
def test_request_lifecycle(twins, monkeypatch):
    port, _ = twins
    mgr = ToolRequestManager(port, device="cpu")
    mgr.submit("clustering", {"objects_name": "nuclei", "k": 2})
    (req,) = mgr.list_requests()
    assert req["state"] == "done" and req["tool"] == "clustering" and req["device"] == "cpu"
    assert req["n_objects"] == 80
    assert req["finished_at"] >= req["started_at"] >= req["submitted_at"]
    assert mgr.status(req["request"])["payload"] == {"objects_name": "nuclei", "k": 2}
    assert [r["tool"] for r in mgr.list_results()] == ["clustering"]
    with pytest.raises(Exception):
        mgr.submit("heatmap", {"objects_name": "nuclei", "feature": "Bogus"})
    failed = [r for r in mgr.list_requests() if r["state"] == "failed"]
    assert len(failed) == 1 and "Bogus" in failed[0]["error"]
    with pytest.raises(RegistryError):
        mgr.create_request("nope", {})
    legacy = port.tools_dir / "clustering_legacy"
    legacy.mkdir()
    (legacy / "result.json").write_text('{"tool": "clustering"}')
    assert mgr.status("clustering_legacy") == {"request": "clustering_legacy", "state": "done"}
    monkeypatch.setattr(time, "time", lambda: 1234.567)
    a, b = mgr.create_request("clustering", {"k": 2}), mgr.create_request("clustering", {"k": 3})
    assert a != b and mgr.status(b)["payload"] == {"k": 3}


def test_request_in_the_background_runs_on_its_device(twins):
    port, _ = twins
    mgr = ToolRequestManager(port, device="cpu")
    request_id = mgr.submit_async("clustering", {"objects_name": "nuclei", "k": 2})
    assert mgr.status(request_id)["device"] == "cpu"
    deadline = time.time() + 120
    while time.time() < deadline and mgr.status(request_id)["state"] not in ("done", "failed"):
        time.sleep(0.5)
    final = mgr.status(request_id)
    log = (port.tools_dir / request_id / "tool.log").read_text()
    assert final["state"] == "done", (final, log)
    assert final["n_objects"] == 80
    assert any(r["request"] == request_id for r in mgr.list_results())


def test_status_never_reads_a_half_written_request(twins):
    """A reader polling ``status`` while another writer updates the
    request (the detached ``run-request`` child) sees whole states only:
    ``request.json`` is replaced by rename, never rewritten in place."""
    port, _ = twins
    mgr = ToolRequestManager(port, device="cpu")
    request_id = mgr.create_request("clustering", {"objects_name": "nuclei", "k": 2,
                                                   "note": "x" * 200_000})
    stop, steps, errors = threading.Event(), [], []

    def poll():
        while not stop.is_set():
            try:
                steps.append(mgr.status(request_id).get("step", -1))
                mgr.list_requests()
            except Exception as exc:  # a torn read: JSONDecodeError
                errors.append(repr(exc))
                return

    reader = threading.Thread(target=poll)
    reader.start()
    try:
        for step in range(300):
            mgr._write_state(request_id, step=step)
    finally:
        stop.set()
        reader.join()
    assert not errors, errors[:1]
    assert steps and steps == sorted(steps)
    assert mgr.status(request_id)["step"] == 299
    leftovers = [p.name for p in (port.tools_dir / request_id).iterdir()
                 if p.name != "request.json"]
    assert leftovers == []


def test_label_layer_export_site_values(twins):
    port, _ = twins
    labels = np.zeros((1, 16, 16), np.int32)
    labels[0, 2:5, 2:5] = 1
    labels[0, 9:12, 9:12] = 11
    port.write_labels(labels, [0], "nuclei")
    result = ToolRequestManager(port, device="cpu").submit(
        "classification", {"objects_name": "nuclei", "training_examples": [
            {"site_index": 0, "label": 1, "class": "dim"},
            {"site_index": 0, "label": 11, "class": "bright"}]})
    layer = result.label_layer()
    assert layer.type == "supervised" and layer.classes == ["bright", "dim"]
    paths = {p.name: p for p in layer.export_site_values(port, port.root / "layer_export")}
    assert sorted(paths) == [f"site_{s:05d}.npz" for s in range(4)]
    data = np.load(paths["site_00000.npz"])
    np.testing.assert_array_equal(data["labels"], labels[0])
    v = result.values
    value = lambda lab: float(v["value"][(v["site_index"] == 0) & (v["label"] == lab)][0])  # noqa: E731
    assert data["values"][3, 3] == value(1) and data["values"][10, 10] == value(11)
    assert {value(1), value(11)} == {0.0, 1.0} and np.isnan(data["values"][0, 0])


def test_tool_cli(twins, capsys):
    from tmlibrary_tpu_torch.cli import main

    port, _ = twins
    root = str(port.root)
    assert main(["tool", "available"]) == 0
    assert capsys.readouterr().out.split() == list_tools()
    assert main(["tool", "submit", "--root", root, "--name", "clustering", "--device", "cpu",
                 "--payload", '{"objects_name": "nuclei", "k": 2}']) == 0
    submitted = json.loads(capsys.readouterr().out)
    assert submitted["tool"] == "clustering" and submitted["n_objects"] == 80
    assert main(["tool", "list", "--root", root, "--device", "cpu"]) == 0
    (line,) = capsys.readouterr().out.strip().splitlines()
    entry = json.loads(line)
    assert entry["state"] == "done"
    assert main(["tool", "status", "--root", root, "--request", entry["request"],
                 "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["payload"] == {"objects_name": "nuclei", "k": 2}
    request_id = ToolRequestManager(port, device="cpu").create_request(
        "heatmap", {"objects_name": "nuclei", "feature": "Morphology_area"})
    assert main(["tool", "run-request", "--root", root, "--request", request_id,
                 "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["state"] == "done"
