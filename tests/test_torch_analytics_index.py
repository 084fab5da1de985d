"""The port's k-means, IVF index, mode resolution and fused queries
against the JAX package's, on the CPU.

k-means (both seedings) and the empty-cluster reseed against the
reference's: centroids by ``ANALYTICS_RTOL``, assignments by
``decision_hold``; the IVF build (cells the same way, members from
them) and search (``knn_hold``), persistence keyed on the store digest,
the brute-force fallback, the precedence chain (without the reference's
tuned link), ``run_query_batch`` against the sequential path and the
reference's keys, and the ``index`` verb.
"""

import json

import numpy as np
import pytest
import torch

from chip_smoke import decision_hold, knn_hold, rel_hold
from test_torch_analytics import feature_table, sync_shards, twin_stores
from tmlibrary_tpu_torch.analytics import index as aidx
from tmlibrary_tpu_torch.analytics import ops
from tmlibrary_tpu_torch.analytics.query import (
    fusion_signature, query_key, run_query, run_query_batch,
)
from tmlibrary_tpu_torch.analytics.store import FeatureStore
from tmlibrary_tpu_torch.errors import NotSupportedError
from tmlibrary_tpu_torch.tools.base import ToolResult
from tmlibrary_tpu_torch.tools.clustering import _reseed_empty, kmeans, stride_rows

torch.set_num_threads(2)


def blobs(r, n, f=8, n_blobs=24, spread=0.15):
    centers = r.normal(size=(n_blobs, f))
    labels = r.integers(0, n_blobs, size=n)
    return (centers[labels] + spread * r.normal(size=(n, f))).astype(np.float32)


def sq_dist(x, c):
    x, c = np.asarray(x, np.float64), np.asarray(c, np.float64)
    return ((x[:, None, :] - c[None]) ** 2).sum(-1)


def hold_kmeans(name, x, got, want) -> int:
    """Centroids by ANALYTICS_RTOL; assignments equal but for rows whose
    two candidate centroids (the reference's) are a near tie."""
    ga, gc = (np.asarray(a) for a in got)
    wa, wc = (np.asarray(a) for a in want)
    rel_hold(f"{name} centroids", gc, wc)
    d2 = sq_dist(x, wc)
    scale = (np.asarray(x, np.float64) ** 2).sum(1) + (wc.astype(np.float64) ** 2).sum(1).max()
    return decision_hold(f"{name} assignments", ga, wa, d2, scale)


# ---------------------------------------------------------------- k-means
def test_reseed_empty_matches_the_reference():
    from tmlibrary_tpu.tools.clustering import _reseed_empty as j_reseed

    x = np.array([[0.0, 0.0], [1.0, 0.0], [10.0, 0.0], [11.0, 0.0]], np.float32)
    updated = np.array([[0.5, 0.0], [99.0, 99.0], [7.0, 7.0]], np.float32)
    d_assign = np.array([0.5, 10.5, 9.5, 10.5], np.float32)  # a tie: the lower row wins
    for counts in ([4.0, 0.0, 0.0], [2.0, 2.0, 0.0], [2.0, 1.0, 1.0]):
        c = np.array(counts, np.float32)
        got = _reseed_empty(torch.from_numpy(updated), torch.from_numpy(c),
                            torch.from_numpy(x), torch.from_numpy(d_assign)).numpy()
        np.testing.assert_array_equal(got, np.asarray(j_reseed(updated, c, x, d_assign)))


def reference_step(x, cent):
    """One Lloyd step as the reference's ``kmeans`` writes it, in JAX:
    (assignment, its squared distance, the updated centroids)."""
    import jax
    import jax.numpy as jnp

    from tmlibrary_tpu.tools.clustering import _reseed_empty as j_reseed

    x, cent = jnp.asarray(x), jnp.asarray(cent)
    k = cent.shape[0]
    d2 = (jnp.sum(x ** 2, axis=1, keepdims=True) - 2.0 * x @ cent.T
          + jnp.sum(cent ** 2, axis=1)[None])
    assign = jnp.argmin(d2, axis=1)
    sums = jax.ops.segment_sum(x, assign, num_segments=k)
    counts = jax.ops.segment_sum(jnp.ones((x.shape[0],), jnp.float32), assign, num_segments=k)
    new = jnp.where(counts[:, None] > 0, sums / jnp.maximum(counts[:, None], 1.0), cent)
    d_min = jnp.min(d2, axis=1)
    return np.array(assign), np.array(d_min), np.array(j_reseed(new, counts, x, d_min))


@pytest.mark.parametrize("init,k", [("greedy", 5), ("greedy", 8), ("stride", 20)])
def test_kmeans_matches_the_reference(init, k):
    """Seeds exact; every Lloyd step of the reference's trajectory held
    half by half (the assignment by the near-tie rule, the update from
    the reference's assignment by ANALYTICS_RTOL); the final answer by
    the same tiers where no row flipped on the way.  A flip is a near
    tie decided the other way, and it moves a centroid by a row's share
    of its cluster: with 20 centroids over 10 blobs rows sit on such
    ties, so that run's trajectories part after a flip (counted)."""
    from tmlibrary_tpu.tools.clustering import kmeans as j_kmeans
    from tmlibrary_tpu_torch.tools.clustering import lloyd_assign, lloyd_update

    x = blobs(np.random.default_rng(k), 600, f=6, n_blobs=10)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(kmeans(x, k, n_iter=0, init=init, device="cpu")[1].numpy(),
                                  np.asarray(j_kmeans(x, k, n_iter=0, init=init)[1]))
    step_flips = 0
    for t in (0, 1, 4, 12, 24):
        cent = np.array(j_kmeans(x, k, n_iter=t, init=init)[1])
        want_assign, want_dmin, want_new = reference_step(x, cent)
        assign, _ = lloyd_assign(xt, torch.from_numpy(cent))
        scale = (x.astype(np.float64) ** 2).sum(1) + (cent.astype(np.float64) ** 2).sum(1).max()
        step_flips += decision_hold(f"step {t} assignments", assign.numpy(), want_assign,
                                    sq_dist(x, cent), scale)
        new = lloyd_update(xt, torch.from_numpy(cent), torch.from_numpy(want_assign),
                           torch.from_numpy(want_dmin))
        rel_hold(f"step {t} centroids", new.numpy(), want_new)
    got = kmeans(x, k, n_iter=25, init=init, device="cpu")
    want = j_kmeans(x, k, n_iter=25, init=init)
    same = float((got[0].numpy() == np.asarray(want[0])).mean())
    print(f"kmeans {init} k={k}: {step_flips} step assignments differ, final assignments "
          f"equal on {same:.4f} of rows")
    if same == 1.0:
        hold_kmeans(f"kmeans {init}", x, got, want)
    again = kmeans(x, k, n_iter=25, init=init, device="cpu")
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (np.bincount(got[0].numpy(), minlength=k) > 0).all()


def test_stride_rows_are_jnp_linspace():
    import jax.numpy as jnp

    for n, k in ((10, 1), (600, 20), (8192, 362), (100_000, 64), (2 ** 25 + 3, 97)):
        np.testing.assert_array_equal(stride_rows(n, k),
                                      np.asarray(jnp.linspace(0, n - 1, k).astype(jnp.int32)))


# -------------------------------------------------------------------- IVF
def test_ivf_build_and_search_match_the_reference():
    from tmlibrary_tpu.analytics import index as j_aidx

    x = blobs(np.random.default_rng(2), 1500, f=8)
    cent, mem, assign = aidx.ivf_build_arrays(x, device="cpu")
    j_cent, j_mem, j_assign = j_aidx.ivf_build_arrays(x)
    flips = hold_kmeans("ivf", x, (assign, cent), (j_assign, j_cent))
    print(f"ivf build: {cent.shape[0]} cells, {flips} assignments differ")
    if not flips:
        np.testing.assert_array_equal(mem, j_mem)
    # the search over the reference's cells: both probe shapes
    for queries in (None, x[::37]):
        q = x if queries is None else queries
        got = aidx.ivf_search_arrays(x, j_cent, j_mem, 10, queries=queries, device="cpu")
        want = j_aidx.ivf_search_arrays(x, j_cent, j_mem, 10, queries=queries)
        print(f"ivf search ({'self' if queries is None else 'queries'}):",
              knn_hold(x, q, got, want))
    assert aidx.measure_recall(x, cent, mem, device="cpu") >= 0.95


def test_ivf_search_contract_recall_and_prefix():
    x = blobs(np.random.default_rng(3), 2000, f=8)
    cent, mem, _ = aidx.ivf_build_arrays(x, device="cpu")
    idx, dist = aidx.ivf_search_arrays(x, cent, mem, 10, device="cpu")
    assert not (idx == np.arange(len(x))[:, None]).any()
    assert (np.diff(dist, axis=1) >= 0).all()
    exact, _ = ops.knn(x, 10, device="cpu")

    def recall(top_p):
        got, _ = aidx.ivf_search_arrays(x, cent, mem, 10, top_p=top_p, device="cpu")
        return sum(len(set(a) & set(b)) for a, b in zip(got.tolist(), exact.tolist())) / exact.size

    assert recall(aidx.DEFAULT_TOP_P) >= 0.95
    assert recall(16) >= recall(4) - 1e-9
    assert recall(cent.shape[0]) >= 0.999  # every cell probed: brute force up to ties
    for k in (3, 5):
        small = aidx.ivf_search_arrays(x, cent, mem, k, device="cpu")
        np.testing.assert_array_equal(small[0], idx[:, :k])
        np.testing.assert_array_equal(small[1], dist[:, :k])
    qidx, _ = aidx.ivf_search_arrays(x, cent, mem, 1, queries=x[:7], device="cpu")
    np.testing.assert_array_equal(qidx[:, 0], np.arange(7))


def test_index_persists_keyed_on_the_store_digest(tmp_path):
    r = np.random.default_rng(4)
    port, _ = twin_stores(tmp_path, {"batch_000": feature_table(r)})
    fs = FeatureStore.ensure(port, "nuclei")
    first = aidx.IvfIndex.ensure(fs, device="cpu")
    assert first.cache_state == "build" and first.meta["store_digest"] == fs.digest
    assert (first.root / "index_meta.json").exists()
    hit = aidx.IvfIndex.ensure(fs, device="cpu")
    assert hit.cache_state == "hit" and hit.digest == first.digest
    port.append_features("nuclei", feature_table(r, labels=range(21, 31)), shard="batch_001")
    fs2 = FeatureStore.ensure(port, "nuclei")
    rebuilt = aidx.IvfIndex.ensure(fs2, device="cpu")
    assert rebuilt.cache_state == "build" and rebuilt.meta["n_objects"] == 120
    assert rebuilt.meta["store_digest"] == fs2.digest != fs.digest


def test_index_meta_and_assignments_match_the_reference(tmp_path):
    from tmlibrary_tpu.analytics import index as j_aidx
    from tmlibrary_tpu.analytics.store import FeatureStore as JFeatureStore

    port, ref = twin_stores(tmp_path, {"batch_000": feature_table(np.random.default_rng(5))})
    fs, ref_fs = FeatureStore.ensure(port, "nuclei"), JFeatureStore.ensure(ref, "nuclei")
    got = aidx.IvfIndex.ensure(fs, n_cells=6, device="cpu")
    want = j_aidx.IvfIndex.ensure(ref_fs, n_cells=6)
    assert got.root.relative_to(port.root) == want.root.relative_to(ref.root)
    same = ("schema_version", "kind", "objects_name", "store_digest", "features", "selection",
            "n_objects", "n_cells", "seed", "n_iter", "recall_k", "recall_sample",
            "default_top_p")
    assert {k: got.meta[k] for k in same} == {k: want.meta[k] for k in same}
    _, x, _ = fs.standardized()
    flips = hold_kmeans("index", x, (got.assignments(), got.centroids),
                        (want.assignments(), want.centroids))
    print(f"index at 6 cells: {flips} assignments differ")


def test_knn_search_dispatch_and_fallback(tmp_path, monkeypatch):
    port, _ = twin_stores(tmp_path, {"batch_000": feature_table(np.random.default_rng(6))})
    fs = FeatureStore.ensure(port, "nuclei")
    _, x, _ = fs.standardized()
    idx_b, _, info_b = aidx.knn_search(fs, x, 4, mode="brute", device="cpu")
    assert info_b == {"index": "brute", "index_source": "payload"}
    idx_i, _, info_i = aidx.knn_search(fs, x, 4, mode="ivf", device="cpu")
    assert info_i["index"] == "ivf" and info_i["index_cache"] == "build"
    assert info_i["recall_at_k"] is not None and idx_i.shape == idx_b.shape

    def boom(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(aidx.IvfIndex, "ensure", classmethod(boom))
    idx_f, _, info_f = aidx.knn_search(fs, x, 4, mode="ivf", device="cpu")
    assert info_f["index"] == "brute" and "boom" in info_f["index_fallback"]
    np.testing.assert_array_equal(idx_f, idx_b)


def test_resolve_index_mode_precedence(monkeypatch):
    for var in ("TMX_ANALYTICS_INDEX", "TM_ANALYTICS_INDEX", "TMX_ANALYTICS_INDEX_MIN"):
        monkeypatch.delenv(var, raising=False)
    assert aidx.resolve_index_mode(None, n_objects=10) == ("brute", "auto")
    assert aidx.resolve_index_mode(None, n_objects=aidx.DEFAULT_AUTO_MIN_OBJECTS) == \
        ("ivf", "auto")
    monkeypatch.setenv("TMX_ANALYTICS_INDEX_MIN", "5")
    assert aidx.resolve_index_mode(None, n_objects=10) == ("ivf", "auto")
    monkeypatch.delenv("TMX_ANALYTICS_INDEX_MIN")
    monkeypatch.setenv("TM_ANALYTICS_INDEX", "brute")
    assert aidx.resolve_index_mode(None) == ("brute", "config")
    monkeypatch.setenv("TMX_ANALYTICS_INDEX", "ivf")
    assert aidx.resolve_index_mode(None) == ("ivf", "env")
    monkeypatch.setenv("TMX_ANALYTICS_INDEX", "flat")
    with pytest.raises(NotSupportedError, match="flat"):
        aidx.resolve_index_mode(None)
    monkeypatch.setenv("TMX_ANALYTICS_INDEX", "ivf")
    assert aidx.resolve_index_mode("brute") == ("brute", "payload")
    with pytest.raises(NotSupportedError, match="hnsw"):
        aidx.resolve_index_mode("hnsw")
    assert aidx.resolve_index_mode("auto") == ("ivf", "env")


# ----------------------------------------------------------------- fusion
def test_fusion_signature_family():
    base = {"tool": "knn", "objects_name": "nuclei", "k": 3}
    assert fusion_signature(base) == fusion_signature({**base, "k": 9})
    assert fusion_signature(base) != fusion_signature({**base, "features": ["Morphology_area"]})
    assert fusion_signature({"tool": "pca", "objects_name": "n"}) is None


def test_run_query_batch_equals_the_sequential_path(tmp_path):
    from tmlibrary_tpu.analytics.query import run_query_batch as j_batch

    port, ref = twin_stores(tmp_path, {"batch_000": feature_table(np.random.default_rng(7),
                                                                  labels=range(1, 41))})
    payloads = [{"tool": "knn", "objects_name": "nuclei", "k": k, "index": "brute"}
                for k in (3, 4, 5)]
    summaries = run_query_batch(port, payloads, device="cpu")
    assert [s["cache"] for s in summaries] == ["miss", "fused", "fused"]
    assert [s["key"] for s in summaries] == [s["key"] for s in j_batch(ref, payloads)]
    assert all(s["fusion_window"] == 3 for s in summaries)
    assert summaries[1]["fused_with"] == summaries[2]["fused_with"] == summaries[0]["key"]
    for s, payload in zip(summaries, payloads):
        fused = ToolResult.load(port.tools_dir / "queries" / s["key"])
        seq = run_query(port, payload, use_cache=False, device="cpu")
        assert seq["key"] == s["key"] and seq["attributes"] == fused.attributes
        again = ToolResult.load(port.tools_dir / "queries" / seq["key"])
        for c in fused.values:
            np.testing.assert_array_equal(fused.values[c], again.values[c], err_msg=c)
    assert [s["cache"] for s in run_query_batch(port, payloads, device="cpu")] == ["hit"] * 3
    with pytest.raises(NotSupportedError, match="fusion signature"):
        run_query_batch(port, [payloads[0], {**payloads[1], "features": ["Morphology_area"]}],
                        device="cpu")
    assert query_key("d", payloads[0]) != query_key("d", payloads[1])


def test_index_cli_build_and_list(tmp_path, capsys):
    from tmlibrary_tpu_torch.cli import main

    r = np.random.default_rng(8)
    port, ref = twin_stores(tmp_path, {"batch_000": feature_table(r)})
    root = str(port.root)
    assert main(["index", "build", "--root", root, "--objects", "nuclei", "--device", "cpu"]) == 0
    built = json.loads(capsys.readouterr().out)
    assert built["cache"] == "build" and built["selection"] == "all"
    assert main(["index", "build", "--root", root, "--objects", "nuclei", "--cells", "4",
                 "--features", "Morphology_area,Intensity_mean_DAPI", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["n_cells"] == 4
    assert main(["index", "list", "--root", root, "--objects", "nuclei", "--device", "cpu"]) == 0
    listed = json.loads(capsys.readouterr().out)
    assert sorted(i["state"] for i in listed["indexes"]) == ["fresh", "fresh"]
    port.append_features("nuclei", feature_table(r, labels=range(21, 25)), shard="batch_001")
    sync_shards(port, ref)
    assert main(["index", "list", "--root", root, "--objects", "nuclei", "--device", "cpu"]) == 0
    assert {i["state"] for i in json.loads(capsys.readouterr().out)["indexes"]} == {"stale"}
