"""The port's analytics plane against the JAX package's, on the CPU.

JAX's threefry draws (bits, split, randint exact; normal within the
ulps counted here), the feature store (digests, source digests, matrix
bytes and identity columns equal to the reference's on the same shard
files, including shards with other columns), the ops (kNN by
``chip_smoke.knn_hold``'s boundary rule, PCA by ``ANALYTICS_RTOL``, the
embedding as a subspace by ``EMBEDDING_MIN_COS``), the spatial index
(exact), the query cache (keys equal, a hit equal to its miss), saved
results read across the packages, and the ``query`` verb.
"""

import json
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from chip_smoke import EMBEDDING_MIN_COS, knn_hold, rel_hold, subspace_cos
from tmlibrary_tpu_torch.analytics import ops, rng, spatial
from tmlibrary_tpu_torch.analytics.query import query_key, run_query
from tmlibrary_tpu_torch.analytics.store import (
    FeatureStore, _append_npy_rows, analytics_dir, concat_tables,
)
from tmlibrary_tpu_torch.errors import NotSupportedError, RegistryError
from tmlibrary_tpu_torch.models.experiment import grid_experiment
from tmlibrary_tpu_torch.models.store import ExperimentStore
from tmlibrary_tpu_torch.tools.base import Plot, ToolResult

torch.set_num_threads(2)


def feature_table(r, sites=range(4), labels=range(1, 21)) -> dict:
    """Two populations (bright objects in the right half of the site), as
    the reference's analytics tests build them; a dict of columns."""
    rows = [(s, lab) for s in sites for lab in labels]
    n = len(rows)
    site = np.array([s for s, _ in rows], np.int64)
    label = np.array([lab for _, lab in rows], np.int64)
    pop_b = label > 10
    return {
        "site_index": site,
        "plate": np.array(["plate00"] * n, object),
        "well_row": np.zeros(n, np.int64),
        "well_col": np.zeros(n, np.int64),
        "site_y": site // 2,
        "site_x": site % 2,
        "label": label,
        "Morphology_area": np.where(pop_b, r.normal(400, 10, n), r.normal(80, 10, n)),
        "Intensity_mean_DAPI": np.where(pop_b, r.normal(3000, 50, n), r.normal(500, 50, n)),
        "Morphology_centroid_y": r.uniform(2, 14, n),
        "Morphology_centroid_x": np.where(pop_b, r.uniform(9, 15, n), r.uniform(1, 7, n)),
    }


def twin_stores(tmp_path, shards: dict) -> tuple:
    """The port's store with ``shards`` (name -> table) written by the port,
    and a reference store holding copies of the same shard files."""
    from tmlibrary_tpu.models.experiment import grid_experiment as j_grid
    from tmlibrary_tpu.models.store import ExperimentStore as JStore

    shape = dict(well_rows=1, well_cols=2, sites_per_well=(2, 2), site_shape=(16, 16))
    port = ExperimentStore.create(tmp_path / "port", grid_experiment(name="a", **shape))
    ref = JStore.create(tmp_path / "ref", j_grid(name="a", **shape))
    for name, table in shards.items():
        port.append_features("nuclei", table, shard=name)
    sync_shards(port, ref)
    return port, ref


def sync_shards(port, ref) -> None:
    src, dst = port.features_dir("nuclei"), ref.features_dir("nuclei")
    for f in src.glob("*.parquet"):
        shutil.copy2(f, dst / f.name)


@pytest.fixture
def stores(tmp_path):
    return twin_stores(tmp_path, {"batch_000": feature_table(np.random.default_rng(3))})


def assert_same_store(fs, ref_fs):
    from tmlibrary_tpu.analytics.store import FeatureStore as JFeatureStore

    assert isinstance(ref_fs, JFeatureStore)
    assert fs.digest == ref_fs.digest
    assert fs.meta["source_digest"] == ref_fs.meta["source_digest"]
    assert fs.features == ref_fs.features
    assert fs.meta["columns"] == ref_fs.meta["columns"]
    assert (fs.root / "matrix.npy").read_bytes() == (ref_fs.root / "matrix.npy").read_bytes()
    np.testing.assert_array_equal(fs.matrix(), ref_fs.matrix())
    want = ref_fs.index()
    got = fs.index()
    assert list(got) == list(want.columns)
    for c in got:
        assert got[c].tolist() == want[c].tolist() or np.array_equal(
            got[c], want[c].to_numpy(), equal_nan=True), c
    # and the reference reads the port's identity file as its own
    pd.testing.assert_frame_equal(pd.read_parquet(fs.root / "index.parquet"), want,
                                  check_dtype=False)


# ------------------------------------------------------------------ rng
@pytest.mark.parametrize("seed", [0, 7, 1, 12345, 2 ** 31 - 1, -3])
def test_threefry_bits_split_and_randint_are_jax_bits(seed):
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(seed)
    assert tuple(int(v) for v in np.asarray(key)) == rng.prng_key(seed)
    assert [tuple(map(int, k)) for k in np.asarray(jax.random.split(key, 5))] == \
        rng.split(rng.prng_key(seed), 5)
    for shape in [(), (7,), (33, 10)]:
        np.testing.assert_array_equal(
            rng.random_bits(rng.prng_key(seed), shape).numpy(),
            np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64))
    for lo, hi in [(0, 10), (0, 100000), (-7, 7), (0, 2 ** 31 - 1), (3, 3)]:
        np.testing.assert_array_equal(rng.randint(rng.prng_key(seed), (40,), lo, hi).numpy(),
                                      np.asarray(jax.random.randint(key, (40,), lo, hi)))
        assert int(rng.randint(rng.prng_key(seed), (), lo, hi)) == \
            int(jax.random.randint(key, (), lo, hi))


def test_normal_draws_within_three_ulps_of_jax():
    """The uniform is bit-exact; ``erf_inv`` is XLA's expansion with its
    ``log1p`` for small arguments, the correctly rounded ``log`` above
    (XLA's own ``log`` approximation is not reproduced).  Measured: a few
    draws in a thousand differ, by at most 2 ulps in ``erf_inv`` and 3
    after the product with sqrt(2)."""
    import jax
    import jax.numpy as jnp

    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    n_diff = worst = worst_erf = total = 0
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        u = rng.uniform(rng.prng_key(seed), (50_000,), lo, 1.0)
        np.testing.assert_array_equal(
            u.numpy(), np.asarray(jax.random.uniform(key, (50_000,), jnp.float32, lo, 1.0)))
        erf = np.asarray(jax.lax.erf_inv(jnp.asarray(u.numpy())))
        worst_erf = max(worst_erf, int(np.abs(erf.view(np.int32).astype(np.int64) - rng._erfinv(
            u).numpy().view(np.int32).astype(np.int64)).max()))
        got = rng.normal(rng.prng_key(seed), (50_000,)).numpy()
        want = np.asarray(jax.random.normal(key, (50_000,), jnp.float32))
        ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
        n_diff += int((ulps > 0).sum())
        worst = max(worst, int(ulps.max()))
        total += ulps.size
    print(f"normal: {n_diff} of {total} draws differ, at most {worst} ulps "
          f"(erf_inv at most {worst_erf})")
    assert worst_erf <= 2 and worst <= 3
    assert n_diff <= total // 100


# ---------------------------------------------------------- feature store
def test_store_digests_and_views_match_the_reference(stores):
    from tmlibrary_tpu.analytics.store import FeatureStore as JFeatureStore

    port, ref = stores
    fs, ref_fs = FeatureStore.ensure(port, "nuclei"), JFeatureStore.ensure(ref, "nuclei")
    assert fs.n_objects == 80 and fs.meta["build_kind"] == "full"
    assert_same_store(fs, ref_fs)
    assert list(fs.identity()) == ["site_index", "label", "plate", "well_row", "well_col"]
    np.testing.assert_array_equal(fs.centroids(), ref_fs.centroids())
    np.testing.assert_array_equal(fs.column("Morphology_area"), ref_fs.column("Morphology_area"))
    for feats in (None, ["Intensity_mean_DAPI", "Morphology_area"]):
        ids, x, cols = fs.standardized(feats)
        ref_ids, ref_x, ref_cols = ref_fs.standardized(feats)
        assert cols == ref_cols
        np.testing.assert_array_equal(x, ref_x)
    # a second ensure reuses the build
    again = FeatureStore.ensure(port, "nuclei")
    assert again.meta["built_at"] == fs.meta["built_at"]
    with pytest.raises(RegistryError):
        fs.column("Intensity_nope")
    with pytest.raises(RegistryError, match="features not found"):
        fs.select(["Morphology_area", "Intensity_nope"])


def test_heterogeneous_shards_union_as_pandas_concat(tmp_path):
    """Shards with other columns: the union in order of appearance, NaN
    where a shard lacks a column (integers turn float64, strings stay
    objects) -- the digests still equal the reference's."""
    r = np.random.default_rng(5)
    a = feature_table(r, sites=[0, 1])
    b = feature_table(r, sites=[2, 3])
    b["Texture_x"] = r.normal(size=len(b["label"]))
    b["Count_int"] = np.arange(len(b["label"]), dtype=np.int64)
    b["Morphology_area"][3] = np.nan
    del a["site_y"], b["Morphology_centroid_x"]
    port, ref = twin_stores(tmp_path, {"batch_000": a, "batch_001": b})
    from tmlibrary_tpu.analytics.store import FeatureStore as JFeatureStore

    fs, ref_fs = FeatureStore.ensure(port, "nuclei"), JFeatureStore.ensure(ref, "nuclei")
    assert "Count_int" in fs.features and "Texture_x" in fs.features
    assert_same_store(fs, ref_fs)
    table = concat_tables([{"i": np.arange(2), "s": np.array(["x", "y"])}, {"f": np.ones(1)}])
    assert table["i"].dtype == np.float64 and np.isnan(table["i"][2])
    assert table["s"].dtype == object and table["s"][:2].tolist() == ["x", "y"]


def test_append_equals_rebuild_and_the_reference(tmp_path):
    from tmlibrary_tpu.analytics.store import FeatureStore as JFeatureStore

    r = np.random.default_rng(9)
    t0, t1 = feature_table(r), feature_table(r, labels=range(21, 31))
    port, ref = twin_stores(tmp_path, {"batch_000": t0})
    assert FeatureStore.ensure(port, "nuclei").meta["build_kind"] == "full"
    port.append_features("nuclei", t1, shard="batch_001")
    sync_shards(port, ref)
    fs = FeatureStore.ensure(port, "nuclei")
    assert fs.meta["build_kind"] == "append"
    assert fs.meta["appended_shards"] == ["batch_001.parquet"] and fs.meta["appended_rows"] == 40
    assert_same_store(fs, JFeatureStore.ensure(ref, "nuclei"))
    full = FeatureStore.build(port, "nuclei")
    assert full.digest == fs.digest and full.meta["source_digest"] == fs.meta["source_digest"]
    # a rewritten shard rebuilds
    port.append_features("nuclei", feature_table(r, sites=[0]), shard="batch_000")
    assert FeatureStore.ensure(port, "nuclei").meta["build_kind"] == "full"


def test_append_npy_rows_in_place(tmp_path):
    path = tmp_path / "m.npy"
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.save(path, a)
    b = np.arange(100, 120, dtype=np.float32).reshape(5, 4)
    _append_npy_rows(path, b)
    np.testing.assert_array_equal(np.load(path), np.vstack([a, b]))
    for _ in range(3):
        _append_npy_rows(path, b)
    out = np.load(path)
    assert out.shape == (23, 4)
    np.testing.assert_array_equal(out[-5:], b)


# ------------------------------------------------------------------ ops
@pytest.mark.parametrize("n,f,k", [(600, 8, 5), (2000, 16, 10)])
def test_knn_matches_the_reference(n, f, k):
    from tmlibrary_tpu.analytics import ops as j_ops

    x = np.random.default_rng(n).normal(size=(n, f)).astype(np.float32)
    got, want = ops.knn(x, k, device="cpu"), j_ops.knn(x, k)
    held = knn_hold(x, x, got, want)
    print(f"knn N={n} F={f}: {held}")
    assert not (got[0] == np.arange(n)[:, None]).any()
    assert (np.diff(got[1], axis=1) >= 0).all()
    q = x[:25]
    held_q = knn_hold(x, q, ops.knn(x, 3, queries=q, device="cpu"), j_ops.knn(x, 3, queries=q))
    print(f"knn queries: {held_q}")
    np.testing.assert_array_equal(ops.knn(x, 1, queries=q, device="cpu")[0][:, 0],
                                  np.arange(25))
    assert ops.knn(x[:4], 10, device="cpu")[0].shape == (4, 3)


def test_knn_against_float64_brute_force_and_prefix():
    x = np.random.default_rng(4).normal(size=(800, 12)).astype(np.float32)
    x64 = x.astype(np.float64)
    d2 = ((x64[:100, None] - x64[None]) ** 2).sum(-1)
    d2[np.arange(100), np.arange(100)] = np.inf
    idx = np.argsort(d2, axis=1, kind="stable")[:, :7]
    got = ops.knn(x, 7, device="cpu")
    print("knn vs float64:", knn_hold(x, x[:100], (got[0][:100], got[1][:100]),
                                      (idx, np.sqrt(np.take_along_axis(d2, idx, 1)))))
    for k in (3, 5):  # the k-prefix of a larger sweep is the smaller answer
        small = ops.knn(x, k, device="cpu")
        np.testing.assert_array_equal(small[0], got[0][:, :k])
        np.testing.assert_array_equal(small[1], got[1][:, :k])
    # equal distances go to the lowest row, as lax.top_k's do
    dup = np.repeat(x[:5], 3, axis=0)
    np.testing.assert_array_equal(ops.knn(dup, 2, device="cpu")[0][:3], [[1, 2], [0, 2], [0, 1]])


def test_pca_matches_the_reference():
    from tmlibrary_tpu.analytics import ops as j_ops

    r = np.random.default_rng(11)
    basis = np.linalg.qr(r.normal(size=(8, 2)))[0].T
    coef = r.normal(size=(300, 2)) * np.array([5.0, 2.0])
    x = (coef @ basis + r.normal(size=(300, 8)) * 0.05).astype(np.float32)
    for xs in (x, r.normal(size=(500, 16)).astype(np.float32)):
        got, want = ops.pca(xs, 3, device="cpu"), j_ops.pca(xs, 3)
        errs = [rel_hold(name, g, w) for name, g, w in zip(("scores", "components", "ratio"),
                                                            got, want)]
        print(f"pca relative errors (scores, components, ratio): {errs}")
    scores, comps, ratio = ops.pca(x, 2, device="cpu")
    assert ratio.sum() > 0.99
    np.testing.assert_allclose(comps @ comps.T, np.eye(2), atol=1e-4)
    np.testing.assert_array_equal(scores, ops.pca(x, 2, device="cpu")[0])


def test_embedding_matches_the_reference_as_a_subspace():
    from tmlibrary_tpu.analytics import ops as j_ops

    r = np.random.default_rng(12)
    a = r.normal(size=(30, 4)).astype(np.float32)
    b = (r.normal(size=(30, 4)) + 40.0).astype(np.float32)
    x = np.concatenate([a, b])
    emb = ops.spectral_embedding(x, 2, k=5, device="cpu")
    np.testing.assert_array_equal(emb, ops.spectral_embedding(x, 2, k=5, device="cpu"))
    gap = abs(emb[:30, 0].mean() - emb[30:, 0].mean())
    assert gap > 5 * max(emb[:30, 0].std(), emb[30:, 0].std())
    for xs, k in ((x, 5), (r.normal(size=(700, 8)).astype(np.float32), 15)):
        cos = subspace_cos(ops.spectral_embedding(xs, 2, k=k, device="cpu"),
                           j_ops.spectral_embedding(xs, 2, k=k))
        print(f"embedding N={len(xs)}: smallest principal cosine {cos:.7f}")
        assert cos >= EMBEDDING_MIN_COS


def test_in_edge_table_is_a_stable_transpose():
    cols = torch.tensor([2, 0, 2, 1, 2, 0])
    table = ops.in_edge_table(cols, 4)
    assert table.tolist() == [[1, 5, -1], [3, -1, -1], [0, 2, 4], [-1, -1, -1]]


# --------------------------------------------------------------- spatial
def test_spatial_index_matches_the_reference_exactly():
    from tmlibrary_tpu.analytics import spatial as j_spatial

    r = np.random.default_rng(13)
    n = 500
    site_index = r.integers(-1, 3, size=n)
    cents = r.uniform(0, 100, size=(n, 2))
    mark = (r.random(n) > 0.6).astype(np.float32)
    got = spatial.build_index(site_index, cents, mark=mark, grid=16, device="cpu")
    want = j_spatial.build_index(site_index, cents, mark=mark, grid=16)
    np.testing.assert_array_equal(got.tables.numpy(), want.tables)
    np.testing.assert_array_equal(got.mark_tables.numpy(), want.mark_tables)
    np.testing.assert_array_equal(got.bins, want.bins)
    np.testing.assert_array_equal(got.site_row, want.site_row)
    wins = np.array([[s, y0, x0, y0 + h, x0 + w] for s in range(4)
                     for (y0, x0, h, w) in [(0, 0, 16, 16), (2, 3, 5, 7), (10, 0, 6, 16)]])
    np.testing.assert_array_equal(got.window_counts(wins), want.window_counts(wins))
    for radius in (0, 2, 5):
        np.testing.assert_array_equal(spatial.density(got, radius),
                                      j_spatial.density(want, radius))
        np.testing.assert_array_equal(spatial.enrichment(got, radius),
                                      j_spatial.enrichment(want, radius))
    plain = spatial.build_index(site_index, cents, grid=16, device="cpu")
    with pytest.raises(ValueError, match="marked"):
        spatial.enrichment(plain)
    with pytest.raises(ValueError, match="non-empty"):
        spatial.build_index(np.array([], np.int64), np.zeros((0, 2)), device="cpu")


# ----------------------------------------------------------------- query
def frames_equal(got: dict, want: pd.DataFrame) -> None:
    assert list(got) == list(want.columns)
    for c in got:
        np.testing.assert_array_equal(np.asarray(got[c]).tolist(), want[c].tolist(), err_msg=c)


def test_query_keys_match_and_a_hit_equals_its_miss(stores):
    from tmlibrary_tpu.analytics.query import run_query as j_run_query
    from tmlibrary_tpu.tools.base import ToolResult as JToolResult

    port, ref = stores
    for payload in ({"tool": "knn", "objects_name": "nuclei", "k": 3},
                    {"tool": "spatial", "objects_name": "nuclei", "grid": 8,
                     "windows": [[0, 0, 0, 8, 8]]},
                    {"tool": "heatmap", "objects_name": "nuclei",
                     "feature": "Intensity_mean_DAPI"}):
        miss = run_query(port, payload, device="cpu")
        want = j_run_query(ref, payload)
        assert miss["cache"] == "miss" and miss["key"] == want["key"]
        assert miss["key"] == query_key(miss["store_digest"], payload)
        hit = run_query(port, payload, device="cpu")
        assert hit["cache"] == "hit" and hit["key"] == miss["key"]
        assert hit["attributes"] == json.loads(json.dumps(miss["attributes"], default=str))
        prov = json.loads((port.tools_dir / "queries" / miss["key"] / "query.json").read_text())
        assert prov["store_digest"] == miss["store_digest"] and prov["tool"] == payload["tool"]
        if payload["tool"] != "knn":  # exact tools: equal to the reference's result
            frames_equal(ToolResult.load(hit["result_dir"]).values,
                         JToolResult.load(want["result_dir"]).values)
    with pytest.raises(NotSupportedError, match="tool"):
        run_query(port, {"objects_name": "nuclei"}, device="cpu")
    with pytest.raises(NotSupportedError, match="objects_name"):
        run_query(port, {"tool": "knn"}, device="cpu")
    with pytest.raises(RegistryError):
        run_query(port, {"tool": "nope", "objects_name": "nuclei"}, device="cpu")


def test_query_key_moves_with_the_store(stores):
    port, _ = stores
    payload = {"tool": "clustering", "objects_name": "nuclei", "k": 2}
    s1 = run_query(port, payload, device="cpu")
    port.append_features("nuclei", feature_table(np.random.default_rng(1), sites=[4],
                                                 labels=range(1, 4)), shard="batch_001")
    s2 = run_query(port, payload, device="cpu")
    assert s2["store_digest"] != s1["store_digest"] and s2["key"] != s1["key"]
    assert s2["cache"] == "miss" and s2["n_objects"] == 83


def test_saved_results_load_across_the_packages(tmp_path):
    from tmlibrary_tpu.tools.base import Plot as JPlot
    from tmlibrary_tpu.tools.base import ToolResult as JToolResult

    values = {"site_index": np.array([0, 0, 1]), "label": np.array([1, 2, 1]),
              "plate": np.array(["p", "p", "p"], object), "well_row": np.zeros(3, np.int64),
              "well_col": np.zeros(3, np.int64), "value": np.array([0.5, 1.5, -2.0]),
              "nn0": np.array([2, 0, 0], np.int32)}
    attrs = {"k": 1, "store_digest": "abc", "nested": {"a": [1, 2]}}
    ToolResult(tool="knn", objects_name="nuclei", layer_type="continuous", values=values,
               attributes=attrs, plots=[Plot("plate_heatmap", {"wells": []})]
               ).save(tmp_path / "port")
    back = JToolResult.load(tmp_path / "port")
    assert back.attributes == attrs and back.tool == "knn"
    assert [(p.type, p.figure) for p in back.plots] == [("plate_heatmap", {"wells": []})]
    frames_equal(values, back.values)
    JToolResult(tool="knn", objects_name="nuclei", layer_type="continuous",
                values=pd.DataFrame(values), attributes=attrs,
                plots=[JPlot("plate_heatmap", {"wells": []})]).save(tmp_path / "ref")
    mine = ToolResult.load(tmp_path / "ref")
    assert mine.attributes == attrs and mine.layer_type == "continuous"
    frames_equal(mine.values, pd.DataFrame(values))
    assert mine.values["nn0"].dtype == np.int32


def test_query_cli(stores, capsys, tmp_path):
    from tmlibrary_tpu_torch.cli import main

    port, _ = stores
    argv = ["query", "--root", str(port.root), "--tool", "clustering", "--objects", "nuclei",
            "--payload", '{"k": 2}', "--device", "cpu"]
    assert main(argv) == 0
    s1 = json.loads(capsys.readouterr().out)
    assert s1["cache"] == "miss" and s1["tool"] == "clustering"
    assert main(argv) == 0
    s2 = json.loads(capsys.readouterr().out)
    assert s2["cache"] == "hit" and s2["key"] == s1["key"]
    assert main(argv + ["--no-cache"]) == 0
    assert json.loads(capsys.readouterr().out)["cache"] == "miss"
    with pytest.raises(SystemExit, match="objects_name"):
        main(["query", "--root", str(port.root), "--tool", "knn", "--device", "cpu"])
    pfile = tmp_path / "p.json"
    pfile.write_text('{"k": 2}')
    with pytest.raises(SystemExit, match="mutually"):
        main(["query", "--root", str(port.root), "--tool", "knn", "--objects", "nuclei",
              "--payload", "{}", "--payload-file", str(pfile), "--device", "cpu"])
    assert (analytics_dir(port, "nuclei") / "matrix.npy").exists()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from tmlibrary_tpu_torch.errors import DeviceError

    with pytest.raises(DeviceError):
        ops.knn(np.zeros((4, 2), np.float32), 1)


def test_measure_analytics_record_on_the_cpu():
    """The bench's record (its populations drawn as the reference draws
    them) at a toy size on the CPU: every tool timed, every repeat
    bit-identical, the index rows filled."""
    from tmlibrary_tpu_torch import benchmarks

    x, site_index, centroids = benchmarks.analytics_population(300, 8)
    r = np.random.default_rng(0)
    np.testing.assert_array_equal(x, r.normal(size=(300, 8)).astype(np.float32))
    record = benchmarks.measure_analytics(sizes=(300,), n_features=8, reps=1, device="cpu")
    assert record["metric"] == "analytics_queries_per_sec" and record["device"] == "cpu"
    assert set(record["per_tool"]) == {"knn", "pca", "embedding", "spatial", "clustering"}
    assert all(v["300"] for v in record["repeat_identical"].values())
    (row,) = record["index_vs_brute"]
    assert row["n"] == 300 and row["recall_at_k"] >= 0.95 and row["n_cells"] == 69
