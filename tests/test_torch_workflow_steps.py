"""The port's corilla -> align -> jterator steps (sites layout) against
the JAX package's, end to end over an experiment store.

One store (a 2x2-well plate at 2x2 sites of 64x64, DAPI and Actin, two
cycles; cycle 1 is cycle 0 rolled by a seeded drift within +-6) is
copied twice; the reference's steps (JAX on the CPU) run over one copy,
the port's (``device="cpu"``) over the other, with config 3's pipeline
corrected and aligned from a ``.pipe.json``: illumination statistics by
``STATS_TIERS`` (``n`` and percentiles exact), shifts and windows exact,
label stacks identical, feature rows in (site_index, label) order by
``CORRECTED_FEATURE_TIERS`` (the corrected pixels differ within
``CORRECTION_TIER``; the same pipeline aligned but not corrected holds by
``FEATURE_TIERS``), ``collect`` and the mapobject types equal.  Then the
port's jterator over the reference's statistics and shifts, bucket
settings and pipeline depths, auto-resegmentation from a cap of 4, the
window pad-back against the reference's, the arguments that used to be
refused (the spatial layout, ``n_devices``, polygons, figures).  Last, the
step with QC on (each batch's QC summary against the reference's step
with QC on: counts, flags and guards exact, the image statistics by
``QC_TIERS``) and the DL segmenters' pipeline through the step,
bit-identical across bucket specs and executor depths.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from chip_smoke import (
    CORRECTED_FEATURE_TIERS,
    FEATURE_TIERS,
    QC_TIERS,
    STATS_TIERS,
    feature_tier,
)
from tmlibrary_tpu import qc as j_qc
from tmlibrary_tpu.models.store import ExperimentStore as JStore
from tmlibrary_tpu.workflow.registry import get_step as j_get_step
from tmlibrary_tpu.workflow.steps.jterator import ImageAnalysisRunner as JRunner
from tmlibrary_tpu_torch import benchmarks, capacity, qc
from tmlibrary_tpu_torch.jterator.description import PipelineDescription
from tmlibrary_tpu_torch.jterator.pipeline import ImageAnalysisPipeline
from tmlibrary_tpu_torch.models.experiment import grid_experiment
from tmlibrary_tpu_torch.models.store import ExperimentStore
from tmlibrary_tpu_torch.workflow import get_step
from tmlibrary_tpu_torch.workflow.steps.jterator import feature_table, to_site_frame

torch.set_num_threads(1)

SIZE, N_SITES, DRIFT = 64, 16, 6
CORILLA = {"chunk_size": 6, "n_devices": 1}
ALIGN = {"batch_size": 4}
#: two rungs under a few objects a site, so a cold router escalates
JTERATOR = {"pipe": "cp.pipe.json", "cycle": 1, "batch_size": 4, "max_objects": 64,
            "n_devices": 1, "object_buckets": "2,4"}


@pytest.fixture(autouse=True)
def _cold_port_router():
    capacity.reset_routing_history()
    yield
    capacity.reset_routing_history()


def corrected_aligned_pipe(morphology: bool = False, correct: bool = True) -> dict:
    pipe = dict(benchmarks.CELL_PAINTING_PIPE)
    correct = correct and not morphology
    pipe["input"] = {"channels": [{"name": "DAPI", "correct": correct, "align": True},
                                  {"name": "Actin", "correct": correct, "align": True}]}
    if morphology:
        pipe["pipeline"] = pipe["pipeline"] + [{"handles": {
            "module": "measure_morphology",
            "input": [{"name": "objects_image", "type": "LabelImage", "key": "nuclei"}],
            "output": [{"name": "measurements", "type": "Measurement",
                        "objects": "nuclei"}]}}]
    return pipe


def make_store(root) -> ExperimentStore:
    exp = grid_experiment("wf", well_rows=2, well_cols=2, sites_per_well=(2, 2),
                          channel_names=("DAPI", "Actin"), site_shape=(SIZE, SIZE),
                          n_cycles=2)
    st = ExperimentStore.create(root, exp)
    data = benchmarks.synthetic_cell_painting_batch(N_SITES, size=SIZE, n_cells=10, seed=0)
    drift = np.random.default_rng(1).integers(-DRIFT, DRIFT + 1, (N_SITES, 2))
    for c, name in enumerate(("DAPI", "Actin")):
        px = data[name].astype(np.uint16)
        st.write_sites(px, list(range(N_SITES)), cycle=0, channel=c)
        rolled = np.stack([np.roll(s, tuple(d), axis=(0, 1)) for s, d in zip(px, drift)])
        st.write_sites(rolled, list(range(N_SITES)), cycle=1, channel=c)
    (st.root / "cp.pipe.json").write_text(json.dumps(corrected_aligned_pipe()))
    (st.root / "morph.pipe.json").write_text(json.dumps(corrected_aligned_pipe(True)))
    (st.root / "raw.pipe.json").write_text(json.dumps(corrected_aligned_pipe(correct=False)))
    (st.root / "dl.pipe.json").write_text(json.dumps(benchmarks.dl_secondary_pipe(align=True)))
    return st


def copy_store(src, dst, parts=("images",)):
    dst.mkdir(parents=True)
    shutil.copy(src / "manifest.json", dst / "manifest.json")
    for f in src.glob("*.pipe.json"):
        shutil.copy(f, dst / f.name)
    for sub in ("images", "illumstats", "segmentations", "features", "alignment",
                "pyramids", "workflow", "tools"):
        if sub in parts:
            shutil.copytree(src / sub, dst / sub)
        else:
            (dst / sub).mkdir()


def run_steps(get, store, jterator_args, device=None, depth=None, sequential=False):
    """corilla -> align -> jterator through each step's own verbs; returns
    the jterator batch summaries and collect summary."""
    kw = {} if device is None else {"device": device}
    for name, args in (("corilla", CORILLA), ("align", ALIGN)):
        step = get(name)(store, **kw)
        step.init(args)
        for i in step.list_batches():
            step.run(i)
        if name == "align":
            step.collect()
    return run_jterator(get, store, jterator_args, kw, depth, sequential)


def run_jterator(get, store, args, kw, depth=None, sequential=False):
    jt = get("jterator")(store, **kw)
    jt.init(args)
    if sequential:
        results = [jt.run(i) for i in jt.list_batches()]
    else:
        batches = [jt.load_batch(i) for i in jt.list_batches()]
        results = [r for _, r in jt.run_batches_pipelined(batches, depth=depth)]
    return results, jt.collect()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("wf")
    make_store(base / "src")
    copy_store(base / "src", base / "ref")
    copy_store(base / "src", base / "port")
    j_capacity_reset()
    ref_store = JStore.open(base / "ref")
    # batch by batch: routing then follows the persisted peaks in batch
    # order on both sides, so the summaries compare too
    ref = run_steps(j_get_step, ref_store, JTERATOR, sequential=True)
    j_capacity_reset()
    port_store = ExperimentStore.open(base / "port")
    port = run_steps(get_step, port_store, JTERATOR, device="cpu", sequential=True)
    # the same pipeline aligned but not corrected, on copies of both
    raw = {**JTERATOR, "pipe": "raw.pipe.json"}
    stores = {}
    for name, src, get, kw, store_cls in (
            ("ref_raw", base / "ref", j_get_step, {}, JStore),
            ("port_raw", base / "port", get_step, {"device": "cpu"}, ExperimentStore)):
        copy_store(src, base / name, parts=("images", "illumstats", "alignment"))
        stores[name] = store_cls.open(base / name)
        j_capacity_reset()
        capacity.reset_routing_history()
        run_jterator(get, stores[name], raw, kw)
    capacity.reset_routing_history()
    return {"base": base, "ref_store": ref_store, "port_store": port_store,
            "ref": ref, "port": port, **stores}


def j_capacity_reset():
    from tmlibrary_tpu import capacity as j_capacity

    j_capacity.reset_routing_history()


def sorted_rows(table) -> tuple[np.ndarray, dict]:
    """Row order by (site_index, label) of a pandas frame or a dict of
    columns, and the columns in that order."""
    cols = {k: np.asarray(table[k]) for k in table}
    order = np.lexsort((cols["label"], cols["site_index"]))
    return order, {k: v[order] for k, v in cols.items()}


def assert_same_features(ref_frame, port_cols, tiers=CORRECTED_FEATURE_TIERS):
    _, want = sorted_rows(ref_frame)
    _, got = sorted_rows(port_cols)
    assert list(got) == list(ref_frame.columns)
    for k in ("site_index", "well_row", "well_col", "site_y", "site_x", "label"):
        np.testing.assert_array_equal(got[k], want[k].astype(np.int64), err_msg=k)
        assert got[k].dtype == np.int64
    assert got["plate"].tolist() == [str(p) for p in want["plate"]]
    for k in got:
        if k in ("site_index", "plate", "well_row", "well_col", "site_y", "site_x", "label"):
            continue
        assert got[k].dtype == np.float64
        rtol, atol = feature_tier(k, tiers)
        np.testing.assert_allclose(got[k], want[k].astype(np.float64), rtol=rtol, atol=atol,
                                   err_msg=k)


def assert_same_labels(a, b, names=("nuclei", "cells")):
    for name in names:
        x, y = a.read_labels(None, name), b.read_labels(None, name)
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y, err_msg=name)


# ---------------------------------------------------------- end to end
def test_corilla_matches_the_reference(runs):
    ref, port = runs["ref_store"], runs["port_store"]
    for cycle in range(2):
        for ch in range(2):
            a, b = port.read_illumstats(cycle, ch), ref.read_illumstats(cycle, ch)
            assert list(a) == list(b)
            for k in ("n", "percentile_keys", "percentile_values"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            for k, (rtol, atol) in STATS_TIERS.items():
                assert a[k].dtype == b[k].dtype == np.float32
                np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol, err_msg=k)
            assert int(a["n"]) == N_SITES


def test_align_matches_the_reference(runs):
    ref, port = runs["ref_store"], runs["port_store"]
    a, b = port.read_shifts(1), ref.read_shifts(1)
    assert a.dtype == b.dtype == np.int32
    np.testing.assert_array_equal(a, b)
    drift = np.random.default_rng(1).integers(-DRIFT, DRIFT + 1, (N_SITES, 2))
    np.testing.assert_array_equal(a, -drift)
    assert port.read_intersection() == ref.read_intersection()
    assert not port.has_shifts(0)


def test_jterator_labels_and_features_match_the_reference(runs):
    ref, port = runs["ref_store"], runs["port_store"]
    assert_same_labels(port, ref)
    for name in ("nuclei", "cells"):
        assert_same_features(ref.read_features(name), port.read_features(name))
    assert_same_labels(runs["port_raw"], runs["ref_raw"])
    for name in ("nuclei", "cells"):
        assert_same_features(runs["ref_raw"].read_features(name),
                             runs["port_raw"].read_features(name), FEATURE_TIERS)
    # the window crop: labels outside the intersection were padded back
    w = port.read_intersection()
    lab = port.read_labels(None, "nuclei")
    assert not lab[:, : w["top"]].any() and not lab[:, :, : w["left"]].any()
    assert lab.max() > 0


def test_jterator_summaries_and_collect_match_the_reference(runs):
    (ref_results, ref_collect), (port_results, port_collect) = runs["ref"], runs["port"]
    assert port_results == ref_results
    assert port_collect == ref_collect
    types = "mapobject_types.json"
    assert json.loads((runs["port_store"].root / types).read_text()) == \
        json.loads((runs["ref_store"].root / types).read_text())
    assert port_collect["objects_total"]["nuclei"] == sum(
        r["objects"]["nuclei"] for r in port_results)
    # a cold router starts at the smallest rung and escalates
    assert {r["bucket_capacity"] for r in port_results} >= {4, 64}
    assert sum(r.get("bucket_escalations", 0) for r in port_results) >= 1


def test_jterator_over_the_reference_statistics_and_shifts(runs, tmp_path):
    """Cross-backend state: the port's jterator over illumination
    statistics and shifts that the reference's corilla and align wrote
    gives the reference's labels."""
    src = runs["ref_store"].root
    copy_store(src, tmp_path / "x", parts=("images", "illumstats", "alignment"))
    st = ExperimentStore.open(tmp_path / "x")
    run_jterator(get_step, st, JTERATOR, {"device": "cpu"})
    assert_same_labels(st, runs["ref_store"])
    for name in ("nuclei", "cells"):
        assert_same_features(runs["ref_store"].read_features(name), st.read_features(name))


@pytest.mark.parametrize("buckets,depth,sequential", [
    ("off", None, False), ("auto", 1, False), ("auto", 3, False), ("8,32", None, False),
    ("auto", None, True), ("2,4", 2, False),
])
def test_bucket_settings_and_depths_write_identical_stores(runs, tmp_path, buckets, depth,
                                                           sequential):
    copy_store(runs["port_store"].root, tmp_path / "x",
               parts=("images", "illumstats", "alignment"))
    st = ExperimentStore.open(tmp_path / "x")
    results, summary = run_jterator(get_step, st, {**JTERATOR, "object_buckets": buckets},
                                    {"device": "cpu"}, depth=depth, sequential=sequential)
    assert_same_labels(st, runs["port_store"])
    for name in ("nuclei", "cells"):
        a, b = st.read_features(name), runs["port_store"].read_features(name)
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    summary.pop("pipeline_stats", None)
    assert summary == runs["port"][1]
    # which rung a batch ran at depends on when the peaks before it were
    # persisted; what it found does not
    keep = ("n_sites", "objects", "saturated")
    assert [{k: r[k] for k in keep if k in r} for r in results] == \
        [{k: r[k] for k in keep if k in r} for r in runs["port"][0]]
    caps = {r["bucket_capacity"] for r in results}
    if buckets == "off":
        assert caps == {64}
    elif buckets == "8,32":
        assert caps <= {8, 32, 64}


def test_a_second_init_packs_from_history_like_the_reference(runs, tmp_path):
    """After a run, ``init`` harvests the persisted per-site counts and
    packs rung-homogeneous batches: the plan's sites, rungs and
    predictions equal the reference's, and the store is unchanged."""
    copy_store(runs["port_store"].root, tmp_path / "p",
               parts=("images", "illumstats", "alignment", "features", "segmentations"))
    copy_store(runs["ref_store"].root, tmp_path / "r",
               parts=("images", "illumstats", "alignment", "features", "segmentations"))
    port = get_step("jterator")(ExperimentStore.open(tmp_path / "p"), device="cpu")
    ref = j_get_step("jterator")(JStore.open(tmp_path / "r"))
    port.init(JTERATOR)
    ref.init(JTERATOR)
    plan = json.loads((port.step_dir / "schedule_plan.json").read_text())
    ref_plan = json.loads((ref.step_dir / "schedule_plan.json").read_text())
    keep = ("sites", "predicted", "rung", "shard_work", "shard_work_naive")
    assert [{k: b[k] for k in keep} for b in plan["batches"]] == \
        [{k: b[k] for k in keep} for b in ref_plan["batches"]]
    assert plan["history"] == ref_plan["history"] and plan["ladder"] == ref_plan["ladder"]
    assert [port.load_batch(i)["sites"] for i in port.list_batches()] == \
        [ref.load_batch(i)["sites"] for i in ref.list_batches()]
    for i in port.list_batches():
        port.run(i)
    assert_same_labels(port.store, runs["port_store"])


def test_auto_resegment_from_a_cap_of_four_matches_the_reference(runs, tmp_path):
    args = {**JTERATOR, "max_objects": 4}
    copy_store(runs["ref_store"].root, tmp_path / "r",
               parts=("images", "illumstats", "alignment"))
    copy_store(runs["ref_store"].root, tmp_path / "p",
               parts=("images", "illumstats", "alignment"))
    j_capacity_reset()
    ref = JStore.open(tmp_path / "r")
    ref_results, ref_collect = run_jterator(j_get_step, ref, args, {}, sequential=True)
    port = ExperimentStore.open(tmp_path / "p")
    port_results, port_collect = run_jterator(get_step, port, args, {"device": "cpu"},
                                              sequential=True)
    assert any("saturated" in r for r in port_results)
    assert port_results == ref_results
    assert port_collect == ref_collect
    assert port_collect["resegmented"] and "saturated_sites" not in port_collect
    step_dir = "workflow/jterator"
    for f in ("cap_overrides.json", "saturation.json"):
        assert json.loads((port.root / step_dir / f).read_text()) == \
            json.loads((ref.root / step_dir / f).read_text())
    assert_same_labels(port, ref)
    for name in ("nuclei", "cells"):
        assert_same_features(ref.read_features(name), port.read_features(name))
    # the full-cap run's store: the resegmented batches now hold every object
    assert_same_labels(port, runs["ref_store"])


# ------------------------------------------------------------ pieces
def test_window_pad_back_and_centroid_shift_match_the_reference(runs, tmp_path):
    """The reference persists morphology (with its host-side solidity) in
    the site frame; the port's pipeline on the same cropped inputs, put
    back through :func:`to_site_frame`, gives its labels and centroids."""
    copy_store(runs["ref_store"].root, tmp_path / "r", parts=("images", "alignment"))
    ref = JStore.open(tmp_path / "r")
    args = {**JTERATOR, "pipe": "morph.pipe.json", "object_buckets": "off"}
    run_jterator(j_get_step, ref, args, {})
    w = ref.read_intersection()
    window = (w["top"], w["bottom"], w["left"], w["right"])
    assert window != (0, 0, 0, 0)
    port = ExperimentStore.open(tmp_path / "r")
    desc = PipelineDescription.load(port.root / "morph.pipe.json")
    fn = ImageAnalysisPipeline(desc, 64, device="cpu").build_batch_fn(window)
    sites = list(range(N_SITES))
    raw = {ch: torch.from_numpy(port.read_sites(sites, cycle=1, channel=i))
           for i, ch in enumerate(("DAPI", "Actin"))}
    res = fn(raw, {}, torch.from_numpy(port.read_shifts(1)))
    objects = {k: v.numpy() for k, v in res.objects.items()}
    meas = {o: {f: v.numpy() for f, v in feats.items()} for o, feats in res.measurements.items()}
    cropped_cy = meas["nuclei"]["Morphology_centroid_y"].copy()
    objects, meas = to_site_frame(objects, meas, window)
    assert objects["nuclei"].shape == (N_SITES, SIZE, SIZE)
    np.testing.assert_array_equal(objects["nuclei"], ref.read_labels(None, "nuclei"))
    np.testing.assert_array_equal(objects["cells"], ref.read_labels(None, "cells"))
    assert meas["nuclei"]["Morphology_centroid_y"].dtype == np.float32
    np.testing.assert_array_equal(meas["nuclei"]["Morphology_centroid_y"],
                                  cropped_cy + np.float32(window[0]))
    frame = ref.read_features("nuclei")
    _, want = sorted_rows(frame)
    counts = res.counts["nuclei"].numpy()
    for axis in ("y", "x"):
        got = np.concatenate([meas["nuclei"][f"Morphology_centroid_{axis}"][b, :c]
                              for b, c in enumerate(counts)])
        rtol, atol = feature_tier(f"Morphology_centroid_{axis}", FEATURE_TIERS)
        np.testing.assert_allclose(got, want[f"Morphology_centroid_{axis}"], rtol=rtol,
                                   atol=atol)
    # volumes pad their last two axes; no window is the identity
    vol = np.ones((2, 3, 5, 4), np.int32)
    padded, _ = to_site_frame({"v": vol}, {}, (1, 2, 3, 4))
    assert padded["v"].shape == (2, 3, 8, 11) and padded["v"][:, :, 1:6, 3:7].all()
    assert to_site_frame({"v": vol}, {"v": {}}, None)[0]["v"] is vol


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_feature_table_equals_the_reference_rows(seed):
    rng = np.random.default_rng(seed)
    b, m = 5, 8
    counts = rng.integers(0, m + 3, b)
    counts[0] = 0
    feats = {"Intensity_sum_DAPI": rng.normal(size=(b, m)).astype(np.float32),
             "Intensity_max_DAPI": rng.integers(0, 9, (b, m)).astype(np.float32)}
    feats["Intensity_sum_DAPI"][1, 0] = np.nan
    meta = [{"site_index": s, "plate": f"plate{s % 2:02d}", "well_row": s // 3,
             "well_col": s % 3, "site_y": 1, "site_x": s % 2} for s in (7, 2, 9, 0, 4)]
    got = feature_table(counts, feats, meta, m)
    want = JRunner._feature_table("nuclei", counts, feats, meta, m)
    assert list(got) == list(want.columns)
    assert len(got["label"]) == len(want) == int(np.minimum(counts, m).sum())
    for k in got:
        if k == "plate":
            assert got[k].tolist() == want[k].tolist()
            continue
        np.testing.assert_array_equal(got[k], want[k].to_numpy(dtype=got[k].dtype), err_msg=k)
    empty = feature_table(np.zeros(0, np.int32), {"f": np.zeros((0, m))}, [], m)
    assert all(len(v) == 0 for v in empty.values()) and empty["f"].dtype == np.float64


@pytest.mark.parametrize("args,kw", [
    ({"layout": "spatial"}, {}),
    ({"n_devices": 2}, {}),
    ({"as_polygons": True}, {}),
    ({"figures": True}, {}),
])
def test_unsupported_arguments_raise(tmp_path, args, kw):
    """These arguments used to be refused; each now runs.  The spatial
    layout writes every site's mosaic labels and one feature shard per
    well; ``n_devices=2`` clamps to the process group (one rank here) and
    writes ``n_devices=1``'s store; ``as_polygons`` writes one polygon
    table per batch and family whose labels are the label stacks' ids;
    ``figures`` one overlay per site and family.  (Against the
    reference's: ``test_torch_spatial.py``.)"""
    make_store(tmp_path / "s")
    st = ExperimentStore.open(tmp_path / "s")
    base = {**JTERATOR, "pipe": "raw.pipe.json", "cycle": 0}
    results, _ = run_jterator(get_step, st, {**base, **args}, {"device": "cpu", **kw},
                              sequential=True)
    if args.get("layout") == "spatial":
        assert [r["layout"] for r in results] == ["spatial"] * 4
        lab = st.read_labels(None, "mosaic_cells")
        assert lab.shape == (N_SITES, SIZE, SIZE) and lab.max() > 0
        feats = st.read_features("mosaic_cells")
        assert set(feats["site_index"]) == {-1} and len(feats["label"]) == sum(
            r["objects"]["mosaic_cells"] for r in results)
    elif "n_devices" in args:
        copy_store(tmp_path / "s", tmp_path / "one")
        one = ExperimentStore.open(tmp_path / "one")
        capacity.reset_routing_history()
        run_jterator(get_step, one, base, {"device": "cpu"}, sequential=True)
        assert_same_labels(st, one)
        for name in ("nuclei", "cells"):
            a, b = st.read_features(name), one.read_features(name)
            assert list(a) == list(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    elif args.get("as_polygons"):
        from tmlibrary_tpu_torch.io import parquet

        for name in ("nuclei", "cells"):
            lab = st.read_labels(None, name)
            paths = sorted((st.root / "segmentations").glob(f"{name}_polygons_batch_*.parquet"))
            assert len(paths) == N_SITES // JTERATOR["batch_size"]
            table = {k: np.concatenate([parquet.read_table(p)[k] for p in paths])
                     for k in ("site", "label", "n_vertices")}
            want = sorted((s, int(v)) for s in range(N_SITES) for v in np.unique(lab[s]) if v)
            assert sorted(zip(table["site"].tolist(), table["label"].tolist())) == want
            assert (table["n_vertices"] > 0).all()
    else:
        from tmlibrary_tpu_torch.io import png

        for name in ("nuclei", "cells"):
            for s in range(N_SITES):
                img = png.read(st.root / "figures" / f"{name}_site{s:05d}.png")
                assert img.shape == (SIZE, SIZE, 3) and img.dtype == np.uint8


#: the reference's jitted step and its eager pipeline differ in these by
#: up to 1.1e-4 (eccentricity) and 4.8e-3 (orientation) on this store:
#: XLA fuses their second-moment sums in another order
MOMENTS = ("Morphology_eccentricity", "Morphology_major_axis_length",
           "Morphology_minor_axis_length", "Morphology_orientation")


def test_a_morphology_pipeline_raises_until_solidity_is_ported(tmp_path):
    """Solidity's host pass is ported: a morphology pipeline runs through
    the port's step, and its store equals the reference's, with
    ``Morphology_solidity`` bit-exact and last among the nuclei columns.
    The second-moment features are held against the reference's eager
    pipeline on the same sites, as ``test_torch_full_stack.py`` holds
    them; every other column against the reference's store."""
    import jax.numpy as jnp

    from tmlibrary_tpu.jterator.description import PipelineDescription as JDesc
    from tmlibrary_tpu.jterator.pipeline import ImageAnalysisPipeline as JPipeline

    make_store(tmp_path / "s")
    copy_store(tmp_path / "s", tmp_path / "r")
    args = {**JTERATOR, "pipe": "morph.pipe.json", "cycle": 0}
    st = ExperimentStore.open(tmp_path / "s")
    run_jterator(get_step, st, args, {"device": "cpu"}, sequential=True)
    j_capacity_reset()
    ref = JStore.open(tmp_path / "r")
    run_jterator(j_get_step, ref, args, {}, sequential=True)
    assert_same_labels(st, ref)
    for name in ("nuclei", "cells"):
        want = ref.read_features(name)
        assert_same_features(want.drop(columns=[m for m in MOMENTS if m in want]),
                             {k: v for k, v in st.read_features(name).items()
                              if k not in MOMENTS}, FEATURE_TIERS)
    got, want = st.read_features("nuclei"), ref.read_features("nuclei")
    assert list(got)[-1] == list(want.columns)[-1] == "Morphology_solidity"
    _, got_rows = sorted_rows(got)
    _, want_rows = sorted_rows(want)
    np.testing.assert_array_equal(got_rows["Morphology_solidity"],
                                  want_rows["Morphology_solidity"])
    assert (got["Morphology_solidity"] > 0.5).all() and (got["Morphology_solidity"] <= 1).all()
    sites = list(range(N_SITES))
    raw = {ch: jnp.asarray(ref.read_sites(sites, cycle=0, channel=i))
           for i, ch in enumerate(("DAPI", "Actin"))}
    eager = JPipeline(JDesc.load(ref.root / "morph.pipe.json"), max_objects=64).build_batch_fn(
        jit=False)(raw, {}, jnp.zeros((N_SITES, 2), jnp.int32))
    counts = np.asarray(eager.counts["nuclei"])
    for m in MOMENTS:
        arr = np.asarray(eager.measurements["nuclei"][m])
        rows = np.concatenate([arr[b, :c] for b, c in enumerate(counts)]).astype(np.float64)
        rtol, atol = feature_tier(m, FEATURE_TIERS)
        np.testing.assert_allclose(got_rows[m], rows, rtol=rtol, atol=atol, err_msg=m)


def test_a_reference_batch_file_with_an_unported_layout_is_refused(tmp_path):
    """The reference's spatial batch files used to be refused; the port
    now runs them and writes the reference's spatial store (its labels
    bit for bit, its feature shards column for column)."""
    make_store(tmp_path / "s")
    copy_store(tmp_path / "s", tmp_path / "r")
    ref_step = j_get_step("jterator")(JStore.open(tmp_path / "r"))
    ref_step.init({"layout": "spatial", "n_devices": 1})
    for i in ref_step.list_batches():
        ref_step.run(i)
    (tmp_path / "s" / "workflow" / "jterator").mkdir(parents=True, exist_ok=True)
    for f in (tmp_path / "r" / "workflow" / "jterator").glob("batch_*.json"):
        shutil.copy(f, tmp_path / "s" / "workflow" / "jterator" / f.name)
    port = get_step("jterator")(ExperimentStore.open(tmp_path / "s"), device="cpu")
    assert port.list_batches() == ref_step.list_batches() == [0, 1, 2, 3]
    for i in port.list_batches():
        assert port.run(i)["layout"] == "spatial"
    st, ref = ExperimentStore.open(tmp_path / "s"), JStore.open(tmp_path / "r")
    assert_same_labels(st, ref, names=("mosaic_cells",))
    want = ref.read_features("mosaic_cells")
    got = st.read_features("mosaic_cells")
    assert list(got) == list(want.columns)
    for k in got:
        if k == "plate":
            assert got[k].tolist() == want[k].tolist()
            continue
        if got[k].dtype.kind == "i":
            np.testing.assert_array_equal(got[k], want[k].to_numpy(), err_msg=k)
            continue
        rtol, atol = feature_tier(k, FEATURE_TIERS)
        np.testing.assert_allclose(got[k], want[k].to_numpy(np.float64), rtol=rtol, atol=atol,
                                   err_msg=k)


def test_escalation_sees_objects_dropped_before_the_area_filter(tmp_path):
    """The capacity clip runs before the area filter, so a site can lose
    an object to the clip and still end below the cap: nine squares, the
    first too small for ``min_area``, at a rung of 8.  The reference's
    router persists that run (7 objects, not its ``"off"`` store's 8;
    ROADMAP C); the port escalates on the objects found before the clip
    and writes the ``"off"`` store."""
    exp = grid_experiment("clip", well_rows=1, well_cols=1, sites_per_well=(1, 2),
                          channel_names=("DAPI",), site_shape=(SIZE, SIZE))
    img = np.full((2, SIZE, SIZE), 100, np.uint16)
    img[:, 2:5, 2:5] = 5000  # 9 px: first in scan order, below min_area
    for i in range(8):
        y, x = 12 + 12 * (i // 4), 4 + 14 * (i % 4)
        img[:, y:y + 6, x:x + 6] = 5000
    pipe = {"input": {"channels": [{"name": "DAPI", "correct": False}]},
            "pipeline": [{"handles": {
                "module": "segment_primary",
                "input": [{"name": "intensity_image", "type": "IntensityImage", "key": "DAPI"},
                          {"name": "threshold_method", "type": "Character", "value": "manual"},
                          {"name": "threshold_value", "type": "Numeric", "value": 1000},
                          {"name": "smooth_sigma", "type": "Numeric", "value": 0.0},
                          {"name": "min_area", "type": "Numeric", "value": 20}],
                "output": [{"name": "objects", "type": "SegmentedObjects", "key": "nuclei",
                            "objects": "nuclei"}]}}],
            "output": {"objects": [{"name": "nuclei"}]}}
    args = {"pipe": "clip.pipe.json", "batch_size": 2, "max_objects": 64, "n_devices": 1}
    stores = {}
    for name, get, store_cls, kw, buckets in (
            ("ref_8", j_get_step, JStore, {}, "8"), ("ref_off", j_get_step, JStore, {}, "off"),
            ("port_8", get_step, ExperimentStore, {"device": "cpu"}, "8"),
            ("port_off", get_step, ExperimentStore, {"device": "cpu"}, "off")):
        st = ExperimentStore.create(tmp_path / name, exp)
        st.write_sites(img, [0, 1])
        (st.root / "clip.pipe.json").write_text(json.dumps(pipe))
        stores[name] = store_cls.open(st.root)
        j_capacity_reset()
        capacity.reset_routing_history()
        results, _ = run_jterator(get, stores[name], {**args, "object_buckets": buckets}, kw,
                                  sequential=True)
        stores[name + "_results"] = results
    counts = {k: int(stores[k].read_labels(None, "nuclei").max(axis=(1, 2)).max())
              for k in ("ref_8", "ref_off", "port_8", "port_off")}
    assert counts == {"ref_8": 7, "ref_off": 8, "port_8": 8, "port_off": 8}
    assert stores["port_8_results"][0]["bucket_capacity"] == 64
    assert stores["port_8_results"][0]["bucket_escalations"] == 1
    assert stores["ref_8_results"][0]["bucket_capacity"] == 8
    assert_same_labels(stores["port_8"], stores["ref_off"], names=("nuclei",))
    assert_same_labels(stores["port_8"], stores["port_off"], names=("nuclei",))


def _qc_jterator(get, store, kw):
    """The config-3 jterator step, batch by batch, with a fresh session."""
    capacity.reset_routing_history()
    j_capacity_reset()
    jt = get("jterator")(store, **kw)
    jt.init(JTERATOR)
    return [jt.run(i) for i in jt.list_batches()]


def test_qc_true_records_each_batch_as_the_reference(runs, tmp_path):
    """``qc=True`` runs (it raised until the session was ported): every
    batch result carries the session's summary, equal to the reference's
    step with QC on; the store equals the QC-off run's."""
    for name in ("ref_qc", "port_qc"):
        src = runs["base"] / ("ref" if name == "ref_qc" else "port")
        copy_store(src, tmp_path / name, parts=("images", "illumstats", "alignment"))
    j_qc.set_enabled(True)
    j_qc.reset_session()
    qc.reset_session()
    try:
        want = _qc_jterator(j_get_step, JStore.open(tmp_path / "ref_qc"), {})
        port = ExperimentStore.open(tmp_path / "port_qc")
        got = _qc_jterator(get_step, port, {"device": "cpu", "qc": True})
        assert qc.enabled() is False and qc._session is not None
    finally:
        j_qc.set_enabled(None)
        j_qc.reset_session()
        qc.reset_session()
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        gq, wq = g.pop("qc"), w.pop("qc")
        assert {k: v for k, v in g.items() if k != "bucket_escalations"} == \
            {k: v for k, v in w.items() if k != "bucket_escalations"}
        assert sorted(gq) == sorted(wq)
        for k in ("nan_columns", "nan_values", "inf_values", "count_z_max", "flagged_total",
                  "flagged_sites", "capacity_saturated"):
            assert gq[k] == wq[k], k
        tiers = {"focus_min": QC_TIERS["focus_tenengrad"],
                 "saturation_max": QC_TIERS["saturation_frac"],
                 "background_mean": QC_TIERS["background"]}
        assert sorted(gq["channels"]) == sorted(wq["channels"]) == ["Actin", "DAPI"]
        for ch, entry in wq["channels"].items():
            assert sorted(gq["channels"][ch]) == sorted(entry)
            for k, v in entry.items():
                rtol, atol = tiers[k]
                np.testing.assert_allclose(gq["channels"][ch][k], v, rtol=rtol, atol=atol)
    assert_same_labels(port, runs["port_store"])


#: the DL segmenters' pipeline over cycle 0 (nothing to correct or align)
DL = {"pipe": "dl0.pipe.json", "cycle": 0, "batch_size": 4, "max_objects": 64,
      "n_devices": 1}


def test_the_dl_step_is_bit_identical_across_buckets_and_depths(tmp_path):
    """The reference's ``test_dl_step_bit_identical_across_depths_and_buckets``
    (``tests/test_nn.py:287``) in the port: label stacks and feature
    shards of the sequential run at ``object_buckets="off"`` equal those
    of the pipelined executor at depths 1 and 4 over bucket specs off, 16
    and auto."""
    st = make_store(tmp_path / "s")
    (st.root / "dl0.pipe.json").write_text(json.dumps(benchmarks.dl_secondary_pipe()))
    jt = get_step("jterator")(st, device="cpu")
    jt.init({**DL, "object_buckets": "off"})
    summaries = [jt.run(i) for i in jt.list_batches()]
    assert all(s["bucket_capacity"] == 64 for s in summaries)
    names = ("nuclei", "cells")
    labels = {n: st.read_labels(None, n).copy() for n in names}
    feats = {n: sorted_rows(st.read_features(n))[1] for n in names}
    assert 0 < int(labels["nuclei"].max()) < 16
    for spec, depth in (("off", 4), ("16", 4), ("auto", 1), ("auto", 4)):
        capacity.reset_routing_history()
        jt2 = get_step("jterator")(st, device="cpu")
        jt2.delete_previous_output()
        jt2.init({**DL, "object_buckets": spec})
        out = list(jt2.run_batches_pipelined([jt2.load_batch(i) for i in jt2.list_batches()],
                                             depth=depth))
        if spec != "off":
            assert any(r["bucket_capacity"] < 64 for _, r in out)
        for n in names:
            np.testing.assert_array_equal(st.read_labels(None, n), labels[n],
                                          err_msg=f"{n}: buckets={spec} depth={depth}")
            got = sorted_rows(st.read_features(n))[1]
            assert list(got) == list(feats[n])
            for k, v in feats[n].items():
                assert np.array_equal(got[k], v, equal_nan=v.dtype.kind == "f"), k
