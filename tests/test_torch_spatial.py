"""The port's spatial layout, polygons, figures and ``n_devices`` against
the JAX package's, on the CPU.

One rank: the port's jterator step with ``layout="spatial"`` and the
reference's, each over its copy of one store (two wells of 3x4 sites of
50x50 from ``synthetic_mosaic_well``, blobs across the seams; DAPI and a
dimmer second channel), with a secondary family through the second
channel, polygons and figures: per-site label stacks with the global ids
bit for bit, the wells' feature shards (``site_index`` -1) by
``FEATURE_TIERS``, polygon tables and figure PNGs decoded equal.  Then
with corilla's statistics and alignment shifts (the Otsu cut over the
valid pixels): labels equal, features by ``CORRECTED_FEATURE_TIERS``.

Several ranks (gloo, ``file://`` init, spawned; a rank imports only the
port): the spatial step on four ranks (a 2x2 grid: 150 rows do not
split four ways) and on two (row bands) writes the one-rank store; and
``workflow submit`` through the CLI on two ranks (corilla, illuminati and
jterator's sites layout at ``n_devices=2``, the engine's rank-0 plan
followed by rank 1; jterator's later batches route above the smallest
object-capacity rung) writes the one-rank store: tiles, labels and
features equal, corilla's statistics by ``STATS_TIERS`` (the sharded
Welford merges in another order).  The host passes behind the mosaic
features and polygons are held against the reference's native library.
"""

import json
import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from chip_smoke import CORRECTED_FEATURE_TIERS, FEATURE_TIERS, STATS_TIERS, feature_tier
from tmlibrary_tpu_torch import benchmarks
from tmlibrary_tpu_torch.io import parquet, png
from tmlibrary_tpu_torch.models.experiment import grid_experiment
from tmlibrary_tpu_torch.models.store import ExperimentStore
from tmlibrary_tpu_torch.workflow import get_step
from tmlibrary_tpu_torch.workflow.engine import WorkflowDescription

torch.set_num_threads(1)

GRID, SIZE = (3, 4), 50
SPATIAL = {"layout": "spatial", "spatial_secondary_channel": "Actin", "as_polygons": True,
           "figures": True}
FAMILIES = ("mosaic_cells", "mosaic_secondary")
SPATIAL_STAGES = ("stitch", "upload", "smooth", "otsu", "cc_min_propagate", "compaction",
                  "secondary_upload", "secondary_otsu", "watershed", "gather", "fetch",
                  "features", "writes")


def fill_store(store) -> None:
    """Two wells of the same mosaic well, the second one mirrored; Actin
    is DAPI halved plus 100."""
    _, tiles = benchmarks.synthetic_mosaic_well(*GRID, SIZE, cells_per_site=6, seed=3)
    n = GRID[0] * GRID[1]
    dapi = np.concatenate([tiles, tiles[:, ::-1, ::-1][::-1]])
    store.write_sites(dapi, list(range(2 * n)), channel=0)
    store.write_sites(dapi // 2 + 100, list(range(2 * n)), channel=1)


def experiment(grid_fn):
    return grid_fn("sp", well_rows=1, well_cols=2, sites_per_well=GRID,
                   channel_names=("DAPI", "Actin"), site_shape=(SIZE, SIZE))


def port_store(root) -> ExperimentStore:
    st = ExperimentStore.create(root, experiment(grid_experiment))
    fill_store(st)
    return st


def ref_store(root):
    from tmlibrary_tpu.models.experiment import grid_experiment as j_grid
    from tmlibrary_tpu.models.store import ExperimentStore as JStore

    st = JStore.create(root, experiment(j_grid))
    fill_store(st)
    return st


def run_step(step, args) -> list[dict]:
    step.init(args)
    return [step.run(i) for i in step.list_batches()]


def prepare(store, corrected: bool) -> None:
    """Corilla statistics (computed by the port, the same file in both
    stores) and a shift table that moves some sites."""
    if not corrected:
        return
    shifts = np.zeros((store.n_sites, 2), np.int32)
    shifts[[1, 5, 14, 20]] = [[3, -2], [-4, 1], [2, 2], [-1, -5]]
    store.write_shifts(shifts, 0)


def stats_into(src: ExperimentStore, dst_root) -> None:
    for f in (src.root / "illumstats").glob("*.npz"):
        shutil.copy(f, dst_root / "illumstats" / f.name)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "corrected"])
def single(request, tmp_path_factory):
    """The port's and the reference's spatial runs on one rank."""
    from tmlibrary_tpu.workflow.registry import get_step as j_get_step

    base = tmp_path_factory.mktemp("spatial")
    port = port_store(base / "port")
    ref = ref_store(base / "ref")
    corrected = request.param
    if corrected:
        run_step(get_step("corilla")(port, device="cpu"), {})
        stats_into(port, ref.root)
        prepare(port, True)
        prepare(ref, True)
    port_results = run_step(get_step("jterator")(port, device="cpu"), SPATIAL)
    ref_results = run_step(j_get_step("jterator")(ref), SPATIAL)
    return {"port": port, "ref": ref, "port_results": port_results,
            "ref_results": ref_results, "corrected": corrected}


def test_spatial_labels_match_the_reference(single):
    port, ref = single["port"], single["ref"]
    for fam in FAMILIES:
        a, b = port.read_labels(None, fam), ref.read_labels(None, fam)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b, err_msg=fam)
        assert a.max() > 0
    # the reference spreads each well over its 8 CPU devices (a 2x4
    # grid), the port runs it whole: the same labels either way
    assert [r.pop("mesh_shape") for r in single["port_results"]] == [[1, 1]] * 2
    assert [r.pop("mesh_shape") for r in single["ref_results"]] == [[2, 4]] * 2
    # the port's summary also times each stage of the step
    stages = [r.pop("stages") for r in single["port_results"]]
    assert [list(t) for t in stages] == [list(SPATIAL_STAGES)] * 2
    assert all(v >= 0 for t in stages for v in t.values())
    assert single["port_results"] == single["ref_results"]


def test_an_object_across_a_seam_keeps_one_id(single):
    """Some object spans two sites of its well (the reason for the
    layout): its id is in both sites' label stacks."""
    lab = single["port"].read_labels(None, "mosaic_cells")
    gx = GRID[1]
    shared = set()
    for s in range(GRID[0] * gx):
        if (s + 1) % gx:
            shared |= set(lab[s][:, -1][lab[s][:, -1] > 0]) & set(lab[s + 1][:, 0])
    assert shared


def test_spatial_features_match_the_reference(single):
    port, ref = single["port"], single["ref"]
    tiers = CORRECTED_FEATURE_TIERS if single["corrected"] else FEATURE_TIERS
    for fam in FAMILIES:
        got, want = port.read_features(fam), ref.read_features(fam)
        assert list(got) == list(want.columns)
        assert set(got["site_index"]) == {-1}
        assert got["plate"].tolist() == want["plate"].tolist()
        for k in got:
            if k == "plate":
                continue
            if got[k].dtype.kind in "iu":
                np.testing.assert_array_equal(got[k], want[k].to_numpy(), err_msg=k)
                continue
            rtol, atol = feature_tier(k, tiers)
            np.testing.assert_allclose(got[k], want[k].to_numpy(np.float64), rtol=rtol,
                                       atol=atol, err_msg=k)


def test_polygons_and_figures_match_the_reference(single):
    import cv2
    import pandas as pd

    port, ref = single["port"], single["ref"]
    paths = sorted((ref.root / "segmentations").glob("*_polygons_*.parquet"))
    assert len(paths) == 2 * len(FAMILIES)
    for p in paths:
        want = pd.read_parquet(p)
        got = pd.read_parquet(port.root / "segmentations" / p.name)
        assert list(got.columns) == list(want.columns) and len(got) == len(want) > 0
        assert got.dtypes.tolist() == want.dtypes.tolist()
        for col in got.columns:
            for x, y in zip(got[col], want[col]):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=col)
        own = parquet.read_table(port.root / "segmentations" / p.name)
        np.testing.assert_array_equal(own["label"], want["label"].to_numpy())
    figs = sorted((ref.root / "figures").glob("*.png"))
    assert len(figs) == 2 * len(FAMILIES)
    for f in figs:
        np.testing.assert_array_equal(png.read(port.root / "figures" / f.name),
                                      cv2.imread(str(f), cv2.IMREAD_UNCHANGED))


def test_mosaic_host_passes_match_the_reference(single):
    from tmlibrary_tpu import native as j_native
    from tmlibrary_tpu.ops.measure import zernike_host_features as j_zernike
    from tmlibrary_tpu.ops.polygons import labels_to_polygons as j_polygons
    from tmlibrary_tpu_torch import native
    from tmlibrary_tpu_torch.ops.mosaic import zernike_host_features
    from tmlibrary_tpu_torch.ops.polygons import labels_to_polygons

    lab = single["port"].read_labels(None, "mosaic_secondary")
    mosaic = lab[:GRID[1]].transpose(1, 0, 2).reshape(SIZE, -1)  # a strip of sites
    count = int(mosaic.max())
    vals = np.random.default_rng(0).random(mosaic.shape).astype(np.float32) * 1000
    for got, want in zip(native.mosaic_morph(mosaic, count),
                         j_native.mosaic_morph_host(mosaic, count)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(native.mosaic_intensity(mosaic, vals, count),
                         j_native.mosaic_intensity_host(mosaic, vals, count)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(zernike_host_features(mosaic, count, 6, row_block=7),
                                  j_zernike(mosaic, count, 6, row_block=7))
    got, want = labels_to_polygons(mosaic), j_polygons(mosaic)
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[1], w[1])
    with pytest.raises(ValueError):
        native.mosaic_morph(mosaic, count - 1)


# ------------------------------------------------------------- several ranks
PIPE = dict(benchmarks.CELL_PAINTING_PIPE)
SITES_WF = {"corilla": {"n_devices": 2, "chunk_size": 3},
            "illuminati": {"n_devices": 2, "correct": False},
            "jterator": {"pipe": "cp.pipe.json", "n_devices": 2, "batch_size": 3,
                         "max_objects": 32, "object_buckets": "2,4"}}


def sites_store(root) -> ExperimentStore:
    st = ExperimentStore.create(root, grid_experiment(
        "wf", well_rows=1, well_cols=2, sites_per_well=(2, 2), channel_names=("DAPI", "Actin"),
        site_shape=(48, 48)))
    data = benchmarks.synthetic_cell_painting_batch(8, size=48, n_cells=6, seed=2)
    for c, name in enumerate(("DAPI", "Actin")):
        st.write_sites(data[name].astype(np.uint16), list(range(8)), channel=c)
    (st.root / "cp.pipe.json").write_text(json.dumps(PIPE))
    return st


def workflow_file(root, steps: dict) -> str:
    path = root / "wf.json"
    desc = WorkflowDescription.canonical(steps)
    for stage in desc.stages:
        for sd in stage.steps:
            sd.active = sd.name in steps
    desc.save(path)
    return str(path)


def _worker(rank: int, world: int, init: str, roots: dict) -> None:
    torch.set_num_threads(1)
    from tmlibrary_tpu_torch import cli
    from tmlibrary_tpu_torch.parallel import distributed
    from tmlibrary_tpu_torch.workflow.engine import Workflow

    distributed.initialize(f"file://{init}", world, rank, device="cpu")
    try:
        st = ExperimentStore.open(roots["spatial"])
        desc = WorkflowDescription.load(roots["spatial_wf"])
        out = {"spatial": Workflow(st, desc, device="cpu").run()}
        if "sites" in roots:
            out["cli"] = cli.main(["workflow", "submit", "--root", roots["sites"],
                                   "--description", roots["sites_wf"], "--device", "cpu"])
        out["jax_free"] = not any(m == "jax" or m.startswith(("jax.", "tmlibrary_tpu."))
                                  or m == "tmlibrary_tpu" for m in sys.modules)
        with open(os.path.join(os.path.dirname(init), f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        distributed.shutdown()


def run_ranks(world: int, base, spatial_args: dict, with_sites: bool):
    roots = {"spatial": str(base / "spatial")}
    st = port_store(base / "spatial")
    roots["spatial_wf"] = workflow_file(st.root, {"jterator": spatial_args})
    if with_sites:
        sites = sites_store(base / "sites")
        roots["sites"] = str(sites.root)
        roots["sites_wf"] = workflow_file(sites.root, SITES_WF)
    mp.spawn(_worker, args=(world, str(base / "init"), roots), nprocs=world)
    out = []
    for r in range(world):
        with open(base / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def one_rank(base, spatial_args: dict, with_sites: bool):
    from tmlibrary_tpu_torch.workflow.engine import Workflow

    st = port_store(base / "spatial")
    Workflow(st, WorkflowDescription.load(workflow_file(st.root, {"jterator": spatial_args})),
             device="cpu").run()
    if with_sites:
        sites = sites_store(base / "sites")
        Workflow(sites, WorkflowDescription.load(workflow_file(sites.root, SITES_WF)),
                 device="cpu").run()


@pytest.fixture(scope="module", params=[4, 2], ids=["grid2x2", "rows2"])
def ranks(request, tmp_path_factory):
    world = request.param
    args = {**SPATIAL, "n_devices": world}
    many = tmp_path_factory.mktemp(f"ranks{world}")
    one = tmp_path_factory.mktemp(f"one{world}")
    results = run_ranks(world, many, args, with_sites=world == 2)
    one_rank(one, args, with_sites=world == 2)
    return world, results, many, one


def same_tree(a, b, exts=(".npy", ".parquet", ".png")) -> list[str]:
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.suffix in exts
                   and "workflow" not in p.parts)
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.suffix in exts
                           and "workflow" not in p.parts)
    return [str(f) for f in files]


def test_ranks_run_the_port_alone(ranks):
    world, results, _, _ = ranks
    assert all(r["jax_free"] for r in results)
    assert all(r.get("cli", 0) == 0 for r in results)
    assert results[0]["spatial"]["jterator"]["n_batches"] == 2
    assert all(r["spatial"] == {} for r in results[1:])


def test_spatial_on_several_ranks_writes_the_one_rank_store(ranks):
    world, results, many, one = ranks
    files = same_tree(many / "spatial", one / "spatial")
    assert any(f.endswith(".npy") for f in files) and any(f.endswith(".png") for f in files)
    for f in files:
        a, b = many / "spatial" / f, one / "spatial" / f
        if f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b), err_msg=f)
        elif f.endswith(".png"):
            np.testing.assert_array_equal(png.read(a), png.read(b), err_msg=f)
        else:
            x, y = parquet.read_table(a), parquet.read_table(b)
            assert list(x) == list(y)
            for k in x:
                if x[k].dtype == object:
                    assert [list(v) for v in x[k]] == [list(v) for v in y[k]], k
                else:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=f"{f} {k}")
    events = [json.loads(line) for line in
              (many / "spatial" / "workflow" / "ledger.jsonl").read_text().splitlines()]
    shapes = {tuple(e["result"]["mesh_shape"]) for e in events if e.get("event") == "batch_done"}
    assert shapes == ({(2, 2)} if world == 4 else {(2, 1)})


@pytest.mark.parametrize("ranks", [2], indirect=True, ids=["rows2"])
def test_sites_corilla_illuminati_on_two_ranks_write_the_one_rank_store(ranks):
    world, _, many, one = ranks
    assert world == 2
    a, b = ExperimentStore.open(many / "sites"), ExperimentStore.open(one / "sites")
    for ch in range(2):
        x, y = a.read_illumstats(0, ch), b.read_illumstats(0, ch)
        for k in ("n", "percentile_keys", "percentile_values"):
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        for k, (rtol, atol) in STATS_TIERS.items():
            np.testing.assert_allclose(x[k], y[k], rtol=rtol, atol=atol, err_msg=k)
    # the object-capacity router left its smallest rung after the first
    # batch, so the ranks had to agree on the rung of the later ones
    events = [json.loads(line) for line in
              (many / "sites" / "workflow" / "ledger.jsonl").read_text().splitlines()]
    caps = [e["result"]["bucket_capacity"] for e in events
            if e.get("event") == "batch_done" and e.get("step") == "jterator"]
    assert len(caps) == 3 and min(caps[1:]) > 2
    files = same_tree(many / "sites", one / "sites")
    assert sum(f.startswith("pyramids") for f in files) > 0
    for f in files:
        if f.endswith(".png"):
            np.testing.assert_array_equal(png.read(many / "sites" / f),
                                          png.read(one / "sites" / f), err_msg=f)
    for name in ("nuclei", "cells"):
        np.testing.assert_array_equal(a.read_labels(None, name), b.read_labels(None, name))
        x, y = a.read_features(name), b.read_features(name)
        assert list(x) == list(y) and len(x["label"]) > 0
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


# ------------------------------------------------- re-segmentation on ranks
#: jterator alone at a cap of 2 objects a site, the buckets' one rung,
#: where sites hold up to 4: collect re-segments the saturated batches at
#: doubled caps (4, then 8 for the site that fills 4)
RESEG = {"pipe": "cp.pipe.json", "n_devices": 2, "batch_size": 3, "max_objects": 2,
         "object_buckets": "2", "auto_resegment": True}


def _reseg_worker(rank: int, world: int, init: str, root: str) -> None:
    torch.set_num_threads(1)
    from tmlibrary_tpu_torch import capacity
    from tmlibrary_tpu_torch.parallel import distributed
    from tmlibrary_tpu_torch.workflow.engine import Workflow

    distributed.initialize(f"file://{init}", world, rank, device="cpu")
    try:
        capacity.reset_routing_history()
        out = Workflow(ExperimentStore.open(root), WorkflowDescription.load(
            str(ExperimentStore.open(root).root / "wf.json")), device="cpu").run()
        with open(os.path.join(os.path.dirname(init), f"reseg{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        distributed.shutdown()


@pytest.fixture(scope="module")
def resegmented(tmp_path_factory):
    """The jterator step at a saturating cap on two ranks, on one rank
    and in the reference, over copies of one store."""
    from tmlibrary_tpu import capacity as j_capacity
    from tmlibrary_tpu.models.experiment import grid_experiment as j_grid
    from tmlibrary_tpu.models.store import ExperimentStore as JStore
    from tmlibrary_tpu.workflow.registry import get_step as j_get_step
    from tmlibrary_tpu_torch import capacity
    from tmlibrary_tpu_torch.workflow.engine import Workflow

    base = tmp_path_factory.mktemp("reseg")
    many = sites_store(base / "many")
    workflow_file(many.root, {"jterator": RESEG})
    mp.spawn(_reseg_worker, args=(2, str(base / "init"), str(many.root)), nprocs=2)
    with open(base / "reseg0.pkl", "rb") as f:
        summary = pickle.load(f)
    one = sites_store(base / "one")
    capacity.reset_routing_history()
    Workflow(one, WorkflowDescription.load(workflow_file(one.root, {"jterator": RESEG})),
             device="cpu").run()
    capacity.reset_routing_history()
    ref = JStore.create(base / "ref", j_grid(
        "wf", well_rows=1, well_cols=2, sites_per_well=(2, 2), channel_names=("DAPI", "Actin"),
        site_shape=(48, 48)))
    for c in range(2):
        ref.write_sites(one.read_sites(None, channel=c), list(range(8)), channel=c)
    (ref.root / "cp.pipe.json").write_text(json.dumps(PIPE))
    j_capacity.reset_routing_history()
    jt = j_get_step("jterator")(ref)
    jt.init({**RESEG, "n_devices": 1})
    for i in jt.list_batches():
        jt.run(i)
    ref_collect = jt.collect()
    j_capacity.reset_routing_history()
    return summary, many, one, ref, ref_collect


def test_resegmentation_on_two_ranks_writes_the_one_rank_store(resegmented):
    summary, many, one, ref, ref_collect = resegmented
    collected = summary["jterator"]["collected"]
    # every saturated batch re-ran on both ranks and now holds its objects
    assert collected["resegmented"] and "saturated_sites" not in collected
    assert collected["resegmented"] == ref_collect["resegmented"]
    step = "workflow/jterator"
    for f in ("cap_overrides.json", "saturation.json"):
        assert json.loads((many.root / step / f).read_text()) == \
            json.loads((one.root / step / f).read_text()) == \
            json.loads((ref.root / step / f).read_text())
    for name in ("nuclei", "cells"):
        labels = many.read_labels(None, name)
        np.testing.assert_array_equal(labels, one.read_labels(None, name))
        np.testing.assert_array_equal(labels, ref.read_labels(None, name))
        x, y = many.read_features(name), one.read_features(name)
        assert list(x) == list(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        want = ref.read_features(name)
        assert list(x) == list(want.columns)
        assert len(x["label"]) == len(want)
        # a site holds more objects than the cap the step was planned with
        assert np.bincount(x["site_index"]).max() > RESEG["max_objects"]
        for k in x:
            if x[k].dtype.kind in "OU" or not k[0].isupper():  # identity columns
                assert x[k].tolist() == want[k].tolist(), k
                continue
            rtol, atol = feature_tier(k)
            np.testing.assert_allclose(x[k], want[k].to_numpy(), rtol=rtol, atol=atol,
                                       err_msg=k)
