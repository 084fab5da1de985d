"""The port's store, models, step API, capacity router, schedule and
pipelined executor, against the JAX package.

Small: a 2x2-well plate at 2x2 sites of 32x32, 2 channels, 2 cycles.
Stores written by either package open in the other, byte for byte; the
steps' argument schemas, the bucket ladder and routing, and the packing
plan equal the reference's on a seeded grid of inputs; the executor
keeps its order, drains its window and clamps its depth as
``tests/test_pipelined.py`` holds the reference's.
"""

import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from tmlibrary_tpu import capacity as j_capacity
from tmlibrary_tpu import errors as j_errors
from tmlibrary_tpu import utils as j_utils
from tmlibrary_tpu.models import experiment as j_experiment
from tmlibrary_tpu.models import image as j_image
from tmlibrary_tpu.models import mapobject as j_mapobject
from tmlibrary_tpu.models.store import ExperimentStore as JStore
from tmlibrary_tpu.workflow import registry as j_registry
from tmlibrary_tpu.workflow import schedule as j_schedule
from tmlibrary_tpu_torch import capacity, errors, utils
from tmlibrary_tpu_torch.device import resolve_device
from tmlibrary_tpu_torch.errors import DeviceError, StoreError
from tmlibrary_tpu_torch.models import experiment, image, mapobject
from tmlibrary_tpu_torch.models.store import ExperimentStore
from tmlibrary_tpu_torch.workflow import get_step, list_steps, schedule
from tmlibrary_tpu_torch.workflow.pipelined import (
    PipelinedExecutor,
    PipelineStats,
    is_resource_exhausted,
    prefetch_iter,
    resolve_pipeline_depth,
    supports_pipelining,
)

torch.set_num_threads(1)

SIZE = 32


@pytest.fixture(autouse=True)
def _cold_port_router():
    """The port's routing history is process-global, as the reference's
    (whose reset is the suite's autouse fixture)."""
    capacity.reset_routing_history()
    yield
    capacity.reset_routing_history()


def _grid(mod):
    return mod.grid_experiment("st", well_rows=2, well_cols=2, sites_per_well=(2, 2),
                               channel_names=("DAPI", "Actin"), site_shape=(SIZE, SIZE),
                               n_cycles=2)


def _fill(store, rng):
    """Pixels, labels, statistics and shifts through ``store``'s own writers."""
    n = store.n_sites
    for cycle in range(2):
        for ch in range(2):
            store.write_sites(rng.integers(0, 65535, (n, SIZE, SIZE)).astype(np.uint16),
                              list(range(n)), cycle=cycle, channel=ch)
            store.write_illumstats({
                "mean_log": rng.random((SIZE, SIZE)).astype(np.float32),
                "std_log": rng.random((SIZE, SIZE)).astype(np.float32),
                "var_log": rng.random((SIZE, SIZE)).astype(np.float32),
                "n": np.asarray(n, np.float32),
                "percentile_keys": np.asarray([0.1, 1.0, 50.0, 99.0, 99.9], np.float32),
                "percentile_values": rng.integers(0, 65535, 5).astype(np.float32),
            }, cycle=cycle, channel=ch)
    store.write_labels(rng.integers(0, 9, (n, SIZE, SIZE)).astype(np.int32),
                       list(range(n)), "nuclei")
    store.write_labels(rng.integers(0, 9, (4, SIZE, SIZE)).astype(np.int32), [3, 1, 7, 15],
                       "cells", tpoint=0, zplane=0)
    store.write_shifts(rng.integers(-9, 10, (n, 2)).astype(np.int32), 1)
    store.write_intersection({"top": 3, "bottom": 2, "left": 4, "right": 1})


def _assert_same_store(a, b):
    """Every plane, stack, statistic and alignment record of ``a`` reads
    back from ``b`` byte for byte."""
    assert a.experiment.to_dict() == b.experiment.to_dict()
    assert a.n_sites == b.n_sites
    for cycle in range(2):
        for ch in range(2):
            x, y = a.read_sites(None, cycle=cycle, channel=ch), b.read_sites(None, cycle=cycle,
                                                                             channel=ch)
            assert x.dtype == y.dtype == np.uint16 and x.tobytes() == y.tobytes()
            sa, sb = a.read_illumstats(cycle, ch), b.read_illumstats(cycle, ch)
            assert list(sa) == list(sb)
            for k in sa:
                assert sa[k].dtype == sb[k].dtype and sa[k].shape == sb[k].shape
                assert sa[k].tobytes() == sb[k].tobytes(), k
    assert a.list_objects() == b.list_objects() == ["cells", "nuclei"]
    for name in ("nuclei", "cells"):
        x, y = a.read_labels(None, name), b.read_labels(None, name)
        assert x.dtype == y.dtype == np.int32 and x.tobytes() == y.tobytes()
    idx = [5, 0, 9]
    assert a.read_sites(idx, cycle=1, channel=1).tobytes() == \
        b.read_sites(idx, cycle=1, channel=1).tobytes()
    assert a.read_shifts(1).tobytes() == b.read_shifts(1).tobytes()
    assert a.read_shifts(1).dtype == b.read_shifts(1).dtype
    assert a.read_intersection() == b.read_intersection()
    assert a.has_shifts(1) and b.has_shifts(1) and not b.has_shifts(0)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_store_opens_in_the_other_package_byte_for_byte(tmp_path, writer):
    rng = np.random.default_rng(3)
    if writer == "reference":
        written = JStore.create(tmp_path / "exp", _grid(j_experiment))
    else:
        written = ExperimentStore.create(tmp_path / "exp", _grid(experiment))
    _fill(written, rng)
    opened = (ExperimentStore if writer == "reference" else JStore).open(tmp_path / "exp")
    _assert_same_store(written, opened)
    assert sorted(p.name for p in (tmp_path / "exp").iterdir()) == sorted(
        ["manifest.json", "images", "illumstats", "segmentations", "features", "alignment",
         "pyramids", "workflow", "tools"])


def test_manifest_round_trips_between_packages(tmp_path):
    exp = experiment.grid_experiment("m", n_plates=2, well_rows=27, well_cols=3,
                                     sites_per_well=(1, 2), channel_names=("A", "B", "C"),
                                     n_cycles=3, n_zplanes=2)
    exp.save(tmp_path / "m.json")
    ref = j_experiment.Experiment.load(tmp_path / "m.json")
    assert ref.to_dict() == exp.to_dict()
    assert [r.as_tuple() for r in ref.sites()] == [r.as_tuple() for r in exp.sites()]
    assert [w.name for w in ref.plates[0].wells] == [w.name for w in exp.plates[0].wells]
    ref.save(tmp_path / "r.json")
    assert (tmp_path / "r.json").read_text() == (tmp_path / "m.json").read_text()
    assert exp.channel_index("C") == ref.channel_index("C") == 2
    with pytest.raises(errors.MetadataError):
        exp.channel_index("nope")


def test_feature_shards_are_npz_columns(tmp_path):
    """Feature shards were ``.npz`` columns; they are now Parquet both
    ways: the port's round trip, and the JAX package's store reading the
    port's shards as the DataFrame it would have written."""
    import pandas as pd

    st = ExperimentStore.create(tmp_path / "exp", _grid(experiment))
    with pytest.raises(StoreError):
        st.read_features("nuclei")
    a = {"site_index": np.array([0, 0, 2]), "plate": np.array(["p", "p", "p"]),
         "label": np.array([1, 2, 1]), "Intensity_sum_DAPI": np.array([1.5, np.nan, 3.0])}
    b = {k: v[:1] for k, v in a.items()}
    path = st.append_features("nuclei", a, shard="batch_001")
    st.append_features("nuclei", b, shard="batch_000")
    assert path.name == "batch_001.parquet"
    assert path.read_bytes()[:4] == path.read_bytes()[-4:] == b"PAR1"
    got = st.read_features("nuclei")
    assert list(got) == list(a)
    for k in a:
        np.testing.assert_array_equal(got[k], np.concatenate([b[k], a[k]]))
    want = pd.concat([pd.DataFrame({k: v.tolist() for k, v in t.items()}) for t in (b, a)],
                     ignore_index=True)
    pd.testing.assert_frame_equal(JStore.open(st.root).read_features("nuclei"), want)
    st.append_features("nuclei", a, shard="batch_001")  # a re-run overwrites
    assert len(st.read_features("nuclei")["label"]) == 4
    with pytest.raises(StoreError):
        st.append_features("nuclei", {"a": np.zeros(2), "b": np.zeros(3)}, shard="x")


def test_stack_cache_reopens_after_the_file_is_replaced(tmp_path):
    """The inode-checked memmap cache of the reference: a stack deleted
    under a cached mapping is re-created, not written into the deleted
    file."""
    import shutil

    st = ExperimentStore.create(tmp_path / "exp", _grid(experiment))
    lab = np.ones((1, SIZE, SIZE), np.int32)
    st.write_labels(lab, [0], "nuclei")
    shutil.rmtree(st.root / "segmentations")
    (st.root / "segmentations").mkdir()
    st.write_labels(2 * lab, [1], "nuclei")
    fresh = ExperimentStore.open(st.root)
    assert fresh.read_labels([0, 1], "nuclei")[:, 0, 0].tolist() == [0, 2]
    with pytest.raises(StoreError):
        st.write_sites(np.zeros((2, SIZE, SIZE), np.uint16), [0])
    with pytest.raises(StoreError):
        st.read_sites([0], cycle=1, channel=0)
    with pytest.raises(StoreError):
        st.read_shifts(3)


def test_illumstats_container_matches_the_reference():
    rng = np.random.default_rng(5)
    d = {"mean_log": rng.random((SIZE, SIZE)).astype(np.float32),
         "std_log": rng.random((SIZE, SIZE)).astype(np.float32),
         "percentile_keys": np.asarray([0.1, 50.0], np.float32),
         "percentile_values": np.asarray([12.0, 300.0], np.float32),
         "n": np.asarray(16.0, np.float32)}
    port = image.IllumstatsContainer.from_store(d)
    ref = j_image.IllumstatsContainer.from_store(d)
    assert port.percentiles == ref.percentiles and port.n == ref.n == 16
    a, b = port.to_store(), ref.to_store()
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    sp, sr = port.smooth(2.0), ref.smooth(2.0)
    for k in ("mean_log", "std_log"):
        np.testing.assert_allclose(getattr(sp, k).numpy(), np.asarray(getattr(sr, k)),
                                   rtol=1e-6, atol=1e-7)
    assert sp.to_store()["mean_log"].dtype == np.float32


def test_mapobject_geometry_and_registry_match_the_reference(tmp_path):
    for rows, cols, sites in ((2, 2, (2, 2)), (8, 12, (2, 2)), (16, 24, (3, 1))):
        kw = dict(well_rows=rows, well_cols=cols, sites_per_well=sites, site_shape=(256, 200))
        exp, jexp = experiment.grid_experiment(**kw), j_experiment.grid_experiment(**kw)
        assert mapobject.plate_grid(exp, "plate00") == j_mapobject.plate_grid(jexp, "plate00")
        for spacing in (0, 7):
            assert mapobject.plate_mosaic_shape(exp, "plate00", spacing) == \
                j_mapobject.plate_mosaic_shape(jexp, "plate00", spacing)
    for n_levels in (1, 3, 8):
        for px in (0.0, 3.0, 50.0, 1e4, 1e7):
            assert mapobject.min_poly_zoom(n_levels, px) == j_mapobject.min_poly_zoom(n_levels, px)
    with pytest.raises(errors.MetadataError):
        mapobject.plate_grid(experiment.grid_experiment(), "nope")
    reg = mapobject.MapobjectTypeRegistry(tmp_path)
    reg.register(mapobject.MapobjectType("nuclei", min_poly_zoom=3))
    reg.register(mapobject.MapobjectType("cells"))
    jreg = j_mapobject.MapobjectTypeRegistry(tmp_path)
    assert jreg.names() == reg.names() == ["cells", "nuclei"]
    assert jreg.get("nuclei").to_dict() == reg.get("nuclei").to_dict()
    reg.delete("cells")
    assert jreg.names() == ["nuclei"]
    with pytest.raises(errors.MetadataError):
        reg.get("cells")


def test_errors_keep_the_reference_hierarchy():
    for name in ("MetadataError", "PipelineError", "PipelineDescriptionError", "HandleError",
                 "JobDescriptionError", "NotSupportedError", "RegistryError", "StoreError",
                 "PreemptedError"):
        port, ref = getattr(errors, name), getattr(j_errors, name)
        port_bases = [c.__name__ for c in port.__mro__]
        ref_bases = [c.__name__ for c in ref.__mro__]
        assert port_bases == ref_bases, name
    e = errors.PreemptedError("x", step="jterator", in_flight=3, drained=2, abandoned=1)
    assert (e.step, e.in_flight, e.drained, e.abandoned, e.reason) == \
        ("jterator", 3, 2, 1, "signal")


def test_utils_match_the_reference():
    for n in range(-1, 70):
        assert utils.next_power_of_two(n) == j_utils.next_power_of_two(n)
    for size in (1, 3, 4, 32):
        assert utils.create_partitions(range(10), size) == j_utils.create_partitions(range(10),
                                                                                     size)
    with pytest.raises(ValueError):
        utils.create_partitions([1], 0)


#: arguments whose help describes the port's routes and resolution chain
PORT_HELP = {"jterator": {
    "batch_size": ("cuda",),
    "object_buckets": ("cuda-scoped",),
    "schedule": ("TM_SCHEDULE", "same backend"),
    "reduction_strategy": ("grouped_stats", "scatter", "setting", "same backend"),
}}


@pytest.mark.parametrize("step", ["metaconfig", "imextract", "corilla", "align", "illuminati",
                                  "jterator"])
def test_step_schema_equals_the_reference(step):
    port = get_step(step).batch_args
    ref = j_registry.get_step(step).batch_args
    # the port's own help where it resolves an argument its own way
    own_help = PORT_HELP.get(step, {})

    def strip(schema):
        return [{k: v for k, v in a.items() if not (k == "help" and a["name"] in own_help)}
                for a in schema]

    assert strip(port.to_schema()) == strip(ref.to_schema())
    helps = {a["name"]: a["help"] for a in port.to_schema()}
    for name, words in own_help.items():
        assert all(w in helps[name] for w in words), name
    given = {a["name"]: "src" for a in ref.to_schema() if a["required"]}
    assert port.resolve(given) == ref.resolve(given)


def test_registry_lists_the_ported_steps():
    assert list_steps() == ["align", "corilla", "illuminati", "imextract", "jterator",
                            "metaconfig"]
    with pytest.raises(errors.RegistryError):
        get_step("nope")


@pytest.mark.parametrize("step", ["metaconfig", "imextract", "corilla", "align", "illuminati",
                                  "jterator"])
def test_step_defaults_to_the_card(tmp_path, step):
    st = ExperimentStore.create(tmp_path / "exp", _grid(experiment))
    with pytest.raises(DeviceError):
        get_step(step)(st)
    assert get_step(step)(st, device="cpu").device == torch.device("cpu")
    assert resolve_device("cpu").type == "cpu"


def test_batch_files_resolve_in_both_packages(tmp_path):
    """A ``batch_*.json`` planned by the port loads in the reference's
    step, and the reverse, with equal resolved arguments."""
    st = ExperimentStore.create(tmp_path / "exp", _grid(experiment))
    _fill(st, np.random.default_rng(0))
    port = get_step("align")(st, device="cpu")
    planned = port.init({"batch_size": 3, "max_shift": 20})
    jst = JStore.open(st.root)
    ref = j_registry.get_step("align")(jst)
    assert ref.list_batches() == port.list_batches() == list(range(len(planned)))
    assert ref.load_batch(2) == port.load_batch(2)
    assert ref.batch_args.resolve(port.load_batch(0)["args"]) == port.load_batch(0)["args"]
    ref.init({"batch_size": 5})
    assert port.load_batch(0) == ref.load_batch(0)
    with pytest.raises(errors.JobDescriptionError):
        port.load_batch(99)


# ------------------------------------------------------------ capacity
CAPACITY_GRID = [(m, spec) for m in (1, 5, 8, 9, 64, 256, 300)
                 for spec in ("auto", "off", "none", "8,32", "4, 16,", "500,2", "")]


@pytest.mark.parametrize("ceiling,spec", CAPACITY_GRID)
def test_capacity_ladder_and_routing_equal_the_reference(monkeypatch, ceiling, spec):
    for var in ("TMX_OBJECT_BUCKETS", "TM_OBJECT_BUCKETS", "TMX_SCHEDULE_EWMA"):
        monkeypatch.delenv(var, raising=False)
    ladder = capacity.resolve_bucket_ladder(ceiling, spec)
    assert ladder == j_capacity.resolve_bucket_ladder(ceiling, spec)
    rng = np.random.default_rng(ceiling)
    for observed in list(range(0, ceiling + 3)) + rng.integers(0, 1000, 20).tolist():
        assert capacity.select_capacity(observed, ladder) == \
            j_capacity.select_capacity(observed, ladder)
        for count in (0, 1, 3):
            for current in ladder:
                assert capacity.likely_next_rungs(current, ladder, observed, count) == \
                    j_capacity.likely_next_rungs(current, ladder, observed, count)
    for slots, cap in ((0, 8), (64, 8), (100, 32), (7, 0)):
        assert capacity.ceiling_slots(slots, cap, ceiling) == \
            j_capacity.ceiling_slots(slots, cap, ceiling)
        assert capacity.slot_occupancy(cap, slots) == j_capacity.slot_occupancy(cap, slots)
    key = capacity.routing_key("digest", ceiling, ladder)
    assert key == j_capacity.routing_key("digest", ceiling, ladder)
    counts = [dict(zip(rng.integers(0, 30, 6).tolist(), rng.integers(0, 50, 6).tolist()))
              for _ in range(3)]
    j_capacity.reset_routing_history()
    try:
        for c in counts:
            for peak in c.values():
                assert capacity.note_observed_peak(key, peak) == \
                    j_capacity.note_observed_peak(key, peak)
            capacity.note_site_counts(key, c)
            j_capacity.note_site_counts(key, c)
        seed = {s: 99 for s in range(40)}
        assert capacity.seed_site_counts(key, seed) == j_capacity.seed_site_counts(key, seed)
        assert capacity.site_count_snapshot(key) == j_capacity.site_count_snapshot(key)
        assert capacity.observed_peak(key) == j_capacity.observed_peak(key)
    finally:
        j_capacity.reset_routing_history()


def test_capacity_rejects_malformed_specs():
    for bad in ("eight", "8,x", "0", "-3"):
        if bad == "0":  # "0" is an off spelling
            assert capacity.resolve_bucket_ladder(16, bad) == (16,)
            continue
        with pytest.raises(ValueError):
            capacity.resolve_bucket_ladder(16, bad)
        with pytest.raises(ValueError):
            j_capacity.resolve_bucket_ladder(16, bad)
    with pytest.raises(ValueError):
        capacity.resolve_bucket_ladder(0)


# ------------------------------------------------------------ schedule
PLAN_GRID = [(n, bs, dev, seed) for n in (1, 7, 16, 33) for bs in (1, 4, 8)
             for dev in (1, 3) for seed in (0, 1)]


@pytest.mark.parametrize("n,batch_size,n_devices,seed", PLAN_GRID)
def test_pack_plan_equals_the_reference(monkeypatch, n, batch_size, n_devices, seed):
    monkeypatch.delenv("TMX_SCHEDULE", raising=False)
    rng = np.random.default_rng(seed * 100 + n)
    sites = rng.permutation(n + 5)[:n].tolist()
    predicted = (rng.integers(0, 60, n) + rng.random(n) * (seed == 1)).tolist()
    ladder = capacity.resolve_bucket_ladder(64, "auto")
    plan = schedule.pack_plan(sites, predicted, batch_size, ladder, n_devices, seed="d")
    ref = j_schedule.pack_plan(sites, predicted, batch_size, ladder, n_devices, seed="d")
    assert plan == ref
    assert schedule.plan_digest(plan) == j_schedule.plan_digest(ref) == plan["digest"]
    for shards in (1, 2, 5):
        assert schedule.contiguous_shard_work(predicted, shards) == \
            j_schedule.contiguous_shard_work(predicted, shards)
    key = capacity.routing_key("d", 64, ladder)
    table = dict(zip(sites[::2], predicted[::2]))
    capacity.seed_site_counts(key, table)
    j_capacity.seed_site_counts(key, table)
    try:
        assert schedule.predict_site_counts(key, sites, 17.0) == \
            j_schedule.predict_site_counts(key, sites, 17.0)
    finally:
        j_capacity.reset_routing_history()


def test_schedule_modes_and_plan_file(tmp_path, monkeypatch):
    monkeypatch.delenv("TMX_SCHEDULE", raising=False)
    for mode in (None, "", "auto", "pack", "on", "off", "no", "TRUE"):
        assert schedule.resolve_schedule(mode) == j_schedule.resolve_schedule(mode)
        assert schedule.schedule_enabled(mode) == j_schedule.schedule_enabled(mode)
    with pytest.raises(ValueError):
        schedule.resolve_schedule("sometimes")
    plan = schedule.pack_plan([3, 1, 2], [5.0, 1.0, 9.0], 2, (8, 16), 1, seed="s")
    path = tmp_path / "schedule_plan.json"
    schedule.write_plan(path, plan)
    assert schedule.load_plan(path) == j_schedule.load_plan(path) == plan
    schedule.write_plan(path, None)
    assert not path.exists() and schedule.load_plan(path) is None
    path.write_text("{torn")
    assert schedule.load_plan(path) is None


def test_harvest_store_counts_reads_the_port_shards(tmp_path):
    st = ExperimentStore.create(tmp_path / "exp", _grid(experiment))
    assert schedule.harvest_store_counts(st) == {}
    st.append_features("nuclei", {"site_index": np.array([0, 0, 0, 4]),
                                  "label": np.array([1, 2, 3, 1])}, "batch_000")
    st.append_features("cells", {"site_index": np.array([0, 4, 4, 4, 4]),
                                 "label": np.array([1, 1, 2, 3, 4])}, "batch_000")
    st.append_features("cells", {"site_index": np.array([9]),
                                 "label": np.array([1])}, "batch_001")
    assert schedule.harvest_store_counts(st) == {0: 3, 4: 4, 9: 1}


# ------------------------------------------------------------ executor
class FakeStep:
    """The reference tests' fake launch/persist step
    (``tests/test_pipelined.py:46-80``)."""

    name = "fake"

    def __init__(self, fail_at=None, fail_exc=None, fail_times=1):
        self.fail_at = fail_at
        self.fail_exc = fail_exc or ValueError("launch failed")
        self.fail_remaining = fail_times
        self.launched: list[int] = []
        self.persisted: list[int] = []
        self.prefetch_threads: list[str] = []
        self.persist_threads: list[str] = []

    def prefetch_batch(self, batch):
        self.prefetch_threads.append(threading.current_thread().name)
        return {"loaded": batch["index"]}

    def launch_batch(self, batch, prefetched=None):
        i = batch["index"]
        if i == self.fail_at and self.fail_remaining > 0:
            self.fail_remaining -= 1
            raise self.fail_exc
        self.launched.append(i)
        if prefetched is not None:
            assert prefetched == {"loaded": i}
        return batch, {"payload": i * 10}

    def block_batch(self, ctx):
        pass

    def persist_batch(self, batch, ctx):
        self.persist_threads.append(threading.current_thread().name)
        self.persisted.append(batch["index"])
        return {"value": ctx["payload"], "index": batch["index"]}


def _batches(n):
    return [{"index": i} for i in range(n)]


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_executor_yields_in_order_with_prefetch(depth):
    step = FakeStep()
    stats = PipelineStats(depth, "cli")
    out = list(PipelinedExecutor(step, depth=depth, stats=stats).run(_batches(10)))
    assert [b["index"] for b, _ in out] == list(range(10))
    assert [r["value"] for _, r in out] == [i * 10 for i in range(10)]
    assert step.launched == step.persisted == list(range(10))
    assert len(step.prefetch_threads) == 10
    assert all(t.startswith("tmx-prefetch") for t in step.prefetch_threads)
    assert all(t.startswith("tmx-persist") for t in step.persist_threads)
    summary = stats.summary()
    assert summary["n_batches"] == 10 and summary["depth"] == depth
    assert set(summary["phases"]) == {"prefetch_wait", "dispatch", "device_block", "persist"}
    assert all(p["count"] == 10 for p in summary["phases"].values())
    per_batch = stats.per_batch()
    assert list(per_batch) == list(range(10))
    assert all(set(t) == set(summary["phases"]) for t in per_batch.values())


def test_midwindow_launch_failure_drains_whole_window():
    step = FakeStep(fail_at=2, fail_exc=ValueError("boom"), fail_times=99)
    yielded = []
    with pytest.raises(ValueError, match="boom"):
        for b, _ in PipelinedExecutor(step, depth=4).run(_batches(6)):
            yielded.append(b["index"])
    assert yielded == [0, 1]
    assert step.persisted == step.launched == [0, 1]


@pytest.mark.parametrize("exc", [
    RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
])
def test_oom_clamps_depth_and_retries(exc):
    step = FakeStep(fail_at=3, fail_exc=exc, fail_times=1)
    stats = PipelineStats(8, "cli")
    ex = PipelinedExecutor(step, depth=8, stats=stats)
    out = list(ex.run(_batches(6)))
    assert [b["index"] for b, _ in out] == list(range(6))
    assert step.persisted == list(range(6))
    assert step.launched == list(range(6))  # batch 3 retried after the drain
    summary = stats.summary()
    assert summary["depth"] == 4 and summary["depth_clamps"] == [{"from": 8, "to": 4}]
    assert summary["n_batches"] == 6


def test_oom_at_depth_one_propagates_and_other_failures_never_clamp():
    step = FakeStep(fail_at=1, fail_exc=MemoryError("host OOM"), fail_times=99)
    yielded = []
    with pytest.raises(MemoryError):
        for b, _ in PipelinedExecutor(step, depth=1).run(_batches(4)):
            yielded.append(b["index"])
    assert yielded == [0]
    stats = PipelineStats(4)
    step = FakeStep(fail_at=2, fail_exc=OSError("disk gone"), fail_times=99)
    with pytest.raises(OSError):
        list(PipelinedExecutor(step, depth=4, stats=stats).run(_batches(5)))
    assert stats.summary()["depth_clamps"] == [] and stats.summary()["depth"] == 4


def test_executor_helpers():
    assert supports_pipelining(FakeStep())
    assert not supports_pipelining(object())
    for exc, want in ((MemoryError(), True), (RuntimeError("Resource exhausted: HBM"), True),
                      (torch.cuda.OutOfMemoryError("x"), True), (ValueError("bad"), False),
                      (OSError("connection reset"), False)):
        assert is_resource_exhausted(exc) is want
    assert resolve_pipeline_depth(None, "cuda") == (8, "default")
    assert resolve_pipeline_depth(None, torch.device("cpu")) == (2, "default")
    assert resolve_pipeline_depth(3, "cpu") == (3, "cli")
    assert resolve_pipeline_depth(0, "cpu") == (2, "default")
    assert list(prefetch_iter(range(20), lambda i: i * i, depth=3)) == [i * i for i in range(20)]
    assert list(prefetch_iter([5], lambda i: -i)) == [-5]

    def load(i):
        if i == 4:
            raise KeyError(i)
        return i

    got = []
    with pytest.raises(KeyError):
        for v in prefetch_iter(range(8), load, depth=2):
            got.append(v)
    assert got == [0, 1, 2, 3]


def test_pipe_json_reads_without_yaml(tmp_path):
    """The card's machine has no ``yaml``: a ``.pipe.json`` is read with
    ``json``, and the reference reads the same file through YAML."""
    from tmlibrary_tpu.jterator.description import PipelineDescription as JDesc
    from tmlibrary_tpu_torch import benchmarks

    path = tmp_path / "cp.pipe.json"
    path.write_text(json.dumps(benchmarks.CELL_PAINTING_PIPE))
    root = Path(__file__).resolve().parents[1]
    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "from tmlibrary_tpu_torch.jterator.description import PipelineDescription\n"
        f"d = PipelineDescription.load({str(path)!r})\n"
        "print(len(d.modules), [c.name for c in d.channels])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["5", "['DAPI',", "'Actin']"]
    ref = JDesc.load(path)
    assert [m.module for m in ref.modules] == ["smooth", "segment_primary", "segment_secondary",
                                               "measure_intensity", "measure_intensity"]


def test_new_modules_import_neither_jax_nor_the_jax_package():
    mods = ["tmlibrary_tpu_torch.errors", "tmlibrary_tpu_torch.utils",
            "tmlibrary_tpu_torch.models", "tmlibrary_tpu_torch.models.experiment",
            "tmlibrary_tpu_torch.models.store", "tmlibrary_tpu_torch.models.image",
            "tmlibrary_tpu_torch.models.mapobject", "tmlibrary_tpu_torch.capacity",
            "tmlibrary_tpu_torch.workflow", "tmlibrary_tpu_torch.workflow.args",
            "tmlibrary_tpu_torch.workflow.registry", "tmlibrary_tpu_torch.workflow.api",
            "tmlibrary_tpu_torch.workflow.pipelined", "tmlibrary_tpu_torch.workflow.schedule",
            "tmlibrary_tpu_torch.workflow.steps", "tmlibrary_tpu_torch.workflow.steps.corilla",
            "tmlibrary_tpu_torch.workflow.steps.align",
            "tmlibrary_tpu_torch.workflow.steps.jterator",
            "tmlibrary_tpu_torch.workflow.steps.metaconfig",
            "tmlibrary_tpu_torch.workflow.steps.imextract",
            "tmlibrary_tpu_torch.workflow.steps.illuminati",
            "tmlibrary_tpu_torch.workflow.steps.vendors",
            "tmlibrary_tpu_torch.workflow.steps.omexml", "tmlibrary_tpu_torch.readers",
            "tmlibrary_tpu_torch.writers", "tmlibrary_tpu_torch.io.png",
            "tmlibrary_tpu_torch.models.metadata", "tmlibrary_tpu_torch.cli",
            "tmlibrary_tpu_torch.analytics", "tmlibrary_tpu_torch.analytics.rng",
            "tmlibrary_tpu_torch.analytics.store", "tmlibrary_tpu_torch.analytics.ops",
            "tmlibrary_tpu_torch.analytics.index", "tmlibrary_tpu_torch.analytics.spatial",
            "tmlibrary_tpu_torch.analytics.tools", "tmlibrary_tpu_torch.analytics.query",
            "tmlibrary_tpu_torch.tools", "tmlibrary_tpu_torch.tools.base",
            "tmlibrary_tpu_torch.tools.clustering", "tmlibrary_tpu_torch.tools.classification",
            "tmlibrary_tpu_torch.tools.heatmap", "tmlibrary_tpu_torch.benchmarks",
            "tmlibrary_tpu_torch.yamlio", "tmlibrary_tpu_torch.jterator.project",
            "tmlibrary_tpu_torch.jterator.handles", "tmlibrary_tpu_torch.jterator.description",
            "tmlibrary_tpu_torch.ngff", "tmlibrary_tpu_torch.config",
            "tmlibrary_tpu_torch.native", "tmlibrary_tpu_torch.cfb",
            "tmlibrary_tpu_torch.container_writers", "tmlibrary_tpu_torch.io.hdf5",
            "tmlibrary_tpu_torch.io.parquet", "tmlibrary_tpu_torch.log",
            "tmlibrary_tpu_torch.telemetry", "tmlibrary_tpu_torch.faults",
            "tmlibrary_tpu_torch.resilience", "tmlibrary_tpu_torch.atomicio",
            "tmlibrary_tpu_torch.slo", "tmlibrary_tpu_torch.timeseries",
            "tmlibrary_tpu_torch.canary", "tmlibrary_tpu_torch.aotstore",
            "tmlibrary_tpu_torch.serve", "tmlibrary_tpu_torch.traceexport",
            "tmlibrary_tpu_torch.top", "tmlibrary_tpu_torch.workflow.admission",
            "tmlibrary_tpu_torch.workflow.engine", "tmlibrary_tpu_torch.qc",
            "tmlibrary_tpu_torch.parallel.distributed", "chip_smoke"]
    code = (
        "import importlib, sys\n"
        "for banned in ('yaml', 'pandas', 'cv2', 'pyarrow', 'PIL', 'h5py', 'sklearn',\n"
        "               'zstandard'):\n"
        "    sys.modules[banned] = None\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from tmlibrary_tpu_torch.workflow import list_steps; print(list_steps())\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'tmlibrary_tpu' or m.startswith('tmlibrary_tpu.'))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stdout + out.stderr
    assert "['align', 'corilla', 'illuminati', 'imextract', 'jterator', 'metaconfig']" \
        in out.stdout


def test_not_supported_on_corilla(tmp_path):
    """``n_devices > 1`` on corilla used to be refused; it now clamps to
    the process group, which is one rank here, and gives the statistics
    of ``n_devices=1`` (several ranks: ``test_torch_spatial.py``)."""
    st = ExperimentStore.create(tmp_path / "exp", _grid(experiment))
    _fill(st, np.random.default_rng(1))
    stats = []
    for n in (2, 1):
        step = get_step("corilla")(st, device="cpu")
        assert step.init({"n_devices": n})
        step.run(0)
        stats.append(st.read_illumstats(0, 0))
    assert list(stats[0]) == list(stats[1])
    for k in stats[0]:
        np.testing.assert_array_equal(stats[0][k], stats[1][k], err_msg=k)


def test_shared_state_survives_many_threads():
    """The routing history and the executor's phase times are written by
    persist workers while the engine thread reads them: many threads and
    a short switch interval lose no update."""
    import concurrent.futures

    key = capacity.routing_key("stress", 64, (8, 64))
    stats = PipelineStats(4)
    n_threads, n_each = 16, 300

    def work(t):
        for i in range(n_each):
            capacity.note_observed_peak(key, t * n_each + i)
            capacity.note_site_counts(key, {t: float(i)})
            stats.record("persist", 1.0, batch=t)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(n_threads) as pool:
            for f in [pool.submit(work, t) for t in range(n_threads)]:
                f.result(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert capacity.observed_peak(key) == n_threads * n_each - 1
    assert sorted(capacity.site_count_snapshot(key)) == list(range(n_threads))
    summary = stats.summary()["phases"]["persist"]
    assert summary["count"] == n_threads * n_each and summary["total_s"] == n_threads * n_each
    assert all(t["persist"] == n_each for t in stats.per_batch().values())
