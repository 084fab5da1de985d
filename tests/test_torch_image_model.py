"""The port's image model and the stragglers of the module diff, against
the JAX package.

``Image``, ``ChannelImage``, ``SegmentationImage`` and ``PyramidTile``
(``tmlibrary_tpu_torch/models/image.py``) method by method against the
reference's on the same planes, and ``extract``/``insert``/``pad`` of
``ops/image_ops.py``; the PNG of a tile round-trips through the port's
reader and decodes, through cv2, to the reference's pixels.  Then the
small names the module diff lacked: the JSON/XML readers and writers
(``tests/test_readers_writers.py``'s round trip, both ways between the
packages), ``propagate_labels_3d``, ``flops_fields``,
``program_cost``/``cost_flops``, ``record_import``,
``routing_history_snapshot``,
``experiment_location``, ``MapobjectTypeRegistry.list``,
``WorkflowDescription.active_steps`` and ``flatten``/``assert_type``/
``pad_to``.
"""

from xml.etree import ElementTree

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import CORRECTION_TIER
from tmlibrary_tpu.models import image as j_image
from tmlibrary_tpu.ops import image_ops as j_ops
from tmlibrary_tpu_torch.io import png
from tmlibrary_tpu_torch.models import image as t_image
from tmlibrary_tpu_torch.ops import image_ops

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def plane():
    rng = np.random.default_rng(11)
    return rng.integers(0, 4000, (40, 48)).astype(np.float32)


@pytest.fixture(scope="module")
def labels():
    lab = np.zeros((40, 48), np.int32)
    lab[3:10, 4:12] = 1
    lab[20:31, 5:9] = 2
    lab[12:18, 30:44] = 3
    lab[33:39, 40:47] = 5
    return lab


def same(got, want):
    got = got.array if isinstance(got, t_image.Image) else got
    want = want.array if isinstance(want, j_image.Image) else want
    np.testing.assert_array_equal(got.detach().cpu().numpy(), np.asarray(want))
    assert str(got.dtype).split(".")[-1] == str(np.asarray(want).dtype)


# ---------------------------------------------------------------- image ops
@pytest.mark.parametrize("y,x,h,w", [(0, 0, 8, 8), (5, 7, 20, 30), (35, 40, 10, 12),
                                     (-3, -5, 4, 4), (0, 0, 40, 48)])
def test_extract_equals_the_reference(plane, y, x, h, w):
    same(image_ops.extract(torch.from_numpy(plane), y, x, h, w),
         j_ops.extract(jnp.asarray(plane), y, x, h, w))


@pytest.mark.parametrize("y,x", [(0, 0), (10, 12), (38, 45), (-2, 3)])
def test_insert_equals_the_reference(plane, y, x):
    patch = np.arange(6 * 9, dtype=np.int32).reshape(6, 9)
    same(image_ops.insert(torch.from_numpy(plane), torch.from_numpy(patch), y, x),
         j_ops.insert(jnp.asarray(plane), jnp.asarray(patch), y, x))


@pytest.mark.parametrize("widths,value", [((0, 0, 0, 0), 0), ((2, 3, 1, 0), 0),
                                          ((1, 1, 4, 4), 7)])
def test_pad_equals_the_reference(plane, widths, value):
    same(image_ops.pad(torch.from_numpy(plane), *widths, value=value),
         j_ops.pad(jnp.asarray(plane), *widths, value=value))


def test_image_ops_take_a_batch(plane):
    """The port's ops act on the last two axes of a batch alike."""
    stack = torch.from_numpy(np.stack([plane, plane + 1]))
    for got, one in ((image_ops.extract(stack, 3, 4, 10, 11),
                      lambda p: image_ops.extract(p, 3, 4, 10, 11)),
                     (image_ops.pad(stack, 1, 2, 3, 4, value=9),
                      lambda p: image_ops.pad(p, 1, 2, 3, 4, value=9)),
                     (image_ops.insert(stack, torch.zeros(2, 5, 5), 6, 6),
                      lambda p: image_ops.insert(p, torch.zeros(5, 5), 6, 6))):
        for s in range(2):
            assert torch.equal(got[s], one(stack[s]))
    with pytest.raises(ValueError):
        image_ops.pad(stack, -1, 0, 0, 0)
    with pytest.raises(ValueError):
        image_ops.extract(stack, 0, 0, 41, 2)


# ------------------------------------------------------------------ classes
def test_image_methods_equal_the_reference(plane):
    meta = {"site": 3, "channel": "DAPI"}
    port, ref = t_image.Image(torch.from_numpy(plane), dict(meta)), \
        j_image.Image(jnp.asarray(plane), dict(meta))
    assert port.shape == ref.shape == (40, 48)
    assert port.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_array_equal(port.numpy(), ref.numpy())
    for name, args in (("extract", (4, 6, 12, 13)), ("pad", (1, 2, 3, 4, 5))):
        got, want = getattr(port, name)(*args), getattr(ref, name)(*args)
        assert type(got) is t_image.Image and got.metadata == want.metadata == meta
        same(got, want)
    patch = np.ones((5, 6), np.float32)
    same(port.insert(t_image.Image(torch.from_numpy(patch)), 30, 40),
         ref.insert(j_image.Image(jnp.asarray(patch)), 30, 40))


def test_image_join_equals_the_reference_and_join_grid(plane):
    tiles = [plane + 10 * k for k in range(6)]
    port = t_image.Image.join([t_image.Image(torch.from_numpy(p), {"k": i})
                               for i, p in enumerate(tiles)], 2, 3)
    ref = j_image.Image.join([j_image.Image(jnp.asarray(p), {"k": i})
                              for i, p in enumerate(tiles)], 2, 3)
    same(port, ref)
    assert port.metadata == ref.metadata == {"k": 0}
    stacked = t_image.Image.join(torch.from_numpy(np.stack(tiles)), 2, 3)
    same(stacked, image_ops.join_grid(torch.from_numpy(np.stack(tiles)), 2, 3))
    assert stacked.metadata == {}
    with pytest.raises(ValueError):
        t_image.Image.join([], 1, 1)


def test_channel_image_methods_equal_the_reference(plane):
    rng = np.random.default_rng(5)
    mean_log = (2.5 + 0.3 * rng.random(plane.shape)).astype(np.float32)
    std_log = (0.1 + 0.2 * rng.random(plane.shape)).astype(np.float32)
    port = t_image.ChannelImage(torch.from_numpy(plane), {"c": 1})
    ref = j_image.ChannelImage(jnp.asarray(plane), {"c": 1})
    t_stats = t_image.IllumstatsContainer(mean_log, std_log, {}, 4)
    j_stats = j_image.IllumstatsContainer(jnp.asarray(mean_log), jnp.asarray(std_log), {}, 4)
    got, want = port.correct(t_stats), ref.correct(j_stats)
    assert type(got) is t_image.ChannelImage and got.metadata == {"c": 1}
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=CORRECTION_TIER[0],
                               atol=CORRECTION_TIER[1])
    for name, args in (("align", (3, -4)), ("align", (-2, 5, (1, 2, 3, 0))),
                       ("clip", (100.0, 2500.0)), ("scale", (100.0, 2500.0)),
                       ("smooth", (1.5,)), ("smooth", (3, "median"))):
        same(getattr(port, name)(*args), getattr(ref, name)(*args))
    with pytest.raises(ValueError):
        port.smooth(1.0, "box")


def test_channel_image_chain_equals_the_ops(plane):
    """correct -> align -> smooth is the ops called in turn, also on a
    batch with a shift a site."""
    rng = np.random.default_rng(6)
    stats = t_image.IllumstatsContainer(
        (2.5 + 0.3 * rng.random(plane.shape)).astype(np.float32),
        (0.1 + 0.2 * rng.random(plane.shape)).astype(np.float32), {}, 2)
    stack = torch.from_numpy(np.stack([plane, plane[::-1].copy()]))
    got = t_image.ChannelImage(stack).correct(stats).align([2, -1], [0, 3]).smooth(1.5)
    from tmlibrary_tpu_torch.ops.smooth import gaussian_smooth

    want = gaussian_smooth(image_ops.align(
        image_ops.correct_illumination(stack, torch.from_numpy(stats.mean_log),
                                       torch.from_numpy(stats.std_log)),
        torch.tensor([[2, 0], [-1, 3]])), 1.5)
    assert torch.equal(got.array, want)


def test_segmentation_image_equals_the_reference(labels):
    port = t_image.SegmentationImage(torch.from_numpy(labels))
    ref = j_image.SegmentationImage(jnp.asarray(labels))
    assert int(port.n_objects) == int(ref.n_objects) == 5
    np.testing.assert_array_equal(port.labels_host(), ref.labels_host())
    got, want = port.extract_polygons(), ref.extract_polygons()
    assert [lab for lab, _ in got] == [lab for lab, _ in want] == [1, 2, 3, 5]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
    batch = t_image.SegmentationImage(torch.from_numpy(np.stack([labels, labels // 2])))
    assert batch.n_objects.tolist() == [5, 2]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.uint16])
def test_pyramid_tile_png_round_trips(dtype):
    import cv2

    rng = np.random.default_rng(3)
    tile = (rng.random((256, 256)) * 300 - 20).astype(dtype)
    port = t_image.PyramidTile(torch.from_numpy(tile)).encode_png()
    ref = j_image.PyramidTile(tile).encode_png()
    want = cv2.imdecode(np.frombuffer(ref, np.uint8), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(png.decode(port), want)
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(port, np.uint8),
                                               cv2.IMREAD_UNCHANGED), want)
    if dtype == np.uint8:
        np.testing.assert_array_equal(png.decode(port), tile)
    with pytest.raises(ValueError):
        t_image.PyramidTile(torch.zeros(128, 256))


# ---------------------------------------------------------------- stragglers
@pytest.mark.parametrize("writer_pkg", ["port", "reference"])
def test_json_xml_round_trip_both_ways(tmp_path, writer_pkg):
    from tmlibrary_tpu import readers as j_readers
    from tmlibrary_tpu import writers as j_writers
    from tmlibrary_tpu_torch import readers, writers

    w_mod, r_mods = (writers, (readers, j_readers)) if writer_pkg == "port" else \
        (j_writers, (readers, j_readers))
    with w_mod.JsonWriter(tmp_path / "deep" / "x.json") as w:
        w.write({"a": [1, 2], "b": {"c": None}})
    el = ElementTree.Element("OME")
    ElementTree.SubElement(el, "Image", {"ID": "1"})
    with w_mod.XmlWriter(tmp_path / "x.xml") as w:
        w.write(el)
    for r_mod in r_mods:
        with r_mod.JsonReader(tmp_path / "deep" / "x.json") as r:
            assert r.read() == {"a": [1, 2], "b": {"c": None}}
        with r_mod.XmlReader(tmp_path / "x.xml") as r:
            back = r.read()
        assert back.tag == "OME" and back[0].get("ID") == "1"
    assert (tmp_path / "x.xml").read_bytes() == ElementTree.tostring(el)


def test_every_writer_is_a_writer(tmp_path):
    from tmlibrary_tpu_torch import writers

    for cls in (writers.ImageWriter, writers.OMETiffWriter, writers.DatasetWriter,
                writers.TablesWriter, writers.JsonWriter, writers.XmlWriter):
        assert issubclass(cls, writers.Writer)
    with writers.Writer(tmp_path / "a" / "b" / "f") as w:
        assert w.filename.parent.is_dir()


def test_propagate_labels_3d_equals_the_reference():
    from tmlibrary_tpu.ops.volume import propagate_labels_3d as j_propagate
    from tmlibrary_tpu_torch.ops.volume import propagate_labels_3d

    rng = np.random.default_rng(4)
    seeds = np.zeros((2, 8, 16, 16), np.int32)
    seeds[0, 4, 4, 4], seeds[0, 4, 12, 12] = 1, 2
    seeds[1, 1, 2, 3], seeds[1, 6, 13, 9], seeds[1, 3, 8, 8] = 3, 7, 5
    allowed = rng.random((2, 8, 16, 16)) < 0.7
    got = propagate_labels_3d(torch.from_numpy(seeds), torch.from_numpy(allowed))
    for b in range(2):
        want = np.asarray(j_propagate(jnp.asarray(seeds[b]), jnp.asarray(allowed[b])))
        np.testing.assert_array_equal(got[b].numpy(), want)
        assert torch.equal(propagate_labels_3d(torch.from_numpy(seeds[b]),
                                               torch.from_numpy(allowed[b])), got[b])
    full = propagate_labels_3d(torch.from_numpy(seeds[0]), torch.ones((8, 16, 16), dtype=torch.bool))
    assert set(full.unique().tolist()) == {1, 2}


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_flops_fields_equal_the_reference(backend):
    """The rates, the bytes an item and the arithmetic intensity equal
    the reference's; the peak shares are the card's (None on the CPU)."""
    from tmlibrary_tpu import perf as j_perf
    from tmlibrary_tpu_torch import perf

    args = dict(flops=3.2e9, n_items=64, best_s=0.0123, item_key="flops_per_site",
                nbytes=2.1e9)
    got = perf.flops_fields(backend=backend, **args)
    want = j_perf.flops_fields(backend="cpu", **args)
    shared = {"flops_per_site", "achieved_tflops_per_sec", "bytes_per_site",
              "achieved_gbytes_per_sec", "arithmetic_intensity", "bound_by"}
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    if backend == "cpu":
        assert got["fp32_peak_frac"] is None and got["hbm_peak_frac"] is None
    else:
        assert got["fp32_peak_frac"] == round(3.2e9 / 0.0123 / perf.H100_SXM_FP32_FLOPS, 6)
        assert got["hbm_peak_frac"] == round(2.1e9 / 0.0123 / perf.H100_SXM_HBM_BPS, 6)
    assert perf.flops_fields(None, 1, 1.0, backend) == {}


def test_program_cost_counts_one_call():
    from tmlibrary_tpu_torch import perf

    a, b = torch.ones(8, 16), torch.ones(16, 4)
    cost = perf.program_cost(torch.matmul, a, b, device="cpu")
    assert cost.flops == 2 * 8 * 16 * 4 and cost.bytes and cost.bytes > 0
    assert perf.cost_flops(torch.matmul, a, b, device="cpu") == (cost.flops, cost.bytes)

    def broken(x):
        raise RuntimeError("no")

    with pytest.raises(RuntimeError, match="no"):
        perf.program_cost(broken, a, device="cpu")


def test_record_import_counts_an_import_not_a_compile(tmp_path, monkeypatch):
    from tmlibrary_tpu_torch import aotstore, perf

    monkeypatch.setenv("TMX_AOT_STORE", "1")
    monkeypatch.setenv("TMX_AOT_STORE_DIR", str(tmp_path / "aot"))
    perf.reset_profiles()
    try:
        lib = tmp_path / "lib.so"
        lib.write_bytes(b"\x7fELF" * 64)
        aotstore.export_entry(lib, program="cuda_kernels", signature="s", compile_s=3.5)
        assert aotstore.import_entry(tmp_path / "out.so", program="cuda_kernels",
                                     signature="s") is not None
        (row,) = [p for p in perf.perf_profiles() if p["program"] == "cuda_kernels"]
        assert (row["imports"], row["compile_seconds_saved"], row["compiles"]) == (1, 3.5, 0)
        again = perf.record_import(program="cuda_kernels", saved_s=1.0)
        assert (again["imports"], again["compile_seconds_saved"]) == (2, 4.5)
    finally:
        perf.reset_profiles()
        aotstore.reset_counts()
        aotstore.reset_seconds_saved()


def test_capacity_stragglers_equal_the_reference(monkeypatch):
    from tmlibrary_tpu import capacity as j_capacity
    from tmlibrary_tpu_torch import capacity

    monkeypatch.delenv("TMX_OBJECT_BUCKETS", raising=False)
    monkeypatch.delenv("TM_OBJECT_BUCKETS", raising=False)
    assert capacity.resolve_bucket_ladder(64) == j_capacity.resolve_bucket_ladder(64) == \
        (8, 16, 32, 64)
    assert capacity.resolve_bucket_ladder(64, "off") == (64,)
    # "auto" is the pow2 ladder whatever the environment holds: the
    # port's spec is the jterator step's argument
    for name in ("TM_OBJECT_BUCKETS", "TMX_OBJECT_BUCKETS"):
        monkeypatch.setenv(name, "8,32")
        assert capacity.resolve_bucket_ladder(64) == (8, 16, 32, 64)
        assert capacity.resolve_bucket_ladder(64, "auto") == (8, 16, 32, 64)
        monkeypatch.delenv(name)
    capacity.reset_routing_history()
    j_capacity.reset_routing_history()
    try:
        for mod in (capacity, j_capacity):
            mod.note_observed_peak("k", 5)
            mod.note_observed_peak("k", 3)
        snap = capacity.routing_history_snapshot()
        assert snap == j_capacity.routing_history_snapshot() == {"k": 5}
        snap["k"] = 99
        assert capacity.observed_peak("k") == 5
    finally:
        capacity.reset_routing_history()
        j_capacity.reset_routing_history()


def test_experiment_location_equals_the_reference(tmp_path, monkeypatch):
    from tmlibrary_tpu.config import LibraryConfig as JConfig
    from tmlibrary_tpu_torch import config

    monkeypatch.setenv("TM_STORAGE_HOME", str(tmp_path))
    assert config.LibraryConfig().experiment_location("exp") == \
        JConfig().experiment_location("exp") == tmp_path / "experiments" / "exp"
    assert config.cfg.experiment_location("b") == tmp_path / "experiments" / "b"


def test_mapobject_registry_list_equals_the_reference(tmp_path):
    from tmlibrary_tpu.models import mapobject as j_mapobject
    from tmlibrary_tpu_torch.models import mapobject

    for mod, root in ((mapobject, tmp_path / "p"), (j_mapobject, tmp_path / "j")):
        root.mkdir()
        reg = mod.MapobjectTypeRegistry(root)
        reg.register(mod.MapobjectType("nuclei"))
        reg.register(mod.MapobjectType("Wells", ref_type="well", min_poly_zoom=2))
    got = [t.to_dict() for t in mapobject.MapobjectTypeRegistry(tmp_path / "p").list()]
    want = [t.to_dict() for t in j_mapobject.MapobjectTypeRegistry(tmp_path / "j").list()]
    assert got == want and len(got) == 2


def test_active_steps_equal_the_reference():
    from tmlibrary_tpu.workflow.engine import WorkflowDescription as JDesc
    from tmlibrary_tpu_torch.workflow.engine import WorkflowDescription

    spec = {"corilla": {}, "jterator": {"pipe": "p.json"}}
    port, ref = WorkflowDescription.canonical(spec), JDesc.canonical(spec)
    port.stages[0].steps[0].active = ref.stages[0].steps[0].active = False
    assert [(s.name, s.args) for s in port.active_steps()] == \
        [(s.name, s.args) for s in ref.active_steps()]


def test_utils_equal_the_reference():
    from tmlibrary_tpu import utils as j_utils
    from tmlibrary_tpu_torch import utils

    nested = [[1, 2], (3,), [], "ab"]
    assert utils.flatten(nested) == j_utils.flatten(nested) == [1, 2, 3, "a", "b"]
    assert utils.pad_to([1, 2], 4, 0) == j_utils.pad_to([1, 2], 4, 0) == [1, 2, 0, 0]
    utils.assert_type(3, "n", int, float)
    for mod in (utils, j_utils):
        with pytest.raises(ValueError):
            mod.pad_to([1, 2, 3], 2, 0)
        with pytest.raises(TypeError, match="argument 'n' must be of type int or float"):
            mod.assert_type("3", "n", int, float)
