"""The port's metaconfig and imextract against the JAX package's.

Both packages ingest the same source directory into their own store:
the default filename style with PNGs and with TIFFs, CellVoyager, the
OME companion (multi-page), Harmony, ImageXpress, MetaMorph, ScanR and
Leica sidecars (the fixtures ``tests/test_vendors.py`` writes), the
``auto`` handler, an explicit ``pattern`` and the InCell filename style.
The manifests, ``file_mapping.json`` and ``experiment.ome.xml`` texts,
step results and every stored plane are equal.  An unreadable ``.nd2``
is skipped as in the reference, and so is an unreadable ``.ims``; the
sidecar registry, its policy and the container helpers
equal the reference's.  The container formats themselves are held in
``test_torch_container_ingest.py``.
"""

import json
import shutil

import cv2
import numpy as np
import pytest

import test_vendors as tv
from tmlibrary_tpu.models.experiment import Experiment as JExperiment
from tmlibrary_tpu.models.store import ExperimentStore as JStore
from tmlibrary_tpu.workflow.registry import get_step as j_get_step
from tmlibrary_tpu.workflow.steps import vendors as j_vendors
from tmlibrary_tpu_torch.errors import (
    MetadataError,
    NotSupportedError,
    VendorConflictError,
)
from tmlibrary_tpu_torch.models.experiment import Experiment
from tmlibrary_tpu_torch.models.store import ExperimentStore
from tmlibrary_tpu_torch.workflow import get_step
from tmlibrary_tpu_torch.workflow.steps import metaconfig, vendors
from tmlibrary_tpu_torch.workflow.steps.omexml import parse_ome_xml, write_ome_xml


def random_site(rng, shape=(24, 20), dtype=np.uint16):
    return rng.integers(0, 4000 if dtype == np.uint16 else 255, shape).astype(dtype)


# ---------------------------------------------------------------- sources
def default_dir(src, suffix):
    rng = np.random.default_rng(1)
    for well in ("A01", "A02", "B01", "B02"):
        for site in range(4):
            for ch in ("DAPI", "Actin"):
                cv2.imwrite(str(src / f"{well}_s{site}_{ch}{suffix}"), random_site(rng))
    return {}


def cellvoyager_dir(src):
    tv._write_cv_dataset(src)
    return {"handler": "cellvoyager"}


def omexml_dir(src):
    rng = np.random.default_rng(2)
    for name in ("A01_s0", "A01_s1", "B02_s0", "B02_s1"):
        cv2.imwritemulti(str(src / f"{name}.tif"), [random_site(rng, (8, 8)) for _ in range(2)])
        (src / f"{name}.ome.xml").write_text(tv.OME_COMPANION.format(name=name))
    return {"handler": "omexml"}


def harmony_dir(src):
    tv._write_harmony_dataset(src)
    return {"handler": "harmony"}


def imagexpress_dir(src):
    tv._write_ixp_dataset(src)
    return {"handler": "imagexpress"}


def metamorph_dir(src):
    (src / "exp1.nd").write_text(tv.ND_FILE)
    rng = np.random.default_rng(0)
    for t in (1, 2):
        for wi, wave in ((1, "DAPI"), (2, "FITC")):
            for s in (1, 2, 3, 4):
                cv2.imwrite(str(src / f"exp1_w{wi}{wave}_s{s}_t{t}.tif"),
                            random_site(rng, (32, 32)))
    return {"handler": "metamorph"}


def scanr_dir(src):
    rng = np.random.default_rng(3)
    (src / "data").mkdir()
    for w, p, ch in ((1, 1, "DAPI"), (1, 2, "DAPI"), (14, 1, "DAPI"), (1, 1, "GFP"),
                     (1, 2, "GFP"), (14, 1, "GFP")):
        cv2.imwrite(str(src / "data" / f"exp--W{w:05d}--P{p:05d}--Z00000--T00000--{ch}.tif"),
                    random_site(rng, (8, 8)))
    return {"handler": "scanr"}


def leica_dir(src):
    rng = np.random.default_rng(4)
    (src / "field").mkdir()
    for x, y, c in ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0), (0, 0, 1), (1, 1, 1)):
        name = f"image--L00--S00--U01--V02--J08--E00--O00--X{x:02d}--Y{y:02d}--T00--Z00--C{c:02d}"
        cv2.imwrite(str(src / "field" / f"{name}.tif"), random_site(rng, (8, 8)))
    cv2.imwrite(str(src / "field" / "notleica.tif"), random_site(rng, (8, 8)))
    return {"handler": "leica"}


def incell_dir(src):
    rng = np.random.default_rng(5)
    for row, col in (("A", 1), ("B", 3)):
        for fld in (1, 2):
            for wv in ("Blue - DAPI", "Green - FITC"):
                cv2.imwrite(str(src / f"{row} - {col}(fld {fld} wv {wv}).tif"),
                            random_site(rng, (12, 12)))
    return {"handler": "incell"}


def auto_metamorph_dir(src):
    metamorph_dir(src)
    return {"handler": "auto"}


def auto_default_dir(src):
    default_dir(src, ".png")
    return {"handler": "auto", "sites_per_well_x": 2}


def pattern_dir(src):
    tv._write_cv_dataset(src)
    cv2.imwrite(str(src / "A01_s0_DAPI.tif"), random_site(np.random.default_rng(6), (32, 32)))
    return {"handler": "auto",
            "pattern": r"(?P<well>[A-Z]\d{2})_s(?P<site>\d+)_(?P<channel>[A-Za-z0-9]+)\.tif$"}


SOURCES = {
    "default_png": lambda src: default_dir(src, ".png"),
    "default_tif": lambda src: default_dir(src, ".tif"),
    "cellvoyager": cellvoyager_dir,
    "omexml": omexml_dir,
    "harmony": harmony_dir,
    "imagexpress": imagexpress_dir,
    "metamorph": metamorph_dir,
    "scanr": scanr_dir,
    "leica": leica_dir,
    "incell": incell_dir,
    "auto_sidecar": auto_metamorph_dir,
    "auto_filenames": auto_default_dir,
    "pattern": pattern_dir,
}


# ---------------------------------------------------------------- runners
def ingest(root, args, port: bool) -> list[dict]:
    """metaconfig then imextract (batches of 5 files) into a fresh store;
    returns every batch's result."""
    if port:
        store = ExperimentStore.create(root, Experiment(name="ing", plates=[], channels=[],
                                                        site_height=1, site_width=1))
        steps = [get_step(name)(store, device="cpu") for name in ("metaconfig", "imextract")]
    else:
        store = JStore.create(root, JExperiment(name="ing", plates=[], channels=[],
                                                site_height=1, site_width=1))
        steps = [j_get_step(name)(store) for name in ("metaconfig", "imextract")]
    results = []
    for step, step_args in zip(steps, (args, {"batch_size": 5})):
        step.init(dict(step_args))
        results += [step.run(i) for i in step.list_batches()]
        step.collect()
    return results


def assert_same_ingest(ref_root, port_root):
    for name in ("manifest.json",):
        assert (port_root / name).read_text() == (ref_root / name).read_text()
    for name in ("file_mapping.json", "experiment.ome.xml"):
        want = (ref_root / "workflow" / "metaconfig" / name).read_text()
        assert (port_root / "workflow" / "metaconfig" / name).read_text() == want, name
    planes = sorted(p.name for p in (ref_root / "images").glob("*.npy"))
    assert planes and planes == sorted(p.name for p in (port_root / "images").glob("*.npy"))
    for name in planes:
        want = np.load(ref_root / "images" / name)
        got = np.load(port_root / "images" / name)
        assert got.dtype == want.dtype == np.uint16
        np.testing.assert_array_equal(got, want, err_msg=name)
    return planes


@pytest.mark.parametrize("case", sorted(SOURCES))
def test_both_ingests_write_equal_stores(tmp_path, case):
    src = tmp_path / "src"
    src.mkdir()
    args = {"source_dir": str(src), **SOURCES[case](src)}
    ref = ingest(tmp_path / "ref", args, port=False)
    port = ingest(tmp_path / "port", args, port=True)
    assert port == ref
    planes = assert_same_ingest(tmp_path / "ref", tmp_path / "port")
    store = ExperimentStore.open(tmp_path / "port")
    assert ref[0]["n_files"] == sum(r["n_written"] for r in ref[1:]) > 0
    if case.startswith("default"):
        assert store.experiment.n_sites == 16 and len(planes) == 2
        assert store.read_sites(None, channel=0).max() > 0


def test_a_container_in_the_source_directory_raises(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    default_dir(src, ".tif")
    (src / "B03_plate.nd2").write_bytes(b"\xda\xce\xbe\x0a" + bytes(60))
    # an unreadable .nd2 is skipped and counted: the nd2 handler named
    # alone then raises, auto falls back to the filenames, as in the reference
    with pytest.raises(MetadataError, match="'nd2' sidecar files exist"):
        ingest(tmp_path / "p_nd2", {"source_dir": str(src), "handler": "nd2"}, port=True)
    with pytest.raises(Exception, match="'nd2' sidecar files exist"):
        ingest(tmp_path / "r_nd2", {"source_dir": str(src), "handler": "nd2"}, port=False)
    assert ingest(tmp_path / "p_auto", {"source_dir": str(src), "handler": "auto"},
                  port=True) == \
        ingest(tmp_path / "r_auto", {"source_dir": str(src), "handler": "auto"}, port=False)
    assert_same_ingest(tmp_path / "r_auto", tmp_path / "p_auto")
    # the default filename handler does not look at containers
    ingest(tmp_path / "p_default", {"source_dir": str(src)}, port=True)
    for suffix, name in ((".czi", "czi"), (".r3d", "dv"), (".oib", "olympus"),
                         (".flex", "flex"), (".lsm", "lsm"), (".ims", "ims")):
        other = tmp_path / f"src{suffix}"
        other.mkdir()
        (other / f"A01{suffix}").write_bytes(bytes(16))
        assert vendors.SIDECAR_HANDLERS[name](other) == \
            j_vendors.SIDECAR_HANDLERS[name](other) == ([], 1)
    # an unreadable Imaris .ims (the port reads HDF5 now) fails auto as in the reference
    ims = tmp_path / "src_ims"
    ims.mkdir()
    (ims / "A01.ims").write_bytes(bytes(16))
    with pytest.raises(MetadataError) as got:
        ingest(tmp_path / "p_ims", {"source_dir": str(ims), "handler": "auto"}, port=True)
    with pytest.raises(Exception) as want:
        ingest(tmp_path / "r_ims", {"source_dir": str(ims), "handler": "auto"}, port=False)
    assert str(got.value) == str(want.value).replace(str(tmp_path / "r_ims"),
                                                     str(tmp_path / "p_ims"))
    zarr = tmp_path / "ngff" / "plate.zarr"
    zarr.mkdir(parents=True)
    assert vendors.SIDECAR_HANDLERS["ngff"](zarr.parent) is None  # no .zattrs: not a plate
    (zarr / ".zattrs").write_text("{}")
    # OME-NGFF is read (tmlibrary_tpu_torch/ngff.py): a .zattrs with no plate
    # or multiscales metadata is an unreadable plate, skipped as the
    # reference skips it (test_torch_export.py holds real plates)
    assert vendors.SIDECAR_HANDLERS["ngff"](zarr.parent) == \
        j_vendors.SIDECAR_HANDLERS["ngff"](zarr.parent) == ([], 1)


def test_the_sidecar_registry_and_policy_equal_the_reference(tmp_path):
    assert list(vendors.SIDECAR_HANDLERS) == list(j_vendors.SIDECAR_HANDLERS)
    empty = tmp_path / "empty"
    empty.mkdir()
    for name, handler in vendors.SIDECAR_HANDLERS.items():
        assert handler(empty) is None, name
    assert vendors.resolve_sidecars(empty, list(vendors.SIDECAR_HANDLERS), True) is None
    # a broken .mlf: auto skips it, a named handler raises
    (empty / "MeasurementData.mlf").write_text("<not xml")
    assert vendors.resolve_sidecars(empty, ["cellvoyager"], True) is None
    with pytest.raises(MetadataError):
        vendors.resolve_sidecars(empty, ["cellvoyager"], False)
    for ys, xs, n in (([0.0, 0.0, 5.0, 5.0], [0.0, 5.0, 0.0, 5.0], 4),
                      ([0.0, 0.004, 0.0], [0.0, 100.0, 200.0], 3),
                      ([0.0, 0.0], [0.0, 0.0], 2)):
        assert vendors.dense_grid(ys, xs, n) == j_vendors.dense_grid(ys, xs, n)
    assert vendors.positions_to_grid([0.0, 0.005, 120.0, 240.0, 239.999]) == \
        j_vendors.positions_to_grid([0.0, 0.005, 120.0, 240.0, 239.999])


def test_the_container_helpers_equal_the_reference(tmp_path):
    for names, n in ((["DAPI", "GFP"], 2), (["a b", "a/b"], 2), (None, 3), (["", "X"], 2)):
        assert vendors.channel_labels(names, n) == j_vendors.channel_labels(names, n)
    paths = [tmp_path / f"{s}.nd2" for s in ("B03_x", "plate", "A02", "other")]
    readable = [(p, None, vendors.parse_well_token(p.stem)) for p in paths]
    assert vendors.assign_container_wells(readable, "ND2") == \
        j_vendors.assign_container_wells(readable, "ND2")
    with pytest.raises(VendorConflictError):
        vendors.assign_container_wells(readable + [(tmp_path / "A02_b.nd2", None, (0, 1))],
                                       "ND2")

    def fake_reader(error):
        class FakeReader:  # the shared scan loop over a reader stand-in
            def __init__(self, path):
                self.path = path

            def __enter__(self):
                if "bad" in self.path.name:
                    raise error("unreadable")
                return self

            def __exit__(self, *exc):
                return False

        return FakeReader

    for p in ("A01_x.fake", "bad.fake", "C02.fake"):
        (tmp_path / p).write_bytes(b"")

    def entries_of(path, dims, well):
        return [vendors._container_entry(path, well, 0, c, 0, 0, c) for c in range(dims)]

    def j_entries_of(path, dims, well):
        return [j_vendors._container_entry(path, well, 0, c, 0, 0, c) for c in range(dims)]

    from tmlibrary_tpu import errors as j_errors

    got = vendors._container_sidecar(tmp_path, ".fake", fake_reader(MetadataError), "FAKE",
                                     lambda r: 2, entries_of)
    want = j_vendors._container_sidecar(tmp_path, ".fake", fake_reader(j_errors.MetadataError),
                                        "FAKE", lambda r: 2, j_entries_of)
    assert got == want and got[1] == 1 and len(got[0]) == 4


def test_ome_xml_round_trips_as_in_the_reference(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    default_dir(src, ".png")
    ingest(tmp_path / "port", {"source_dir": str(src)}, port=True)
    exp = ExperimentStore.open(tmp_path / "port").experiment
    text = write_ome_xml(exp)
    images = parse_ome_xml(text)
    assert len(images) == exp.n_sites
    assert images[0].channel_names == [c.name for c in exp.channels]
    with pytest.raises(MetadataError):
        parse_ome_xml("<broken")


def test_metaconfig_refusals_and_probe(tmp_path):
    store = ExperimentStore.create(tmp_path / "s", Experiment(
        name="x", plates=[], channels=[], site_height=1, site_width=1))
    step = get_step("metaconfig")(store, device="cpu")
    step.init({"source_dir": str(tmp_path / "missing")})
    with pytest.raises(MetadataError, match="not found"):
        step.run(0)
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "A01_s0_DAPI.png").write_bytes(b"not a png")
    step.init({"source_dir": str(tmp_path / "src")})
    with pytest.raises(MetadataError, match="probe"):
        step.run(0)
    shutil.rmtree(tmp_path / "src")
    (tmp_path / "src").mkdir()
    step.init({"source_dir": str(tmp_path / "src"), "handler": "omexml"})
    with pytest.raises(MetadataError, match="OME-XML"):
        step.run(0)
    img = random_site(np.random.default_rng(0), (9, 7), np.uint8)
    cv2.imwrite(str(tmp_path / "p.png"), img)
    cv2.imwrite(str(tmp_path / "p.tif"), img)
    assert metaconfig.probe_shape(str(tmp_path / "p.png")) == \
        metaconfig.probe_shape(str(tmp_path / "p.tif")) == (9, 7)
    with pytest.raises(MetadataError, match="imextract|metaconfig"):
        get_step("imextract")(ExperimentStore.open(tmp_path / "s"), device="cpu").init({})
    assert json.loads(json.dumps(get_step("metaconfig").batch_args.to_schema()))
