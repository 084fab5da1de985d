"""Ingest of microscope containers: the port's metaconfig handlers,
imextract and ``inspect`` against the JAX package's.

For each container format (ND2 with an XY loop on a 2x2 stage grid, CZI
with a 2x2 mosaic scene, LIF, DV/R3D, STK, LSM, OIB/OIF and Opera FLEX
with numeric well names), a source tree written by the reference tests'
writers, with one unreadable file among the readable ones, goes through
both packages' handler (named and ``auto``), metaconfig and imextract:
the handler's entries and skipped count, the step results, the
manifests, ``file_mapping.json``, ``experiment.ome.xml`` and every
stored plane are equal.  ``inspect --json`` prints the same objects for
every file and directory, and exits with the same code.  The ingest
bench's ``TMX_INGEST_WORKERS`` and ``TMX_INGEST_THROTTLE_MS`` are parsed
as in the reference.  Tolerance: exact.
"""

import contextlib
import io
import json

import numpy as np
import pytest

import test_czi
import test_dv
import test_flex
import test_lif
import test_lsm
import test_nd2
import test_oib
import test_stk
from test_torch_ingest import assert_same_ingest, ingest
from tmlibrary_tpu import cli as jcli
from tmlibrary_tpu.workflow.steps import vendors as j_vendors
from tmlibrary_tpu_torch import cli, container_writers
from tmlibrary_tpu_torch.workflow.steps import imextract, vendors


def rand(shape, seed, high=4000, dtype=np.uint16):
    return np.random.default_rng(seed).integers(0, high, shape).astype(dtype)


def nd2_tree(src):
    points = [(0.0, 0.0), (0.0, 100.0), (80.0, 0.0), (80.0, 100.0)]
    for i, well in enumerate(("A01", "B02")):
        test_nd2.write_nd2(src / f"plate_{well}.nd2", rand((4, 12, 10, 2), i),
                           loops=[(2, 4, points)], channel_names=["DAPI", "Actin"])
    (src / "broken_C03.nd2").write_bytes(b"\xda\xce\xbe\x0a" + bytes(60))
    return "nd2"


def czi_tree(src):
    test_czi.write_czi(src / "scan_A01.czi", rand((4, 2, 12, 10), 2), n_tiles=4,
                       tile_origins=[(0, 0), (0, 10), (12, 0), (12, 10)],
                       channel_names=["DAPI", "GFP"])
    test_czi.write_czi(src / "scan_B01.czi", rand((4, 2, 12, 10), 3), n_tiles=4,
                       tile_origins=[(0, 0), (0, 10), (12, 0), (12, 10)],
                       channel_names=["DAPI", "GFP"])
    (src / "empty.czi").write_bytes(b"ZISRAWFILE")
    return "czi"


def lif_tree(src):
    test_lif.write_lif(src / "A01.lif", [rand((2, 2, 1, 12, 10), 4), rand((2, 2, 1, 12, 10), 5)],
                       lut_names=["Blue", "Red"])
    test_lif.write_lif(src / "nowell.lif", [rand((2, 2, 1, 12, 10), 6)])
    (src / "bad.lif").write_bytes(bytes(20))
    return "lif"


def dv_tree(src):
    test_dv.write_dv(src / "A01.dv", rand((2, 2, 2, 12, 10), 7))
    test_dv.write_dv(src / "A02.r3d", rand((2, 2, 2, 12, 10), 8), sequence=1, byte_order=">")
    test_dv.write_dv(src / "A03.dv", rand((2, 2, 2, 12, 10), 9), declare_sections=9)
    return "dv"


def stk_tree(src):
    test_stk.write_stk(src / "A01.stk", rand((3, 12, 10), 10))
    test_stk.write_stk(src / "A02.stk", rand((3, 12, 10), 11), paged=True)
    test_stk._write_rgb_stk(src / "A03.stk")  # declined: skipped by the handler
    return "stk"


def lsm_tree(src):
    test_lsm.write_lsm(src / "A01.lsm", rand((2, 2, 2, 12, 10), 12))
    test_lsm.write_lsm(src / "B01.lsm", rand((2, 2, 2, 12, 10), 13), compression=5,
                       predictor=2)
    test_lsm.write_lsm(src / "C01.lsm", rand((2, 2, 2, 12, 10), 14), declare_z=3)
    return "lsm"


def olympus_tree(src):
    test_oib.write_oib(src / "A01.oib", rand((2, 2, 2, 16, 20), 15))
    test_oib.write_oif(src, "B01", rand((2, 2, 2, 16, 20), 16))
    (src / "C01.oib").write_bytes(b"\xd0\xcf\x11\xe0" + bytes(600))
    return "olympus"


def flex_tree(src):
    test_flex.write_flex(src / "001001000.flex", rand((4, 12, 14), 17),
                         channel_names=("DAPI", "GFP"))
    test_flex.write_flex(src / "002003000.flex", rand((4, 12, 14), 18),
                         channel_names=("DAPI", "GFP"))
    (src / "003003000.flex").write_bytes(b"II*\0" + bytes(8))
    return "flex"


TREES = {"nd2": nd2_tree, "czi": czi_tree, "lif": lif_tree, "dv": dv_tree, "stk": stk_tree,
         "lsm": lsm_tree, "olympus": olympus_tree, "flex": flex_tree}


@pytest.mark.parametrize("fmt", sorted(TREES))
@pytest.mark.parametrize("mode", ["named", "auto"])
def test_both_packages_ingest_a_container_tree_alike(tmp_path, fmt, mode):
    src = tmp_path / "src"
    src.mkdir()
    handler = TREES[fmt](src)
    got = vendors.SIDECAR_HANDLERS[handler](src)
    assert got == j_vendors.SIDECAR_HANDLERS[handler](src)
    assert got[1] == 1 and got[0]  # one unreadable file skipped and counted
    names = list(vendors.SIDECAR_HANDLERS)
    assert vendors.resolve_sidecars(src, names, True) == \
        j_vendors.resolve_sidecars(src, names, True)
    args = {"source_dir": str(src), "handler": handler if mode == "named" else "auto"}
    ref = ingest(tmp_path / "ref", args, port=False)
    assert ingest(tmp_path / "port", args, port=True) == ref
    assert_same_ingest(tmp_path / "ref", tmp_path / "port")


def test_mosaic_and_stage_grids_become_site_coordinates(tmp_path):
    for tree in (nd2_tree, czi_tree):
        src = tmp_path / tree.__name__
        src.mkdir()
        entries, _ = vendors.SIDECAR_HANDLERS[tree(src)](src)
        grid = {(e["well_row"], e["well_col"], e["site"]): (e["site_y"], e["site_x"])
                for e in entries}
        assert sorted(set(grid.values())) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def run_inspect(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, [json.loads(line) for line in out.getvalue().splitlines()]


def test_inspect_prints_what_the_reference_prints(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    paths = []
    for fmt, tree in sorted(TREES.items()):
        sub = src / fmt
        sub.mkdir()
        tree(sub)
        # the colour STK is left out: the reference's cv2 reads it as grey,
        # the port's TIFF path reads grey TIFFs only (an error, below)
        paths += sorted(str(p) for p in sub.iterdir()
                        if not p.name.endswith(".files") and p.name != "A03.stk")
        paths.append(str(sub))
    container_writers.write_packbits_stk(src / "declined.stk", rand((8, 6), 19))
    paths += [str(src / "declined.stk"), str(tmp_path / "missing.nd2")]
    rc, got = run_inspect(cli.main, ["inspect", "--json", *paths])
    want_rc, want = run_inspect(jcli.main, ["inspect", "--json", *paths])
    assert rc == want_rc == 1  # the unreadable files
    assert [g.keys() for g in got] == [w.keys() for w in want]
    for g, w in zip(got, want):
        if "error" in w:  # each package words its own error
            assert "error" in g
            g.pop("error"), w.pop("error")
        assert g == w
    by_file = {g["file"]: g for g in got}
    nd2 = by_file[str(src / "nd2" / "plate_A01.nd2")]
    assert (nd2["format"], nd2["loops"], nd2["channel_names"]) == \
        ("ND2", [["XY", 4]], ["DAPI", "Actin"])
    assert by_file[str(src / "flex")]["handler"] == "flex"
    assert by_file[str(src / "declined.stk")]["format"] == "image"
    rc, (rgb,) = run_inspect(cli.main, ["inspect", "--json", str(src / "stk" / "A03.stk")])
    assert rc == 1 and "no reader of the port" in rgb["error"]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        assert cli.main(["inspect", str(src / "czi" / "scan_A01.czi"), str(src / "czi")]) == 0
    assert "n_tiles" in text.getvalue() and "handler=czi" in text.getvalue()


def test_ingest_pool_variables_parse_as_in_the_reference(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    nd2_tree(src)
    seen = []
    real = imextract.cf.ThreadPoolExecutor

    def pool(max_workers):
        seen.append(max_workers)
        return real(max_workers=max_workers)

    monkeypatch.setattr(imextract.cf, "ThreadPoolExecutor", pool)
    default = max(4, min(8, __import__("os").cpu_count() or 1))
    for value, want in (("1", 1), ("3", 3), ("0", default), ("x", default), ("", default)):
        monkeypatch.setenv("TMX_INGEST_WORKERS", value)
        monkeypatch.setenv("TMX_INGEST_THROTTLE_MS", "1")
        seen.clear()
        ingest(tmp_path / f"p{value or 'empty'}", {"source_dir": str(src), "handler": "nd2"},
               port=True)
        assert set(seen) == {want}, value
    monkeypatch.setenv("TMX_INGEST_THROTTLE_MS", "not a number")
    with pytest.raises(ValueError):
        imextract.ImageExtractor._read_plane(str(src / "plate_A01.nd2"), 0, 12, 10)
