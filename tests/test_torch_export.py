"""The road out of the port's store and back in, against the JAX package:
``export`` (Parquet, CSV, GeoJSON with ``--simplify`` and
``--join-features``, site images as TIFF and OME-TIFF, the plate as
OME-NGFF), the NGFF reader and ``ngff`` metaconfig handler, the
``workflow template``/``cleanup`` verbs, Douglas-Peucker
simplification and the INI settings.

One store is written by the port's corilla -> align -> jterator on the
CPU (``as_polygons``); both packages' ``export`` verbs read that same
store, and their outputs are held under pandas (tables), as parsed JSON
(GeoJSON), pixel for pixel (TIFF) and byte for byte (OME-TIFF, NGFF).
"""

from __future__ import annotations

import contextlib
import io
import json
import shutil
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

from test_torch_workflow_steps import JTERATOR, make_store, run_steps
from tmlibrary_tpu import cli as jcli
from tmlibrary_tpu import config as j_config
from tmlibrary_tpu import native as j_native
from tmlibrary_tpu import ngff as j_ngff
from tmlibrary_tpu.models.store import ExperimentStore as JStore
from tmlibrary_tpu.workflow.steps import vendors as j_vendors
from tmlibrary_tpu_torch import capacity, cli, config, native, ngff
from tmlibrary_tpu_torch.errors import MetadataError, NotSupportedError
from tmlibrary_tpu_torch.models.mapobject import MapobjectTypeRegistry
from tmlibrary_tpu_torch.models.store import ExperimentStore
from tmlibrary_tpu_torch.ops import image_ops
from tmlibrary_tpu_torch.readers import read_container_plane, read_tiff_page_py
from tmlibrary_tpu_torch.workflow import get_step
from tmlibrary_tpu_torch.workflow.engine import WorkflowDescription
from tmlibrary_tpu_torch.workflow.steps import vendors

torch.set_num_threads(1)


def run(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    base = tmp_path_factory.mktemp("export")
    st = make_store(base / "store")
    capacity.reset_routing_history()
    run_steps(get_step, st, {**JTERATOR, "as_polygons": True}, device="cpu", sequential=True)
    capacity.reset_routing_history()
    return st


def both(store, tmp_path, argv, name):
    """``export`` of both packages over the store; their output paths."""
    outs = {}
    for main, who, extra in ((cli.main, "port", ["--device", "cpu"]), (jcli.main, "ref", [])):
        out = tmp_path / who / name
        rc, text = run(main, ["export", "--root", str(store.root), *argv, "--out", str(out),
                              *extra])
        assert rc == 0, (who, text)
        outs[who] = (out, text.replace(str(out), "<out>"))
    assert outs["port"][1] == outs["ref"][1]
    return outs["port"][0], outs["ref"][0]


# ------------------------------------------------------------------ tables
@pytest.mark.parametrize("suffix", [".parquet", ".csv"])
def test_feature_tables_equal_the_reference(store, tmp_path, suffix):
    for objects in ("nuclei", "cells"):
        port, ref = both(store, tmp_path, ["--objects", objects], objects + suffix)
        read = pd.read_parquet if suffix == ".parquet" else pd.read_csv
        pd.testing.assert_frame_equal(read(port), read(ref))
        assert len(read(port)) > 0
        if suffix == ".csv":
            assert port.read_text() == ref.read_text()


@pytest.mark.parametrize("simplify", ["0", "1.0", "2.5"])
@pytest.mark.parametrize("join", [None, "Intensity_mean_DAPI,Intensity_max_DAPI"])
def test_geojson_equals_the_reference(store, tmp_path, simplify, join):
    argv = ["--objects", "nuclei", "--simplify", simplify]
    if join:
        argv += ["--join-features", join]
    port, ref = both(store, tmp_path, argv, "nuclei.geojson")
    got, want = json.loads(port.read_text()), json.loads(ref.read_text())
    assert got == want and len(got["features"]) > 0
    if join:
        assert {"Intensity_mean_DAPI", "Intensity_max_DAPI"} <= set(
            got["features"][0]["properties"])


def test_geojson_errors_match_the_reference(store, tmp_path):
    for argv in (["--objects", "nuclei", "--join-features", "label"],
                 ["--objects", "nuclei", "--join-features", "nope"],
                 ["--objects", "nothing", "--format", "geojson"],
                 ["--objects", "nuclei", "--images", "0"], []):
        rcs = []
        for main, extra in ((cli.main, ["--device", "cpu"]), (jcli.main, [])):
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc, _ = run(main, ["export", "--root", str(store.root), *argv, "--out",
                                   str(tmp_path / "x.geojson"), *extra])
            rcs.append((rc, err.getvalue()))
        assert rcs[0] == rcs[1] and rcs[0][0] == 1, rcs


def test_illumstats_export_is_refused_by_name(store, tmp_path, capsys):
    assert cli.main(["export", "--root", str(store.root), "--illumstats", "0", "--out",
                     str(tmp_path / "s.h5"), "--device", "cpu"]) == 1
    assert "h5py" in capsys.readouterr().err
    with pytest.raises(NotSupportedError, match="ROADMAP A item 12b"):
        cli.cmd_export(cli.build_parser().parse_args(
            ["export", "--root", str(store.root), "--illumstats", "0", "--out",
             str(tmp_path / "s.h5")]))


# ------------------------------------------------------------------ images
@pytest.mark.parametrize("argv", [["--images", "0"], ["--images", "1", "--cycle", "1"],
                                  ["--images", "0", "--cycle", "1", "--align"]],
                         ids=["plain", "cycle1", "aligned"])
def test_site_images_equal_the_reference(store, tmp_path, argv):
    port, ref = both(store, tmp_path, argv, "images")
    names = sorted(p.name for p in port.iterdir())
    assert names == sorted(p.name for p in ref.iterdir()) and len(names) == store.n_sites
    for name in names:
        a = read_tiff_page_py(port / name, 0)
        assert a.dtype == np.uint16
        np.testing.assert_array_equal(a, read_tiff_page_py(ref / name, 0), err_msg=name)
    if "--align" not in argv:
        channel, cycle = int(argv[1]), (int(argv[3]) if len(argv) > 3 else 0)
        np.testing.assert_array_equal(read_tiff_page_py(port / names[0], 0),
                                      store.read_sites([0], cycle=cycle, channel=channel)[0])


def test_ome_tiffs_are_byte_identical(store, tmp_path):
    port, ref = both(store, tmp_path, ["--images", "1", "--ome"], "ome")
    for p in sorted(port.iterdir()):
        assert p.read_bytes() == (ref / p.name).read_bytes(), p.name


def test_corrected_images_follow_the_port_correction(store, tmp_path):
    """``--correct`` applies the port's float64 correction (ROADMAP C):
    exact against the port's own chain, within one grey level of the
    reference's float32 correction."""
    port, ref = both(store, tmp_path, ["--images", "0", "--correct"], "corrected")
    stats = store.read_illumstats(0, 0)
    prep = image_ops.make_batch_prep(torch.as_tensor(stats["mean_log"]),
                                     torch.as_tensor(stats["std_log"]), None, apply_shift=False)
    want = prep(torch.as_tensor(store.read_sites(None, channel=0).astype(np.int32)),
                torch.zeros((store.n_sites, 2), dtype=torch.int32)).numpy()
    names = sorted(p.name for p in port.iterdir())
    # sites in canonical order: the file names sort as the sites do here
    for name in names:
        a = read_tiff_page_py(port / name, 0).astype(np.int64)
        b = read_tiff_page_py(ref / name, 0).astype(np.int64)
        assert np.abs(a - b).max() <= 1, name
    got = np.stack([read_tiff_page_py(port / n, 0) for n in names])
    assert sorted(np.clip(want, 0, 65535).astype(np.uint16).tolist()) == sorted(got.tolist())


# -------------------------------------------------------------------- NGFF
@pytest.fixture(scope="module")
def plates(store, tmp_path_factory):
    base = tmp_path_factory.mktemp("ngff")
    port, ref = both(store, base, ["--ngff", "--ngff-levels", "3", "--ngff-labels",
                                   "nuclei,cells"], "wf.zarr")
    return port, ref


def test_ngff_plate_is_byte_identical(plates):
    port, ref = plates
    files = sorted(p.relative_to(port) for p in port.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    assert any(f.parts[-1] == "0.0.0.0.0" for f in files)
    for f in files:
        assert (port / f).read_bytes() == (ref / f).read_bytes(), f


@pytest.mark.parametrize("compressor", [None, "zlib"])
def test_zarr_arrays_are_byte_identical(tmp_path, compressor):
    a = np.random.default_rng(3).integers(0, 2**16, (1, 2, 1, 70, 45)).astype(np.uint16)
    ngff.zarr_write_array(tmp_path / "p", a, (1, 1, 1, 32, 32), compressor)
    j_ngff.zarr_write_array(tmp_path / "r", a, (1, 1, 1, 32, 32), compressor)
    for f in sorted((tmp_path / "p").iterdir()):
        assert f.read_bytes() == (tmp_path / "r" / f.name).read_bytes()
    np.testing.assert_array_equal(ngff.zarr_read_array(tmp_path / "p"), a)
    np.testing.assert_array_equal(ngff.zarr_read_plane(tmp_path / "p", 0, 1, 0), a[0, 1, 0])
    for plane in (np.arange(35, dtype=np.uint16).reshape(5, 7), np.ones((6, 4), np.int32)):
        np.testing.assert_array_equal(ngff._downsample_2x(plane), j_ngff._downsample_2x(plane))


def _reader_state(r) -> dict:
    return {k: getattr(r, k) for k in (
        "is_plate", "well_paths", "well_indices", "fields_per_well", "field_paths",
        "level0_names", "channel_names", "n_fields", "n_tpoints", "n_channels", "n_zplanes",
        "height", "width", "n_wells")}


def test_ngff_reader_and_sidecar_match_the_reference(plates, store, tmp_path):
    port, _ = plates
    with ngff.NGFFReader(port) as r, j_ngff.NGFFReader(port) as j:
        assert _reader_state(r) == _reader_state(j)
        for page in (0, 1, 7, r.n_wells * r.n_fields * r.n_channels - 1):
            np.testing.assert_array_equal(r.read_plane_linear(page), j.read_plane_linear(page))
            np.testing.assert_array_equal(read_container_plane(port, page),
                                          r.read_plane_linear(page))
    # a bare multiscale image (one field) beside the plate
    src = tmp_path / "src"
    shutil.copytree(port, src / "plate.zarr")
    shutil.copytree(port / "A" / "1" / "0", src / "B02_image.zarr")
    got, want = vendors.ngff_sidecar(src), j_vendors.ngff_sidecar(src)
    assert got == want and len(got[0]) == 2 * (store.n_sites + 1)
    with ngff.NGFFReader(src / "B02_image.zarr") as r, \
            j_ngff.NGFFReader(src / "B02_image.zarr") as j:
        assert _reader_state(r) == _reader_state(j) and not r.is_plate
    (src / "broken.zarr").mkdir()
    (src / "broken.zarr" / ".zattrs").write_text("{}")
    assert vendors.ngff_sidecar(src) == j_vendors.ngff_sidecar(src)
    with pytest.raises(MetadataError):
        ngff.NGFFReader(src / "broken.zarr").__enter__()


def test_ngff_plate_reingests_pixel_equal(plates, store, tmp_path):
    port, _ = plates
    src = tmp_path / "src"
    shutil.copytree(port, src / "wf.zarr")
    fresh = tmp_path / "fresh"
    assert cli.main(["create", "--root", str(fresh), "--name", "again"]) == 0
    WorkflowDescription.canonical({
        "metaconfig": {"source_dir": str(src), "handler": "ngff", "sites_per_well_x": 2},
        "imextract": {}}).save(fresh / "workflow" / "workflow.yaml")
    assert cli.main(["workflow", "submit", "--root", str(fresh), "--device", "cpu"]) == 0
    again = ExperimentStore.open(fresh)
    assert again.n_sites == store.n_sites
    names = [c.name for c in again.experiment.channels]
    for c, ch in enumerate(store.experiment.channels):
        np.testing.assert_array_equal(again.read_sites(None, channel=names.index(ch.name)),
                                      store.read_sites(None, channel=c))
    assert [(r.well_row, r.well_column, r.site_y, r.site_x) for r in again.experiment.sites()] \
        == [(r.well_row, r.well_column, r.site_y, r.site_x) for r in store.experiment.sites()]


def test_other_containers_stay_refused(tmp_path):
    # Imaris .ims (HDF5) stays refused by name; an ND2 reads as in the reference
    (tmp_path / "a.ims").write_bytes(b"\0" * 16)
    with pytest.raises(NotSupportedError, match="ROADMAP A item 12b"):
        read_container_plane(tmp_path / "a.ims", 0)
    with pytest.raises(NotSupportedError, match="ROADMAP A item 12b"):
        vendors.SIDECAR_HANDLERS["ims"](tmp_path)
    from tmlibrary_tpu.readers import read_container_plane as j_read_container_plane
    from tmlibrary_tpu_torch.container_writers import write_nd2

    planes = np.random.default_rng(3).integers(0, 60000, (2, 8, 6, 2), dtype=np.uint16)
    write_nd2(tmp_path / "A01.nd2", planes)
    for page in range(4):
        got = read_container_plane(tmp_path / "A01.nd2", page)
        np.testing.assert_array_equal(got, planes[page // 2, :, :, page % 2])
        np.testing.assert_array_equal(got, j_read_container_plane(tmp_path / "A01.nd2", page))
    assert vendors.SIDECAR_HANDLERS["nd2"](tmp_path) == \
        j_vendors.SIDECAR_HANDLERS["nd2"](tmp_path)


def test_ngff_export_refuses_missing_labels(store, tmp_path):
    with pytest.raises(MetadataError, match="no segmentation stack named 'nope'"):
        ngff.write_ngff_plate(store, tmp_path / "x.zarr", label_names=["nope"])
    assert not (tmp_path / "x.zarr").exists()


# ---------------------------------------------------- workflow template/cleanup
def test_workflow_template_and_cleanup_match_the_reference(store, tmp_path):
    roots = {}
    for who in ("port", "ref"):
        roots[who] = tmp_path / who
        shutil.copytree(store.root, roots[who])
    outs = {}
    for main, who, extra in ((cli.main, "port", ["--device", "cpu"]), (jcli.main, "ref", [])):
        root = str(roots[who])
        steps = [run(main, ["workflow", "template", "--root", root, "--type", "multiplexing",
                            *extra]),
                 run(main, ["workflow", "template", "--root", root, *extra]),
                 run(main, ["jterator", "cleanup", "--root", root, *extra]),
                 run(main, ["workflow", "cleanup", "--root", root, *extra])]
        outs[who] = [(rc, text.replace(root, "<root>")) for rc, text in steps]
    assert outs["port"] == outs["ref"]
    assert [rc for rc, _ in outs["port"]] == [0, 1, 0, 0]
    trees = {who: sorted(str(p.relative_to(r)) for p in r.rglob("*") if p.is_file())
             for who, r in roots.items()}
    assert trees["port"] == trees["ref"]
    port = roots["port"]
    assert (port / "workflow" / "workflow.yaml").read_bytes() == \
        (roots["ref"] / "workflow" / "workflow.yaml").read_bytes()
    assert not list((port / "segmentations").iterdir())
    assert not list((port / "features").iterdir())
    assert not list((port / "workflow").rglob("batch_*.json"))
    assert not (port / "workflow" / "ledger.jsonl").exists()
    assert MapobjectTypeRegistry(port).names() == []


def test_submit_reads_the_store_workflow_yaml(store, tmp_path, capsys):
    root = tmp_path / "s"
    shutil.copytree(store.root, root)
    assert cli.main(["workflow", "submit", "--root", str(root), "--device", "cpu"]) == 1
    assert "workflow.yaml" in capsys.readouterr().err
    WorkflowDescription.canonical({"jterator": {**JTERATOR, "pipe": "raw.pipe.json"}}).save(
        root / "workflow" / "workflow.yaml")
    assert cli.main(["workflow", "submit", "--root", str(root), "--device", "cpu"]) == 0
    assert "jterator" in json.loads(capsys.readouterr().out)


# ---------------------------------------------------------------- simplify
@pytest.mark.parametrize("seed", range(6))
def test_simplify_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n = int(rng.integers(0, 80))
        if rng.random() < 0.5:  # a ring: points round a noisy circle
            t = np.sort(rng.random(n)) * 2 * np.pi
            r = 20 + rng.normal(0, 2, n)
            contour = np.stack([30 + r * np.sin(t), 30 + r * np.cos(t)], 1).round()
        else:
            contour = rng.integers(0, 40, (n, 2))
        contour = contour.astype(np.int32)
        for tol in (0.0, 0.5, 1.0, 2.5, 100.0):
            got = native.simplify_polygon_host(contour, tol)
            np.testing.assert_array_equal(got, j_native.simplify_polygon_host(contour, tol))
            if n:
                np.testing.assert_array_equal(native.simplify_keep(contour, tol),
                                              native.simplify_keep_numpy(contour, tol))
    line = np.stack([np.arange(10), np.zeros(10)], 1).astype(np.int32)
    np.testing.assert_array_equal(native.simplify_polygon_host(line, 5.0), line)


# ----------------------------------------------------------------- settings
@pytest.mark.parametrize("env,ini,want", [
    (None, None, ("3", "0.25")),
    (None, "[tmlibrary]\nretry_attempts = 7\nretry_base_delay = 1.5\n", ("7", "1.5")),
    ("9", "[tmlibrary]\nretry_attempts = 7\n", ("9", "0.25")),
    (None, "[other]\nretry_attempts = 7\n", ("3", "0.25")),
    (None, "[tmlibrary]\nretry_attempts = 7%\n", ("7%", "0.25")),
])
def test_settings_follow_the_reference_precedence(monkeypatch, tmp_path, env, ini, want):
    path = tmp_path / "tm.cfg"
    if ini is not None:
        path.write_text(ini)
    monkeypatch.setenv("TM_CONFIG_FILE", str(path))
    if env is None:
        monkeypatch.delenv("TM_RETRY_ATTEMPTS", raising=False)
    else:
        monkeypatch.setenv("TM_RETRY_ATTEMPTS", env)
    monkeypatch.delenv("TM_RETRY_BASE_DELAY", raising=False)
    for name, default in (("retry_attempts", "3"), ("retry_base_delay", "0.25")):
        assert config.setting(name, default) == j_config._setting(name, default)
    assert (config.setting("retry_attempts", "3"),
            config.setting("retry_base_delay", "0.25")) == want
    if want[0].isdigit():
        cfg = config.LibraryConfig()
        assert (cfg.retry_attempts, cfg.retry_base_delay) == (int(want[0]), float(want[1]))


def test_a_malformed_ini_warns_and_reads_the_defaults(monkeypatch, tmp_path):
    path = tmp_path / "bad.cfg"
    path.write_text("retry_attempts = 7\n[tmlibrary\n")
    monkeypatch.setenv("TM_CONFIG_FILE", str(path))
    monkeypatch.delenv("TM_RETRY_ATTEMPTS", raising=False)
    with pytest.warns(UserWarning, match="malformed config file"):
        assert config.setting("retry_attempts", "3") == "3"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert j_config._setting("retry_attempts", "3") == "3"
    monkeypatch.setenv("TM_CONFIG_FILE", str(tmp_path / "absent.cfg"))
    assert config.LibraryConfig().retry_attempts == 3
