"""The port's microscope container readers against the JAX package's.

Each fixture is written by the JAX package's reader tests' own writers
(``tests/test_{nd2,czi,lif,dv,stk,lsm,oib,flex}.py``) and read by both
packages: every attribute, channel name, ND2 loop shape, stage position
and sequence coordinate, CZI tile origin, LIF series, and every plane
by its linear page index (``readers._container_plane``) are equal, with
dtype.  The page formulas are held against the written arrays, the
port's writer copies (:mod:`tmlibrary_tpu_torch.container_writers`)
write the same bytes as the writers they copy, and the mutated inputs
of ``tests/test_reader_fuzz.py`` give the same outcome (the planes, or
the error class) in both packages.  CZI JPEG and zstd subblocks and
Imaris ``.ims`` read as in the JAX package through the port's own
codecs and HDF5 subset (their deeper tests: ``test_torch_zstd.py``,
``test_torch_jpeg.py``, ``test_torch_hdf5.py``); a TIFF-flavoured
container that its reader declines goes to the TIFF path in both.
Tolerance: exact everywhere.
"""

import numpy as np
import pytest

import test_czi
import test_dv
import test_flex
import test_ims
import test_lif
import test_lsm
import test_nd2
import test_oib
import test_stk
from tmlibrary_tpu import errors as j_errors
from tmlibrary_tpu import readers as j_readers
from tmlibrary_tpu_torch import container_writers as cw
from tmlibrary_tpu_torch import readers
from tmlibrary_tpu_torch.errors import MetadataError, NotSupportedError

ATTRS = ("height", "width", "n_channels", "n_zplanes", "n_tpoints", "n_series", "n_scenes",
         "n_tiles", "n_sequences", "n_components", "n_fields")


def rand(shape, seed, high=60000, dtype=np.uint16):
    return np.random.default_rng(seed).integers(0, high, shape).astype(dtype)


ND2_POINTS = [(0.0, 0.0), (0.0, 50.0), (40.0, 0.0), (40.0, 50.0)]

#: name -> (reference writer, port writer, suffix, data, keyword arguments),
#: the fixtures of the reference tests at 64² or less
CASES = {
    "nd2_flat": (test_nd2.write_nd2, cw.write_nd2, ".nd2", rand((3, 12, 10, 2), 1), {}),
    "nd2_loops": (test_nd2.write_nd2, cw.write_nd2, ".nd2", rand((8, 12, 10, 2), 2),
                  {"loops": [(1, 2), (2, 4, ND2_POINTS)], "channel_names": ["DAPI", "GFP"],
                   "timestamps": [5.0 * i for i in range(8)]}),
    "nd2_zt_loops": (test_nd2.write_nd2, cw.write_nd2, ".nd2", rand((12, 8, 9, 1), 3),
                     {"loops": [(2, 2), (4, 3), (1, 2)]}),
    "nd2_lossless": (test_nd2.write_nd2, cw.write_nd2, ".nd2", rand((3, 8, 9, 2), 4),
                     {"compression": "lossless"}),
    "nd2_aborted": (test_nd2.write_nd2, cw.write_nd2, ".nd2", rand((3, 8, 9, 1), 5),
                    {"declare_sequences": 5}),
    "czi": (test_czi.write_czi, cw.write_czi, ".czi", rand((2, 3, 12, 10), 6),
            {"channel_names": ["DAPI", "GFP", "Cy5"]}),
    "czi_mosaic": (test_czi.write_czi, cw.write_czi, ".czi", rand((4, 2, 12, 10), 7),
                   {"n_tiles": 4, "tile_origins": [(0, 0), (0, 10), (12, 0), (12, 10)]}),
    "czi_mosaic_global_m": (test_czi.write_czi, cw.write_czi, ".czi", rand((4, 1, 8, 9), 8),
                            {"n_tiles": 2, "global_m": True, "with_pyramid": True}),
    "czi_gray8": (test_czi.write_czi, cw.write_czi, ".czi", rand((2, 1, 12, 14), 9, 255,
                                                               np.uint8), {"pixel_type": 0}),
    "lif": (test_lif.write_lif, cw.write_lif, ".lif",
            [rand((2, 3, 2, 12, 10), 10), rand((2, 3, 2, 12, 10), 11)],
            {"lut_names": ["Blue", "Green"]}),
    "lif_uint8": (test_lif.write_lif, cw.write_lif, ".lif", [rand((1, 2, 1, 8, 9), 12, 255)],
                  {"bits": 8}),
    "dv_ztw_le": (test_dv.write_dv, cw.write_dv, ".dv", rand((2, 3, 2, 12, 10), 13), {}),
    "dv_wzt_be": (test_dv.write_dv, cw.write_dv, ".r3d", rand((2, 3, 2, 12, 10), 14),
                  {"sequence": 1, "byte_order": ">"}),
    "dv_zwt_int16": (test_dv.write_dv, cw.write_dv, ".dv",
                     rand((2, 2, 2, 8, 9), 15, 60000).astype(np.int32) - 30000,
                     {"sequence": 2, "mode": 1}),
    "dv_float": (test_dv.write_dv, cw.write_dv, ".dv",
                 rand((1, 2, 1, 8, 9), 16).astype(np.float32) / 7, {"mode": 2}),
    "stk": (test_stk.write_stk, cw.write_stk, ".stk", rand((4, 12, 10), 17), {}),
    "stk_paged": (test_stk.write_stk, cw.write_stk, ".stk", rand((3, 12, 10), 18),
                  {"paged": True}),
    "stk_8bit": (test_stk.write_stk, cw.write_stk, ".stk", rand((3, 8, 9), 19, 255, np.uint8),
                 {"bits": 8}),
    "lsm": (test_lsm.write_lsm, cw.write_lsm, ".lsm", rand((2, 3, 2, 12, 10), 20), {}),
    "lsm_lzw_predictor": (test_lsm.write_lsm, cw.write_lsm, ".lsm", rand((1, 2, 3, 12, 10), 21),
                          {"compression": 5, "predictor": 2, "thumbnails": False}),
    "oib": (test_oib.write_oib, cw.write_oib, ".oib", rand((2, 3, 2, 16, 20), 22), {}),
    "oib_flat_no_info": (test_oib.write_oib, cw.write_oib, ".oib", rand((2, 1, 1, 8, 9), 23),
                         {"with_info": False, "nested": False}),
    "flex": (test_flex.write_flex, cw.write_flex, ".flex", rand((6, 12, 14), 24),
             {"channel_names": ("Exp1Cam1", "Exp2Cam1")}),
    "flex_no_xml": (test_flex.write_flex, cw.write_flex, ".flex", rand((3, 8, 9), 25),
                    {"xml": None}),
}


def write(case, path, port=True):
    ref_writer, port_writer, _suffix, data, kw = CASES[case]
    (port_writer if port else ref_writer)(path, data, **kw)
    return path


def n_pages(r) -> int:
    n = 1
    for attr in ("n_channels", "n_zplanes", "n_tpoints", "n_fields", "n_scenes", "n_tiles",
                 "n_series", "n_sequences", "n_components"):
        n *= getattr(r, attr, 1) or 1
    if hasattr(r, "uniform_dims"):  # LIF: series x C x Z x T
        n = r.n_series * int(np.prod(r.uniform_dims()))
    return n


def describe(r) -> dict:
    """Everything a reader reports, planes by linear page included."""
    out = {a: getattr(r, a, None) for a in ATTRS}
    names = getattr(r, "channel_names", None)
    out["channel_names"] = names() if callable(names) else names
    if hasattr(r, "loop_shape"):
        out["loops"] = r.loop_shape()
        out["xy"] = r.xy_positions()
        out["coords"] = [r.seq_coords(s) for s in range(r.n_sequences)]
        out["timestamps"] = [r.timestamp(s) for s in range(r.n_sequences)]
    if hasattr(r, "tile_origin"):
        out["origins"] = [r.tile_origin(s, m) for s in range(r.n_scenes)
                          for m in range(r.n_tiles)]
    if hasattr(r, "uniform_dims"):
        out["series"] = r.series
        out["uniform_dims"] = r.uniform_dims()
    module = readers if isinstance(r, readers.Reader) else j_readers
    out["planes"] = [module._container_plane(r, p) for p in range(n_pages(r))]
    return out


def assert_same(got: dict, want: dict):
    planes, want_planes = got.pop("planes"), want.pop("planes")
    assert got == want
    assert len(planes) == len(want_planes) > 0
    for i, (a, b) in enumerate(zip(planes, want_planes)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=f"page {i}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_both_readers_report_the_same_container(tmp_path, case):
    path = write(case, tmp_path / f"A01{CASES[case][2]}", port=False)
    with j_readers._container_reader(path)(path) as want_r:
        want = describe(want_r)
    with readers._container_reader(path)(path) as got_r:
        assert type(got_r).__name__ == type(want_r).__name__
        got = describe(got_r)
    last = len(want["planes"]) - 1
    assert_same(got, want)
    assert readers.container_dimensions(path) == j_readers.container_dimensions(path)
    for page in (0, last):
        np.testing.assert_array_equal(readers.read_container_plane(path, page),
                                      j_readers.read_container_plane(path, page))


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_writer_copy_writes_the_reference_bytes(tmp_path, case):
    ref = write(case, tmp_path / f"ref{CASES[case][2]}", port=False)
    port = write(case, tmp_path / f"port{CASES[case][2]}")
    assert port.read_bytes() == ref.read_bytes()


def test_oif_reads_and_writes_as_the_reference(tmp_path):
    stack = rand((2, 3, 2, 16, 20), 26)
    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    ref = test_oib.write_oif(tmp_path / "r", "A01", stack)
    port = cw.write_oif(tmp_path / "p", "A01", stack)
    assert port.read_bytes() == ref.read_bytes()
    files = sorted(p.name for p in (tmp_path / "r" / "A01.oif.files").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "p" / "A01.oif.files").iterdir())
    for name in files:
        assert (tmp_path / "p" / "A01.oif.files" / name).read_bytes() == \
            (tmp_path / "r" / "A01.oif.files" / name).read_bytes()
    with j_readers.OIFReader(ref) as jr, readers.OIFReader(ref) as pr:
        assert_same(describe(pr), describe(jr))
    for c, z, t in ((0, 0, 0), (1, 2, 1), (0, 1, 1)):
        with readers.OIFReader(port) as r:
            np.testing.assert_array_equal(r.read_plane(c, z, t), stack[c, z, t])


def test_the_page_formulas(tmp_path):
    """Each format's linear page against the written array."""
    nd2 = CASES["nd2_loops"][3]
    with readers.ND2Reader(write("nd2_loops", tmp_path / "a.nd2")) as r:
        for seq in range(8):
            for comp in range(2):
                np.testing.assert_array_equal(readers._container_plane(r, seq * 2 + comp),
                                              nd2[seq, :, :, comp])
        assert [r.seq_coords(s) for s in range(8)] == \
            [(xy, 0, t) for t in range(2) for xy in range(4)]
    czi = CASES["czi_mosaic"][3]  # (S*M, C, H, W), S=1, M=4, Z=T=1
    with readers.CZIReader(write("czi_mosaic", tmp_path / "a.czi")) as r:
        for m in range(4):
            for c in range(2):
                np.testing.assert_array_equal(readers._container_plane(r, m * 2 + c), czi[m, c])
        assert [r.tile_origin(0, m) for m in range(4)] == [(0, 0), (0, 10), (12, 0), (12, 10)]
    lif = CASES["lif"][3]  # series of (C, Z, T, H, W)
    with readers.LIFReader(write("lif", tmp_path / "a.lif")) as r:
        for s in range(2):
            for c in range(2):
                for z in range(3):
                    for t in range(2):
                        page = s * 12 + (c * 3 + z) * 2 + t
                        np.testing.assert_array_equal(readers._container_plane(r, page),
                                                      lif[s][c, z, t])
    for case in ("dv_wzt_be", "lsm", "oib"):
        data = CASES[case][3]
        path = write(case, tmp_path / f"b{CASES[case][2]}")
        with readers._container_reader(path)(path) as r:
            n_c, n_z, n_t = r.n_channels, r.n_zplanes, r.n_tpoints
            for c in range(n_c):
                for z in range(n_z):
                    for t in range(n_t):
                        # DV/OIB arrays are (C, Z, T, H, W), LSM's (T, Z, C, H, W)
                        want = data[t, z, c] if case == "lsm" else data[c, z, t]
                        np.testing.assert_array_equal(
                            readers._container_plane(r, (c * n_z + z) * n_t + t), want)
    flex = CASES["flex"][3]
    with readers.FlexReader(write("flex", tmp_path / "a.flex")) as r:
        for f in range(3):
            for c in range(2):
                np.testing.assert_array_equal(r.read_plane(f, c), flex[f * 2 + c])


# ---------------------------------------------------------------- refusals
@pytest.mark.parametrize("compression, codec", [(1, "JPEG"), (5, "zstd0"), (6, "zstd1")])
def test_codec_compressed_czi_is_refused_naming_item_12b(tmp_path, compression, codec):
    # once refused (ROADMAP A item 12b), now decoded by the port's own codecs:
    # the subblocks the reference's test writer encodes with cv2 and
    # zstandard read as the reference reads them
    planes = rand((1, 1, 16, 16), 27, 255, np.uint8)
    path = tmp_path / "a.czi"
    test_czi.write_czi(path, planes, pixel_type=0, compression=compression)
    with j_readers.CZIReader(path) as r:
        want = r.read_plane(0, 0)
    with readers.CZIReader(path) as r:
        assert (r.n_channels, r.height, r.width) == (1, 16, 16)
        got = r.read_plane(0, 0)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if compression != 1:  # JPEG is lossy
        np.testing.assert_array_equal(got, planes[0, 0])
    np.testing.assert_array_equal(readers.read_container_plane(path, 0), want)


def test_jpeg_xr_czi_raises_as_the_reference(tmp_path):
    path = tmp_path / "jxr.czi"
    test_czi.write_czi(path, rand((1, 1, 8, 8), 28), compression=4)
    with pytest.raises(j_errors.MetadataError) as want:
        with j_readers.CZIReader(path) as r:
            r.read_plane(0, 0)
    with pytest.raises(MetadataError, match=r"compression=4\) are not supported") as got:
        with readers.CZIReader(path) as r:
            r.read_plane(0, 0)
    assert "compression=4) are not supported" in str(want.value)
    assert "12b" not in str(got.value)


def test_imaris_and_hdf5_readers_are_refused_naming_item_12b(tmp_path):
    # once refused (ROADMAP A item 12b), now read through the port's HDF5
    # subset: every page, the dimensions and the datasets as the reference
    path = tmp_path / "a.ims"
    stack = rand((1, 2, 1, 8, 9), 29)
    test_ims.write_ims(path, stack)
    with j_readers.IMSReader(path) as want, readers.IMSReader(path) as got:
        assert {a: getattr(got, a) for a in ATTRS if hasattr(want, a)} == \
            {a: getattr(want, a) for a in ATTRS if hasattr(want, a)}
        for page in range(2):
            np.testing.assert_array_equal(got.read_plane_linear(page),
                                          want.read_plane_linear(page))
    assert readers.container_dimensions(path) == j_readers.container_dimensions(path) == (8, 9)
    np.testing.assert_array_equal(readers.BFImageReader(path).read(1), stack[0, 1, 0])
    data = "DataSet/ResolutionLevel 0/TimePoint 0/Channel 0/Data"
    with readers.DatasetReader(path) as got, j_readers.DatasetReader(path) as want:
        np.testing.assert_array_equal(got.read(data), want.read(data))
        assert got.list_datasets() == want.list_datasets()


def test_a_declined_tiff_flavoured_container_takes_the_tiff_path(tmp_path):
    # a compressed single-IFD STK: the STK reader declines it, the TIFF path reads it
    plane = rand((12, 10), 30)
    path = tmp_path / "declined.stk"
    cw.write_packbits_stk(path, plane)
    with pytest.raises(NotSupportedError):
        readers.STKReader(path).__enter__()
    for mod in (readers, j_readers):
        assert mod.read_container_plane(path, 0) is None
        assert mod.container_dimensions(path) is None
        with mod.ImageReader(path) as r:
            np.testing.assert_array_equal(r.read(0), plane)
    np.testing.assert_array_equal(readers.BFImageReader(path).read(0), plane)
    # a FLEX whose pages differ in size: declined, page 0 read as a TIFF
    flex = tmp_path / "mixed.flex"
    test_flex.write_flex(flex, rand((2, 8, 9), 31), channel_names=("A", "B"))
    blob = bytearray(flex.read_bytes())
    with j_readers.FlexReader(flex) as r:
        second = r._ifds[1][257][2]  # page 1's ImageLength value
    blob[second:second + 2] = (7).to_bytes(2, "little")
    flex.write_bytes(bytes(blob))
    with pytest.raises(NotSupportedError, match="geometry"):
        readers.FlexReader(flex).__enter__()
    for mod in (readers, j_readers):
        assert mod.read_container_plane(flex, 0) is None
    np.testing.assert_array_equal(readers.ImageReader(flex).read(0),
                                  j_readers.ImageReader(flex).read(0))
    # an RGB STK is declined in both and falls to the TIFF path, where the
    # port now decodes the colour page as the reference's cv2 does (it
    # raised "no reader of the port" until it read what cv2 reads)
    rgb = tmp_path / "rgb.stk"
    test_stk._write_rgb_stk(rgb)
    assert readers.read_container_plane(rgb, 0) is None is j_readers.read_container_plane(rgb, 0)
    want = j_readers.ImageReader(rgb).read(0)
    for got in (readers.ImageReader(rgb).read(0), readers.BFImageReader(rgb).read(0)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_the_reader_cache_and_its_declined_sentinel(tmp_path):
    path = write("nd2_flat", tmp_path / "a.nd2")
    readers._OPEN_READERS.clear()
    first = readers._cached_container_reader(path)
    assert readers._cached_container_reader(path) is first
    declined = tmp_path / "declined.stk"
    cw.write_packbits_stk(declined, rand((4, 4), 32))
    assert readers._cached_container_reader(declined) is None
    assert readers._DECLINED in readers._OPEN_READERS.values()
    for i in range(readers._OPEN_READERS_CAP + 3):
        p = write("stk_8bit", tmp_path / f"s{i}.stk")
        readers.read_container_plane(p, 0)
    assert len(readers._OPEN_READERS) == readers._OPEN_READERS_CAP
    # a rewritten file is a new key: its new planes are read
    write("nd2_aborted", path)
    np.testing.assert_array_equal(readers.read_container_plane(path, 1),
                                  CASES["nd2_aborted"][3][1, :, :, 0])
    readers._OPEN_READERS.clear()


# ------------------------------------------------------------------ fuzz
N_FLIPS = 60
N_TRUNC = 20


def mutations(blob: bytes, rng):
    """The mutations of ``tests/test_reader_fuzz.py``: byte flips, then
    truncations."""
    for _ in range(N_FLIPS):
        pos = int(rng.integers(0, len(blob)))
        mutated = bytearray(blob)
        mutated[pos] ^= int(rng.integers(1, 256))
        yield bytes(mutated)
    for _ in range(N_TRUNC):
        yield blob[:int(rng.integers(1, len(blob)))]


def outcome(module, cls_name, path):
    """The planes a reader gives for every advertised page (at most 16),
    or the name of the error class it raises."""
    try:
        with getattr(module, cls_name)(path) as r:
            return [module._container_plane(r, p).tobytes() for p in range(min(n_pages(r), 16))]
    except (j_errors.MetadataError, j_errors.NotSupportedError, MetadataError,
            NotSupportedError) as exc:
        return type(exc).__name__


def _oib_fuzz(path, rng):
    stack = rng.integers(0, 60000, (2, 8, 9), dtype=np.uint16)
    files = {f"Storage00001/{test_oib.plane_name(c, 0, 0)}": test_oib.tiff_bytes(stack[c])
             for c in range(2)}
    path.write_bytes(test_oib.write_cfb(files))


def _oif_fuzz(path, rng):
    stack = rng.integers(0, 60000, (2, 8, 9), dtype=np.uint16)
    for stem in (path.name, "mut.oif"):
        files = path.parent / (stem + ".files")
        files.mkdir(exist_ok=True)
        for c in range(2):
            (files / test_oib.plane_name(c, 0, 0)).write_bytes(test_oib.tiff_bytes(stack[c]))
    path.write_bytes(b"\xff\xfe" + test_oib.oif_text(9, 8, 2, 1, 1).encode("utf-16-le"))


#: the fixtures of tests/test_reader_fuzz.py: (reader, suffix, seed, writer)
FUZZ = {
    "nd2": ("ND2Reader", ".nd2", 1, lambda p, rng: test_nd2.write_nd2(
        p, rng.integers(0, 60000, (4, 8, 9, 1), dtype=np.uint16), loops=[(2, 4)])),
    "nd2_lossless": ("ND2Reader", ".nd2", 12, lambda p, rng: test_nd2.write_nd2(
        p, rng.integers(0, 60000, (3, 8, 9, 2), dtype=np.uint16), compression="lossless")),
    "czi": ("CZIReader", ".czi", 2, lambda p, rng: test_czi.write_czi(
        p, rng.integers(0, 4000, (2, 2, 8, 9), dtype=np.uint16))),
    "czi_zstd1_hilo": ("CZIReader", ".czi", 2, lambda p, rng: test_czi.write_czi(
        p, rng.integers(0, 4000, (2, 2, 8, 9), dtype=np.uint16), compression=6, hilo=True)),
    "czi_gray8_jpeg": ("CZIReader", ".czi", 13, lambda p, rng: test_czi.write_czi(
        p, rng.integers(0, 255, (2, 1, 12, 14), dtype=np.uint8), pixel_type=0,
        compression=1)),
    "oib": ("OIBReader", ".oib", 3, _oib_fuzz),
    "flex": ("FlexReader", ".flex", 4, lambda p, rng: test_flex.write_flex(
        p, rng.integers(0, 60000, (4, 8, 9), dtype=np.uint16), channel_names=("A", "B"))),
    "dv": ("DVReader", ".dv", 5, lambda p, rng: test_dv.write_dv(
        p, rng.integers(0, 60000, (2, 2, 2, 8, 9), dtype=np.uint16))),
    "stk": ("STKReader", ".stk", 6, lambda p, rng: test_stk.write_stk(
        p, rng.integers(0, 60000, (3, 8, 9), dtype=np.uint16))),
    "lif": ("LIFReader", ".lif", 7, lambda p, rng: test_lif.write_lif(
        p, [rng.integers(0, 60000, (2, 2, 1, 8, 9), dtype=np.uint16)])),
    "lsm": ("LSMReader", ".lsm", 8, lambda p, rng: test_lsm.write_lsm(
        p, rng.integers(0, 60000, (1, 2, 2, 8, 9), dtype=np.uint16))),
    "oif": ("OIFReader", ".oif", 10, _oif_fuzz),
}


@pytest.mark.parametrize("case", sorted(FUZZ))
def test_mutated_containers_give_the_reference_outcome(tmp_path, case):
    cls_name, suffix, seed, make = FUZZ[case]
    rng = np.random.default_rng(seed)
    valid = tmp_path / f"valid{suffix}"
    make(valid, rng)
    target = tmp_path / f"mut{suffix}"
    for i, mutated in enumerate([valid.read_bytes(), *mutations(valid.read_bytes(), rng)]):
        target.write_bytes(mutated)
        assert outcome(readers, cls_name, target) == outcome(j_readers, cls_name, target), i
