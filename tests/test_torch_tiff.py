"""The port's TIFF readers (``csrc/host/tiff.cpp`` through
``tmlibrary_tpu_torch/native.py``, and ``tmlibrary_tpu_torch/readers.py``)
against the JAX package's and cv2.

TIFFs written by cv2 (none, LZW, PackBits and deflate strips, predictor
2, 8 and 16 bits, several strips, multi-page OME-TIFF) and by the
reference's own BigTIFF writer (``tests/test_bigtiff.py``) read equal in
both packages' C++ and Python readers, in both imextracts' plane read,
and to ``cv2.imread``; the C++ LZW and PackBits decoders equal their
Python versions on random, full-width and truncated streams; container
suffixes raise; a file no reader of the port takes raises naming it; the
port's ``ImageWriter`` files read back in cv2 and the reference.
"""

import numpy as np
import pytest

import cv2
from test_bigtiff import write_tiff
from test_native import _tiff_lzw_encode
from tmlibrary_tpu import native as j_native
from tmlibrary_tpu import errors as j_errors
from tmlibrary_tpu import readers as j_readers
from tmlibrary_tpu.workflow.steps.imextract import ImageExtractor as JExtractor
from tmlibrary_tpu_torch import native, readers
from tmlibrary_tpu_torch.errors import BuildError, MetadataError, NotSupportedError
from tmlibrary_tpu_torch.workflow.steps.imextract import ImageExtractor
from tmlibrary_tpu_torch.writers import ImageWriter, encode_tiff

CODECS = {"none": cv2.IMWRITE_TIFF_COMPRESSION_NONE, "lzw": cv2.IMWRITE_TIFF_COMPRESSION_LZW,
          "packbits": cv2.IMWRITE_TIFF_COMPRESSION_PACKBITS,
          "deflate": cv2.IMWRITE_TIFF_COMPRESSION_ADOBE_DEFLATE}


def smooth_image(rng, shape, dtype):
    """Random walks along rows: compressible, and the predictor matters."""
    top = np.iinfo(dtype).max
    steps = rng.integers(-40, 41, shape)
    return np.clip(np.cumsum(steps, axis=1) + top // 2, 0, top).astype(dtype)


def assert_same(got, want):
    if want is None:
        assert got is None
        return
    assert got is not None and got.shape == want.shape
    np.testing.assert_array_equal(np.asarray(got, np.uint16), np.asarray(want, np.uint16))


@pytest.mark.parametrize("codec", sorted(CODECS))
@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("rows_per_strip", [0, 7])
def test_cv2_written_tiffs_read_as_the_reference_reads_them(tmp_path, codec, predictor,
                                                            dtype, rows_per_strip):
    rng = np.random.default_rng(7)
    img = smooth_image(rng, (45, 61), dtype)
    path = str(tmp_path / "x.tif")
    params = [cv2.IMWRITE_TIFF_COMPRESSION, CODECS[codec], cv2.IMWRITE_TIFF_PREDICTOR,
              predictor]
    if rows_per_strip:
        params += [cv2.IMWRITE_TIFF_ROWSPERSTRIP, rows_per_strip]
    assert cv2.imwrite(path, img, params)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(want, img)
    h, w = img.shape
    ref_cpp = j_native.tiff_read(path, 0, h, w)
    assert_same(native.tiff_read(path, 0, h, w), ref_cpp)
    assert (ref_cpp is None) == (codec == "deflate")  # the C++ readers decline deflate
    page = native.tiff_read_page(path, 0)
    assert_same(page, j_native.tiff_read_page(path, 0))
    if page is not None:
        assert page.dtype == dtype
    assert native.tiff_info(path) == j_native.tiff_info(path)
    py = readers.read_tiff_page_py(path, 0)
    assert py is not None and py.dtype.itemsize == img.dtype.itemsize
    assert_same(py, j_readers.read_tiff_page_py(path, 0))
    assert_same(py, want)
    got = ImageExtractor._read_plane(path, None, h, w)
    assert_same(got, JExtractor._read_plane(path, None, h, w))
    assert_same(got, want)
    assert readers.tiff_dimensions(path) == (h, w)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_multi_page_ome_tiff_pages(tmp_path, dtype):
    rng = np.random.default_rng(3)
    pages = [smooth_image(rng, (33, 40), dtype) for _ in range(4)]
    path = str(tmp_path / "stack.ome.tif")
    assert cv2.imwritemulti(path, pages)
    ok, want = cv2.imreadmulti(path, flags=cv2.IMREAD_UNCHANGED)
    assert ok and len(want) == 4
    assert native.tiff_info(path) == j_native.tiff_info(path) == (4, 33, 40, dtype().nbytes * 8)
    for p in range(4):
        for got in (native.tiff_read(path, p, 33, 40), native.tiff_read_page(path, p),
                    readers.read_tiff_page_py(path, p),
                    ImageExtractor._read_plane(path, p, 33, 40)):
            assert_same(got, want[p])
        assert_same(ImageExtractor._read_plane(path, p, 33, 40),
                    JExtractor._read_plane(path, p, 33, 40))
    assert native.tiff_read(path, 4, 33, 40) is None
    assert readers.read_tiff_page_py(path, 4) is None
    with pytest.raises(MetadataError, match="no page 4"):
        readers.read_tiff_page(path, 4)


@pytest.mark.parametrize("big", [True, False])
@pytest.mark.parametrize("compression", [1, 8, 32946])
@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("bo", ["<", ">"])
def test_bigtiff_and_deflate_pages(tmp_path, big, compression, predictor, bo):
    rng = np.random.default_rng(11)
    planes = np.stack([smooth_image(rng, (24, 37), np.uint16) for _ in range(3)])
    write_tiff(tmp_path / "b.tif", planes, big=big, compression=compression,
               predictor=predictor, bo=bo)
    path = str(tmp_path / "b.tif")
    for p in range(3):
        got = readers.read_tiff_page_py(path, p)
        assert_same(got, j_readers.read_tiff_page_py(path, p))
        assert_same(got, planes[p])
        cpp = native.tiff_read(path, p, 24, 37)
        assert_same(cpp, j_native.tiff_read(path, p, 24, 37))
        assert (cpp is None) == (big or compression != 1)
        assert_same(ImageExtractor._read_plane(path, p, 24, 37), planes[p])
        assert_same(ImageExtractor._read_plane(path, p, 24, 37),
                    JExtractor._read_plane(path, p, 24, 37))
    assert readers.tiff_dimensions(path) == (24, 37)


def test_lzw_and_packbits_equal_their_python_versions():
    rng = np.random.default_rng(5)
    random_part = bytes(rng.integers(0, 256, 30000, dtype=np.uint8))
    runs = b"abababab" * 64 + bytes([7]) * 512
    for data in (random_part, runs, runs + random_part, b"", bytes(range(256)) * 20):
        enc = _tiff_lzw_encode(data)
        assert native.lzw_decode(enc, len(data)) == native._lzw_decode_py(enc, len(data)) \
            == data
        assert j_native.lzw_decode(enc, len(data)) == data
        for cut in (1, 5, len(enc) // 2, max(len(enc) - 2, 0)):
            got = native.lzw_decode(enc[:cut], len(data))
            assert got == native._lzw_decode_py(enc[:cut], len(data)) \
                == j_native._lzw_decode_py(enc[:cut], len(data))
    for seed in range(40):  # garbage streams: both fail, or both decode alike
        junk = bytes(np.random.default_rng(seed).integers(0, 256, 64 + seed, dtype=np.uint8))
        for expect in (1, 16, 300):
            assert native.lzw_decode(junk, expect) == native._lzw_decode_py(junk, expect)
            assert native.packbits_decode(junk, expect) == \
                native._packbits_decode_py(junk, expect) == \
                j_native._packbits_decode_py(junk, expect)
    literal = bytes([4]) + b"hello" + bytes([256 - 3]) + b"z" + bytes([128]) + bytes([0]) + b"!"
    assert native.packbits_decode(literal, 10) == native._packbits_decode_py(literal, 10) \
        == b"hellozzzz!"
    assert native.packbits_decode(literal[:3], 5) is None
    assert native._packbits_decode_py(literal[:3], 5) is None
    assert native.packbits_decode(literal, 6) == b"helloz"  # a run crossing the end


CONTAINER_SUFFIXES = (".czi", ".dv", ".flex", ".ims", ".lif", ".lsm", ".nd2", ".oib", ".oif",
                      ".r3d", ".stk", ".zarr")


@pytest.mark.parametrize("suffix", CONTAINER_SUFFIXES)
def test_container_suffixes_raise(tmp_path, suffix):
    path = tmp_path / f"plate{suffix}"
    path.write_bytes(b"II*\0" + bytes(64))
    # every container reader raises what the reference's raises on a file
    # that is none of its format (MetadataError); for Imaris .ims (HDF5,
    # read through the port's own subset) the reason after the
    # file name is h5py's in the reference and the port's own here
    with pytest.raises(j_errors.MetadataError) as ref:
        j_readers.read_container_plane(path, 0)
    for call in (lambda: readers.read_container_plane(path, 0),
                 lambda: readers.container_dimensions(path),
                 lambda: ImageExtractor._read_plane(str(path), None, 8, 8)):
        with pytest.raises(MetadataError) as got:
            call()
        if suffix == ".ims":
            prefix = f"not an HDF5/Imaris file: {path}:"
            assert str(got.value).startswith(prefix) and str(ref.value).startswith(prefix)
        else:
            assert str(got.value) == str(ref.value)
    for plain in ("x.tif", "x.TIFF", "x.png"):
        assert readers.read_container_plane(tmp_path / plain, 0) is None
        assert readers.container_dimensions(tmp_path / plain) is None
        assert j_readers.read_container_plane(tmp_path / plain, 0) is None


def test_files_no_reader_takes_raise_naming_their_format(tmp_path):
    """A colour JPEG, an RGB TIFF, a float TIFF and a baseline stream
    relabelled arithmetic-coded (SOF9) were refused here until the port
    read what cv2 reads: they now equal the JAX package's ``_read_plane``.
    A hierarchical JPEG (which cv2 reads no image of) and a file of no
    known format raise naming their format (the TIFF pages both refuse:
    ``tests/test_torch_decode.py``)."""
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 255, (16, 16, 3)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "x.jpg"), rgb)
    cv2.imwrite(str(tmp_path / "rgb.tif"), rgb)
    cv2.imwrite(str(tmp_path / "f.tif"), rgb[..., 0].astype(np.float32))
    for name in ("x.jpg", "rgb.tif", "f.tif"):
        want = JExtractor._read_plane(str(tmp_path / name), None, 16, 16)
        got = ImageExtractor._read_plane(str(tmp_path / name), None, 16, 16)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    base = cv2.imencode(".jpg", rgb)[1].tobytes()
    sof = base.index(b"\xff\xc0")
    (tmp_path / "a.jpg").write_bytes(base[:sof] + b"\xff\xc9" + base[sof + 2:])
    (tmp_path / "h.jpg").write_bytes(base[:sof] + b"\xff\xc5" + base[sof + 2:])
    (tmp_path / "x.bin").write_bytes(b"\x00\x01junk")
    cases = {"h.jpg": "JPEG", "x.bin": "unknown format"}
    for name, fmt in cases.items():
        with pytest.raises(MetadataError, match=fmt) as err:
            ImageExtractor._read_plane(str(tmp_path / name), None, 16, 16)
        assert name in str(err.value)
    for name in ("x.bin", "h.jpg"):
        with pytest.raises(Exception):
            JExtractor._read_plane(str(tmp_path / name), None, 16, 16)
    want = JExtractor._read_plane(str(tmp_path / "a.jpg"), None, 16, 16)
    assert want.shape == (16, 16)  # the SOF9 stream decodes to cv2's pixels
    np.testing.assert_array_equal(ImageExtractor._read_plane(str(tmp_path / "a.jpg"), None, 16, 16),
                                  want)


@pytest.mark.parametrize("suffix", [".tif", ".png"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_image_writer_files_read_back_in_cv2_and_the_reference(tmp_path, suffix, dtype):
    img = smooth_image(np.random.default_rng(9), (31, 29), dtype)
    path = tmp_path / "sub" / f"w{suffix}"
    with ImageWriter(path) as writer:
        writer.write(img)
    np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_UNCHANGED), img)
    assert_same(JExtractor._read_plane(str(path), None, 31, 29), img)
    assert_same(ImageExtractor._read_plane(str(path), None, 31, 29), img)
    with pytest.raises(NotSupportedError, match=r"\.webp"):  # cv2 writes it, the port does not
        ImageWriter(tmp_path / "x.webp").write(img)
    with pytest.raises(NotSupportedError):
        encode_tiff(np.zeros((2, 2, 2), np.uint8))


def test_a_failed_tiff_build_raises(tmp_path, monkeypatch):
    """A broken reader source is a build error, never a quiet switch to
    the Python reader."""
    bad = tmp_path / "tiff.cpp"
    bad.write_text("not C++ either\n")
    monkeypatch.setattr(native, "TIFF_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    path = tmp_path / "x.tif"
    path.write_bytes(encode_tiff(np.zeros((4, 4), np.uint16)))
    with pytest.raises(BuildError, match="failed"):
        ImageExtractor._read_plane(str(path), None, 4, 4)
