"""SGILog TIFF pages -- LogL16 and LogLuv32 (compression 34676) and
LogLuv24 (34677) -- decoded by ``csrc/host/luv.cpp`` through
``readers.decode_tiff_page`` against the reference on the CPU:
``cv2.imread(..., IMREAD_UNCHANGED)`` (OpenCV 5.0.0, libtiff 4.7.1) and
``tmlibrary_tpu``'s ``ImageReader.read``, ``ImageExtractor._read_plane``
and metaconfig probe.

cv2 reads a LogLuv page as libtiff's floats (``SGILOGDATAFMT_FLOAT``)
turned into BGR by ``cvtColor(COLOR_XYZ2BGR)``, and a LogL page of 8 or
16 bits through libtiff's RGBA interface as 8-bit grey.  The pages come
from ``container_writers.write_sgilog_tiff`` over seeded codes
(:func:`l16_codes` and the like) and from cv2's own writer; every one of
the 16,384 LogLuv24 ``(u', v')`` codes is held, so the port's copy of
libtiff's ``uvcode.h`` table is.  Held bit for bit, floats included: the
luminances come from ``exp``, and the port's 33,792 of them equal this
host's libm (``test_the_luminances_are_the_hosts_exp``), which is the
envelope ROADMAP C records.  Sizes at most 128x128.
"""

import hashlib
import math

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import SGILOG_LUMINANCE_DIGEST
from test_torch_cv2_images import reference_probe
from tmlibrary_tpu import readers as j_readers
from tmlibrary_tpu.workflow.steps.imextract import ImageExtractor as JExtractor
from tmlibrary_tpu_torch import native, readers
from tmlibrary_tpu_torch.container_writers import sgilog_chunk, write_sgilog_tiff, write_tiff
from tmlibrary_tpu_torch.errors import MetadataError, NotSupportedError
from tmlibrary_tpu_torch.workflow.steps.imextract import ImageExtractor
from tmlibrary_tpu_torch.workflow.steps.metaconfig import probe_shape

torch.set_num_threads(1)

SHAPES = [(1, 1), (5, 7), (16, 37), (33, 64), (20, 20)]
KINDS = ("L16", "Luv32", "Luv24")
#: ``tif_luv.c``'s neutral (u', v') and the 8-bit u, v scale of LogLuv32
U_NEU, V_NEU, UVSCALE = 0.210526316, 0.473684211, 410.0


def l16_codes(y: np.ndarray) -> np.ndarray:
    """LogL16 codes of luminances ``y`` (> 0): ``256 * (log2(y) + 64)``."""
    return np.clip(np.floor(256.0 * (np.log2(np.maximum(y, 2.0 ** -64)) + 64.0)), 1,
                   0x7FFF).astype(np.int64)


def luv32_codes(y: np.ndarray) -> np.ndarray:
    """LogLuv32 codes of luminances ``y`` at the neutral chromaticity."""
    return (l16_codes(y) << 16) | (int(UVSCALE * U_NEU) << 8) | int(UVSCALE * V_NEU)


def luv24_codes(y: np.ndarray, ce: int) -> np.ndarray:
    """LogLuv24 codes of luminances ``y`` (10-bit log: ``64 * (log2(y) +
    12)``) at the ``(u', v')`` index ``ce``."""
    le = np.clip(np.floor(64.0 * (np.log2(np.maximum(y, 2.0 ** -12)) + 12.0)), 1, 0x3FF)
    return (le.astype(np.int64) << 14) | int(ce)


def cv2_read(path):
    try:
        return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    except cv2.error:
        return None


def port_page(path):
    try:
        return readers.read_tiff_page_cv2(path, 0)
    except (MetadataError, NotSupportedError) as e:
        return str(e)


def hold(path, what=""):
    """The port's page is cv2's, byte for byte, or both refuse it."""
    want, got = cv2_read(path), port_page(path)
    if want is None:
        assert isinstance(got, str), what
        return None
    assert isinstance(got, np.ndarray), (what, got)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8), err_msg=what)
    return want


def random_codes(kind: str, shape, rng) -> np.ndarray:
    """Codes over the whole of each kind's range: signs, zero luminance,
    every u and v byte, (u', v') indices past the table."""
    top = {"L16": 1 << 16, "Luv32": 1 << 32, "Luv24": 1 << 24}[kind]
    return rng.integers(0, top, shape, dtype=np.uint64).astype(np.int64)


@pytest.mark.parametrize("kind", KINDS)
def test_pages_of_random_codes_decode_as_cv2(tmp_path, kind):
    """Every shape in strips of 3 rows, one strip and 16x16 tiles, under
    the BitsPerSample and SampleFormat tags cv2 and libtiff write."""
    rng = np.random.default_rng(KINDS.index(kind))
    for shape in SHAPES:
        codes = random_codes(kind, shape, rng)
        for dtype in (np.int16, np.uint16, np.uint8):
            for layout in ({"rows_per_strip": 3}, {"tile": (16, 16)}, {}):
                path = tmp_path / "p.tif"
                write_sgilog_tiff(path, codes, kind, dtype=dtype, **layout)
                want = hold(path, f"{shape} {np.dtype(dtype).name} {layout}")
                assert want is not None
                assert want.dtype == (np.float32 if kind != "L16" else
                                      np.int8 if dtype == np.int16 else np.uint8)


def test_every_logluv24_uv_code_decodes_as_cv2(tmp_path):
    """All 16,384 LogLuv24 chromaticity codes (16,289 in ``uvcode.h``'s
    163 rows, the rest read as neutral) at four luminances."""
    ce = np.arange(1 << 14)
    for le in (1, 300, 700, 1023):
        path = tmp_path / f"all_{le}.tif"
        write_sgilog_tiff(path, ((le << 14) | ce).reshape(128, 128), "Luv24", rows_per_strip=16)
        hold(path, str(le))


@pytest.mark.parametrize("kind", KINDS)
def test_orientations_decode_as_cv2(tmp_path, kind):
    """Orientation 1-8 on square and oblong pages: LogL through the RGBA
    interface's flips, LogLuv's X, Y, Z oriented whole before cv2's
    conversion to BGR (which then sums by the oriented rows); cv2 5.0
    returns None for 5-8 on an oblong page."""
    rng = np.random.default_rng(10 + KINDS.index(kind))
    for shape in ((13, 13), (7, 11)):
        codes = random_codes(kind, shape, rng)
        for orientation in range(1, 9):
            path = tmp_path / f"o{orientation}.tif"
            write_sgilog_tiff(path, codes, kind, orientation=orientation, rows_per_strip=4)
            want = hold(path, f"{shape} {orientation}")
            assert (want is None) == (orientation > 4 and shape[0] != shape[1])


def test_cv2_written_pages_decode_as_cv2(tmp_path):
    """What ``cv2.imwrite`` writes at 34676 and 34677: a float32 BGR
    image (LogLuv, read back as floats unlike those written) and a grey
    one (LogL, read back as 8-bit grey)."""
    rng = np.random.default_rng(20)
    for shape in ((5, 7), (33, 64)):
        bgr = (rng.random(shape + (3,)) * 100).astype(np.float32)
        grey = (rng.random(shape) * 0.9).astype(np.float32)
        for compression in (34676, 34677):
            path = tmp_path / f"c{compression}.tif"
            assert cv2.imwrite(str(path), bgr, [cv2.IMWRITE_TIFF_COMPRESSION, compression])
            assert hold(path).dtype == np.float32
        path = tmp_path / "g.tif"
        assert cv2.imwrite(str(path), grey, [cv2.IMWRITE_TIFF_COMPRESSION, 34676])
        assert hold(path).dtype == np.int8


def test_what_cv2_returns_none_for_is_refused(tmp_path):
    """LogL under 34677 or of 32 bits, LogLuv of 1 sample, in planes or
    uncompressed, grey under 34676, and a strip short of its data: cv2
    returns None; the port raises naming the page."""
    h, w = 6, 6
    codes = l16_codes(np.random.default_rng(30).random((h, w)) + 0.01)
    luv = luv32_codes(np.random.default_rng(31).random((h, w)) * 9 + 1)
    cases = {
        "LogL 34677": ([np.zeros((h, w), np.int16)], dict(photometric=32844, compression=34677),
                       [sgilog_chunk(codes, "L16")]),
        "LogL float": ([np.zeros((h, w), np.float32)], dict(photometric=32844,
                                                            compression=34676),
                       [sgilog_chunk(codes, "L16")]),
        "grey 34676": ([np.zeros((h, w), np.int16)], dict(photometric=1, compression=34676),
                       [sgilog_chunk(codes, "L16")]),
        "LogLuv 1 sample": ([np.zeros((h, w), np.int16)], dict(photometric=32845,
                                                               compression=34676),
                            [sgilog_chunk(luv, "Luv32")]),
        "LogLuv in planes": ([np.zeros((h, w, 3), np.int16)],
                             dict(photometric=32845, compression=34676, planar=2),
                             [sgilog_chunk(luv, "Luv32")] * 3),
        "LogLuv uncompressed": ([np.zeros((h, w, 3), np.int16)],
                                dict(photometric=32845, compression=1),
                                [bytes(h * w * 6)]),
        "short strip": ([np.zeros((h, w, 3), np.int16)], dict(photometric=32845,
                                                              compression=34676),
                        [sgilog_chunk(luv, "Luv32")[:-9]]),
    }
    for what, (page, kw, chunks) in cases.items():
        path = tmp_path / "r.tif"
        write_tiff(path, page, chunks=[chunks], **kw)
        assert cv2_read(path) is None, what
        with pytest.raises(MetadataError, match=str(path.name)):
            readers.read_tiff_page_cv2(path, 0)


def test_xyz_to_bgr_is_cv2s_float_for_float():
    """``native.xyz_to_bgr`` against ``cv2.cvtColor(COLOR_XYZ2BGR)`` at
    every width 1-70 and on 256x256: each row's vector part and scalar
    tail summed in cv2's orders."""
    rng = np.random.default_rng(40)
    for w in list(range(1, 71)) + [256]:
        for scale in (1e-3, 1.0, 1e4):
            xyz = (rng.random((3 if w < 256 else 256, w, 3)) * scale).astype(np.float32)
            want = cv2.cvtColor(xyz, cv2.COLOR_XYZ2BGR)
            np.testing.assert_array_equal(native.xyz_to_bgr(xyz).view(np.uint32),
                                          want.view(np.uint32))


def test_the_luminances_are_the_hosts_exp():
    """The decoder's 32,768 LogL16 and 1,024 LogL10 luminances are
    ``tif_luv.c``'s expressions over this host's ``exp`` (Python's
    ``math.exp`` is the same libm), and hash to the digest phase 13 holds
    the card's host to."""
    l16, l10 = native.sgilog_luminances()
    ln2 = math.log(2)
    assert l16[0] == 0 and l10[0] == 0
    assert all(l16[i] == math.exp(ln2 / 256.0 * (i + 0.5) - ln2 * 64.0) for i in range(1, 32768))
    assert all(l10[i] == math.exp(ln2 / 64.0 * (i + 0.5) - ln2 * 12.0) for i in range(1, 1024))
    digest = hashlib.sha256(l16.tobytes() + l10.tobytes()).hexdigest()
    assert digest == SGILOG_LUMINANCE_DIGEST


def test_files_read_as_the_reference(tmp_path):
    """Each kind as a ``.tif`` of cell-like luminances: the port's
    ``ImageReader.read``, imextract ``_read_plane`` (float planes cast to
    the store's uint16 alike) and metaconfig probe give the reference's."""
    rng = np.random.default_rng(50)
    for shape in ((1, 1), (16, 37), (40, 40)):
        y = rng.random(shape) * 3000 + 5
        pages = {"L16": l16_codes((y / 4096) ** 2), "Luv32": luv32_codes(y),
                 "Luv24": luv24_codes(y / 256, 12000)}
        for kind, codes in pages.items():
            for tile in (None, (16, 16)):
                path = tmp_path / f"{kind}_{tile is None}.tif"
                write_sgilog_tiff(path, codes, kind, tile=tile, dtype=np.uint16)
                want = j_readers.ImageReader(path).read(0)
                got = readers.ImageReader(path).read(0)
                assert got.dtype == want.dtype and got.shape == want.shape
                np.testing.assert_array_equal(got, want)
                a = ImageExtractor._read_plane(str(path), None, *shape)
                b = JExtractor._read_plane(str(path), None, *shape)
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(np.asarray(a, np.uint16), np.asarray(b, np.uint16))
                assert probe_shape(str(path)) == reference_probe(path) == shape
