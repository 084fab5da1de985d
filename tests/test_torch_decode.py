"""The images the JAX package hands to ``cv2`` -- colour and progressive
JPEG, tiled, colour, float and JPEG-in-TIFF TIFFs -- decoded by the
port's own host codecs (``csrc/host/jpeg.cpp``, ``csrc/host/tiff.cpp``,
``readers.decode_tiff_page``) against the reference's readers on the
CPU: ``cv2`` (libjpeg-turbo 3.1, libtiff 4.7) behind
``tmlibrary_tpu.readers.ImageReader``, ``ImageExtractor._read_plane`` and
``CZIReader``.

Held bit for bit: the same dtype, float32 bit-identical.  Where cv2
returns None or raises, the port raises ``MetadataError`` or
``NotSupportedError``.  Three cases are held against something else,
each recorded in ROADMAP C: a planar 16/32/64-bit TIFF (cv2 reads it from
memory it never wrote; the port returns the stored samples), page k > 0
through ``ImageReader.read`` (the reference returns page 0; the port is
held to ``cv2.imreadmulti``), and what the port refuses where cv2 reads
(old-style JPEG TIFF).  Sizes are
small (at most 96x96, odd shapes such as 37x53).  Tolerance: exact
(features of the slice test: ``FEATURE_TIERS``).
"""

import concurrent.futures as cf
import hashlib
import json
import struct

import cv2
import numpy as np
import pytest
import torch

import make_decode_well
import test_czi
import test_stk
from chip_smoke import (
    DECODE_WELL, DECODE_WELL_DIR, DECODE_WELL_PATTERN, DECODE_WELL_ROW, decode_well_colour,
    decode_well_port_files, decode_well_tiffs, gray15,
)
from test_torch_ingest import ingest
from test_torch_workflow_steps import (
    FEATURE_TIERS, assert_same_features, assert_same_labels, j_capacity_reset,
)
from tmlibrary_tpu import readers as j_readers
from tmlibrary_tpu.models.store import ExperimentStore as JStore
from tmlibrary_tpu.workflow.registry import get_step as j_get_step
from tmlibrary_tpu.workflow.steps.imextract import ImageExtractor as JExtractor
from tmlibrary_tpu_torch import (benchmarks, capacity, container_writers, native, readers,
                                 writers)
from tmlibrary_tpu_torch.container_writers import write_tiff
from tmlibrary_tpu_torch.errors import MetadataError, NotSupportedError
from tmlibrary_tpu_torch.io import png
from tmlibrary_tpu_torch.models.store import ExperimentStore
from tmlibrary_tpu_torch.workflow import get_step
from tmlibrary_tpu_torch.workflow.steps.imextract import ImageExtractor

torch.set_num_threads(1)

SAMPLINGS = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
SHAPES = [(37, 53), (1, 1), (2, 3), (5, 2), (16, 16), (17, 33), (96, 96), (64, 80)]


def colour_image(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    h, w = shape
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    return np.dstack([(yy * 5) % 256, (xx * 7) % 256, ((yy + xx) * 3) % 256]).astype(np.uint8)


def cv2_decode(stream: bytes):
    try:
        return cv2.imdecode(np.frombuffer(stream, np.uint8), cv2.IMREAD_UNCHANGED)
    except cv2.error:
        return None


def port_decode(stream: bytes):
    try:
        return native.jpeg_decode_array(stream)
    except MetadataError as e:
        return str(e)


def encode(img, quality=95, sampling=None, progressive=False, rst=0) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]]
    if rst:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def assert_same(got, want, what=""):
    assert got.dtype == want.dtype, what
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


# ------------------------------------------------------------------ JPEG
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_colour_streams_decode_as_cv2(sampling, progressive):
    """Every sampling, baseline and progressive, qualities 50 and 95,
    restart intervals 0 and 3, odd shapes: ``(H, W, 3)`` BGR bit for bit."""
    for i, shape in enumerate(SHAPES):
        for kind in ("noise", "smooth"):
            img = colour_image(kind, shape, i)
            for quality in (50, 95):
                for rst in (0, 3):
                    stream = encode(img, quality, sampling, progressive, rst)
                    want = cv2_decode(stream)
                    got = native.jpeg_decode_array(stream)
                    assert_same(got, want, f"{shape} {kind} q{quality} rst{rst}")
                    assert native.jpeg_info(stream) == (*shape, 3)


@pytest.mark.parametrize("progressive", [False, True])
def test_grey_streams_decode_as_cv2(progressive):
    rng = np.random.default_rng(3)
    for shape in SHAPES:
        img = rng.integers(0, 256, shape).astype(np.uint8)
        for quality in (50, 95):
            for rst in (0, 3):
                stream = encode(img, quality, None, progressive, rst)
                assert_same(native.jpeg_decode_array(stream), cv2_decode(stream))


@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_extreme_colours_decode_as_cv2(sampling):
    """Saturated colours, 1-pixel checkerboards and stripes at qualities
    10-100: the upsampling and colour conversion at their range limits,
    where libjpeg-turbo's SIMD paths run."""
    h, w = 40, 56
    cb = ((np.indices((h, w)).sum(0)) % 2 * 255).astype(np.uint8)
    images = [np.dstack([cb, 255 - cb, cb])]
    for c in [(0, 0, 255), (255, 0, 0), (0, 255, 0), (255, 255, 0), (0, 255, 255),
              (255, 0, 255), (255, 255, 255), (0, 0, 0)]:
        images.append(np.broadcast_to(np.array(c, np.uint8), (h, w, 3)).copy())
    images.append(np.random.default_rng(1).integers(0, 2, (h, w, 3)).astype(np.uint8) * 255)
    stripes = np.zeros((h, w, 3), np.uint8)
    stripes[:, ::2, 2] = 255
    stripes[::2, :, 0] = 255
    images.append(stripes)
    for img in images:
        for quality in (10, 50, 95, 100):
            for progressive in (False, True):
                stream = encode(img, quality, sampling, progressive)
                assert_same(native.jpeg_decode_array(stream), cv2_decode(stream))


def segments(stream: bytes):
    """``[(marker, segment bytes)]`` up to the first SOS, then the SOS
    segment and the rest (entropy data and EOI) as one."""
    out, at = [], 2
    while stream[at + 1] != 0xDA:
        (length,) = struct.unpack(">H", stream[at + 2:at + 4])
        out.append((stream[at + 1], stream[at:at + 2 + length]))
        at += 2 + length
    (length,) = struct.unpack(">H", stream[at + 2:at + 4])
    out.append((0xDA, stream[at:at + 2 + length]))
    return out, stream[at + 2 + length:-2]


def multi_scan_stream(planes, factors, ids=(1, 2, 3), app=b"") -> bytes:
    """A sequential JPEG of 3 non-interleaved scans, one a component: each
    component's grey stream from cv2 (its Huffman data copied, its
    quantisation table moved to slot ``c``), under one SOF whose sampling
    factors are ``factors``; ``app`` goes after SOI."""
    h, w = planes[0].shape
    dqt, dht, scans = b"", None, b""
    for c, plane in enumerate(planes):
        segs, data = segments(encode(plane, 85))
        for m, seg in segs:
            if m == 0xDB:
                dqt += seg[:4] + bytes([c]) + seg[5:]
            elif m == 0xC4 and dht is None:
                dht = b"".join(x for mm, x in segs if mm == 0xC4)
        scans += b"\xff\xda\x00\x08\x01" + bytes([ids[c]]) + b"\x00\x00\x3f\x00" + data
    sof = b"\xff\xc0" + struct.pack(">HBHHB", 8 + 9, 8, h, w, 3) + b"".join(
        bytes([ids[c], (f[0] << 4) | f[1], c]) for c, f in enumerate(factors))
    return b"\xff\xd8" + app + dqt + sof + dht + scans + b"\xff\xd9"


@pytest.mark.parametrize("layout", ["444", "420", "422"])
def test_non_interleaved_sequential_streams_decode_as_cv2(layout):
    """Baseline streams whose components come in three scans, one each
    (a buffered, multi-scan sequential decode): cv2's pixels."""
    rng = np.random.default_rng(19)
    h, w = 37, 53
    fy, fx = {"444": (1, 1), "420": (2, 2), "422": (1, 2)}[layout]
    luma = rng.integers(0, 256, (h, w)).astype(np.uint8)
    small = (-(-h // fy), -(-w // fx))
    chroma = [rng.integers(60, 200, small).astype(np.uint8) for _ in range(2)]
    stream = multi_scan_stream([luma, *chroma], [(fx, fy), (1, 1), (1, 1)])
    want = cv2_decode(stream)
    assert want is not None and want.shape == (h, w, 3)
    assert_same(native.jpeg_decode_array(stream), want)


def test_colour_space_as_libjpeg_guesses_it():
    """Three components are YCbCr under a JFIF segment, or an Adobe
    segment with transform 1, or ids 1, 2, 3; RGB under Adobe transform 0
    or ids 'R', 'G', 'B' (``default_decompress_parms``)."""
    rng = np.random.default_rng(20)
    planes = [rng.integers(0, 256, (24, 40)).astype(np.uint8) for _ in range(3)]
    adobe = lambda t: b"\xff\xee\x00\x0e" + b"Adobe" + bytes([0, 100, 0, 0, 0, 0, t])  # noqa: E731
    jfif = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    cases = [((1, 2, 3), b""), ((82, 71, 66), b""), ((82, 71, 66), jfif),
             ((1, 2, 3), adobe(0)), ((82, 71, 66), adobe(1)), ((7, 8, 9), b""),
             ((1, 2, 3), adobe(2))]
    results = []
    for ids, app in cases:
        stream = multi_scan_stream(planes, [(1, 1)] * 3, ids, app)
        want = cv2_decode(stream)
        assert_same(native.jpeg_decode_array(stream), want, str((ids, app[:6])))
        results.append(want)
    assert not np.array_equal(results[0], results[1])  # RGB and YCbCr both seen


def jpeg_mutations(blob: bytes, rng, flips: int, cuts: int):
    for _ in range(flips):
        pos = int(rng.integers(0, len(blob)))
        m = bytearray(blob)
        m[pos] ^= int(rng.integers(1, 256))
        yield bytes(m)
    for _ in range(cuts):
        yield blob[:int(rng.integers(1, len(blob)))]


@pytest.mark.parametrize("rst", [0, 2])
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("sampling", ["420", "422", "411"])
def test_damaged_streams_decode_as_libjpeg(sampling, progressive, rst):
    """``tests/test_torch_jpeg.py``'s damage test on colour and
    progressive streams: byte flips (markers, tables, scan headers,
    entropy data) and truncations give cv2's pixels (block-smoothed where
    a flip ends the scans early), or an error in both."""
    rng = np.random.default_rng(sorted(SAMPLINGS).index(sampling) * 4 + progressive * 2
                                + (rst > 0))
    img = rng.integers(0, 255, (40, 56, 3)).astype(np.uint8)
    stream = encode(img, 90, sampling, progressive, rst)
    for i, m in enumerate(jpeg_mutations(stream, rng, 100, 20)):
        want, got = cv2_decode(m), port_decode(m)
        if isinstance(got, str):
            assert want is None, (i, got)
        else:
            assert want is not None, i
            assert_same(got, want, str(i))


def test_early_stopping_progressive_stream_is_refused():
    """A progressive stream cut after its DC scans reaches EOI with its
    AC coefficients unrefined: libjpeg smooths the blocks (``jdcoefct.c``
    ``decompress_smooth_data``), which the port once refused; it now
    decodes to cv2's pixels."""
    img = colour_image("smooth", (32, 40), 0)
    stream = encode(img, 90, "420", True)
    second_sos = stream.index(b"\xff\xda", stream.index(b"\xff\xda") + 2)
    cut = stream[:stream.rindex(b"\xff", 0, second_sos)] + b"\xff\xd9"
    want = cv2_decode(cut)
    assert want is not None
    assert_same(native.jpeg_decode_array(cut), want)
    full = native.jpeg_decode_array(stream)
    assert not np.array_equal(full, want)  # the smoothed image is not the full one


def test_refused_streams_name_the_feature():
    """What cv2 reads no image of raises naming the feature: hierarchical
    and 12-bit streams, a DCT stream relabelled lossless.  A baseline
    stream relabelled arithmetic-coded (SOF9) and one whose SOF declares a
    fourth component it never codes (read as CMYK) were refused once and
    now decode to cv2's pixels (the rest: ``tests/test_torch_jpeg_streams.py``)."""
    img = colour_image("smooth", (24, 32), 0)
    base = encode(img, 90, "420")
    sof = base.index(b"\xff\xc0")
    (length,) = struct.unpack(">H", base[sof + 2:sof + 4])
    # a fourth component (CMYK/YCCK's count) in the SOF
    four = (base[:sof + 2] + struct.pack(">H", length + 3) + base[sof + 4:sof + 9] + b"\x04"
            + base[sof + 10:sof + 2 + length] + b"\x04\x11\x00" + base[sof + 2 + length:])
    twelve = bytearray(base)
    twelve[sof + 4] = 12
    refused = {
        "lossless": base[:sof] + b"\xff\xc3" + base[sof + 2:],
        "hierarchical": base[:sof] + b"\xff\xc5" + base[sof + 2:],
        "12-bit JPEG": bytes(twelve),
    }
    for what, stream in refused.items():
        assert cv2_decode(stream) is None, what
        with pytest.raises(MetadataError, match=what):
            native.jpeg_decode_array(stream)
    for stream in (base[:sof] + b"\xff\xc9" + base[sof + 2:], four):
        want = cv2_decode(stream)
        assert want is not None
        assert_same(native.jpeg_decode_array(stream), want)


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("colour", [False, True])
def test_jpg_files_read_as_the_reference_image_reader(tmp_path, colour, progressive):
    """Each stream written as a ``.jpg``: the port's and the reference's
    ``ImageReader`` and imextract ``_read_plane`` give the same grey plane."""
    for i, shape in enumerate(SHAPES[:5]):
        img = colour_image("noise", shape, i)
        img = img if colour else img[:, :, 0]
        for sampling in (sorted(SAMPLINGS) if colour else [None]):
            path = tmp_path / f"{i}_{sampling}.jpg"
            path.write_bytes(encode(img, 90, sampling, progressive, 3))
            want = j_readers.ImageReader(path).read(0)
            assert_same(readers.ImageReader(path).read(0), want, path.name)
            assert_same(ImageExtractor._read_plane(str(path), None, *shape),
                        JExtractor._read_plane(str(path), None, *shape), path.name)


# ------------------------------------------------------------------ TIFF
def tiff_samples(dtype: str, spp: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (37, 53, spp)
    if dtype[0] == "f":
        img = (rng.random(shape) * 1000).astype(dtype)
    else:
        info = np.iinfo(dtype)
        img = rng.integers(info.min, info.max, shape, endpoint=True).astype(dtype)
    return img[:, :, 0] if spp == 1 else img


def cv2_read(path):
    try:
        return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    except cv2.error:
        return None


def port_page(path, page=0):
    try:
        return readers.read_tiff_page_cv2(path, page)
    except (MetadataError, NotSupportedError) as e:
        return str(e)


def reference_plane(path, h, w):
    try:
        return JExtractor._read_plane(str(path), None, h, w)
    except Exception:  # cv2 returned None or cvtColor raised
        return None


def hold_file(path, stored=None):
    """The port's decode of ``path`` against cv2's (raw and through
    ``_read_plane``); ``stored`` replaces cv2's where cv2 reads garbage."""
    want = cv2_read(path) if stored is None else stored
    got = port_page(path)
    if want is None:
        assert isinstance(got, str), path
        with pytest.raises(MetadataError):
            ImageExtractor._read_plane(str(path), None, 1, 1)
        return "refused"
    assert not isinstance(got, str), got
    assert_same(got, want, str(path))
    h, w = got.shape[:2]
    try:
        plane = ImageExtractor._read_plane(str(path), None, h, w)
    except MetadataError:
        plane = None
    if stored is None:
        ref = reference_plane(path, h, w)
        if ref is None:
            assert plane is None
        else:
            assert_same(plane, ref, str(path))
    return "equal"


#: (compression, predictor) pairs; predictor 3 only on float samples
CODECS = [(1, 1), (5, 1), (5, 2), (8, 1), (8, 2), (8, 3), (5, 3), (32773, 1)]


@pytest.mark.parametrize("dtype", ["u1", "u2", "f4", "i2", "u4", "i4", "f8", "i1"])
@pytest.mark.parametrize("spp, planar", [(1, 1), (2, 1), (3, 1), (4, 1), (2, 2), (3, 2),
                                         (4, 2)])
def test_tiff_layouts_decode_as_cv2(tmp_path, dtype, spp, planar):
    """Strips and tiles (edge tiles cropped), chunky and planar, 1-4
    samples (grey with alpha, RGB, RGBA with associated and unassociated
    alpha), 8/16/32/64-bit integers and floats, none/LZW/deflate/PackBits
    with predictors 2 and 3, both byte orders, classic and BigTIFF: cv2's
    array bit for bit, or a refusal where cv2 refuses.  A planar page
    wider than 8 bits is held against its stored samples (cv2 reads it
    from memory it never wrote: ROADMAP C)."""
    held = []
    for tiled in (False, True):
        for comp, pred in CODECS:
            if pred == 3 and dtype[0] != "f":
                continue
            for bo, big in (("<", False), (">", True)):
                for extra in ([2], [1]) if spp in (2, 4) else (None,):
                    img = tiff_samples(dtype, spp, len(held))
                    path = tmp_path / f"{len(held)}.tif"
                    write_tiff(path, [img], planar=planar, tile=(16, 32) if tiled else None,
                               rows_per_strip=None if tiled else 10, compression=comp,
                               predictor=pred, byteorder=bo, bigtiff=big,
                               extra_samples=extra)
                    stored = None
                    if planar == 2 and dtype not in ("u1", "i1") and spp != 2:
                        stored = img[:, :, [2, 1, 0, 3][:spp] if spp == 4 else [2, 1, 0]]
                    held.append(hold_file(path, stored))
    assert held  # every file was held


def test_palette_miniswhite_and_extra_samples(tmp_path):
    """The photometric interpretations cv2 reads through libtiff's RGBA
    interface: palette (8- and 16-bit colour maps), MinIsWhite (inverted
    at 8 bits, as stored at 16), RGBA with no ExtraSamples tag, grey with
    alpha in edge tiles (libtiff's row skew, ``_skewed_grey_rows``)."""
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 256, (37, 53)).astype(np.uint8)
    for i, top in enumerate((256, 65536)):
        cmap = rng.integers(0, top, (3, 256))
        write_tiff(tmp_path / f"pal{i}.tif", [idx], photometric=3, colormap=cmap,
                   tile=(16, 16) if i else None)
        assert hold_file(tmp_path / f"pal{i}.tif") == "equal"
    for dt in ("u1", "u2"):
        img = tiff_samples(dt, 1, 7)
        write_tiff(tmp_path / f"mw_{dt}.tif", [img], photometric=0, tile=(16, 32))
        assert hold_file(tmp_path / f"mw_{dt}.tif") == "equal"
        ga = tiff_samples(dt, 2, 8)
        for phot in (0, 1):
            write_tiff(tmp_path / f"ga{phot}_{dt}.tif", [ga], photometric=phot, tile=(16, 48),
                       extra_samples=[2])
            assert hold_file(tmp_path / f"ga{phot}_{dt}.tif") == "equal"
    write_tiff(tmp_path / "rgba.tif", [tiff_samples("u1", 4, 9)], tile=(16, 16))
    assert hold_file(tmp_path / "rgba.tif") == "equal"


def test_what_the_port_refuses_is_named(tmp_path):
    """Orientation 3, CMYK and YCbCr that is not JPEG, refused here until
    the port read what cv2 reads, now decode as cv2 decodes them (every
    variant: ``tests/test_torch_cv2_images.py``); still refused, each
    named in the message: old-style JPEG (ROADMAP A), grey with alpha at
    32 bits and 4-bit grey samples (which cv2 refuses too)."""
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    read = {
        "Orientation 3": dict(pages=[img], orientation=3),
        "separated": dict(pages=[np.dstack([img, img[:, :, :1]])], photometric=5),
        "YCbCr": dict(pages=[img], photometric=6),
    }
    refused = {
        "old-style JPEG": dict(pages=[img], compression=6, chunks=[[b"\0" * 8]]),
        "grey with alpha at 32 bits": dict(pages=[rng.random((37, 53, 2)).astype(np.float32)]),
    }
    for cases, held in ((read, "equal"), (refused, None)):
        for what, kw in cases.items():
            path = tmp_path / f"{len(list(tmp_path.iterdir()))}.tif"
            pages = kw.pop("pages")
            write_tiff(path, pages, tile=(16, 16), **kw)
            if held:
                assert hold_file(path) == held, what
            else:
                with pytest.raises(MetadataError, match=what):
                    readers.ImageReader(path).read(0)
    # 4-bit grey samples: the struct writer writes whole bytes, so patch the tag
    path = tmp_path / "four.tif"
    write_tiff(path, [img[:, :, 0]], tile=(16, 16))
    blob = bytearray(path.read_bytes())
    at = blob.index(struct.pack("<HHI", 258, 3, 1))
    blob[at + 8:at + 10] = struct.pack("<H", 4)
    path.write_bytes(bytes(blob))
    assert cv2_read(path) is None
    with pytest.raises(MetadataError, match="4-bit samples"):
        readers.ImageReader(path).read(0)


@pytest.mark.parametrize("width, height, tile, what", [
    (4_000_000_000, 4_000_000_000, (16, 16), "cv2 reads at most"),
    (1 << 15, 1 << 15, (16, 16), "offsets for 4194304 tiles"),
    (32, 32, (1 << 15, 1 << 15), "cv2 reads tiles under 1 GiB"),
])
def test_forged_sizes_are_refused_before_anything_is_sized(tmp_path, width, height, tile,
                                                           what):
    """A few hundred bytes that claim a page or a tile no reader should
    size: refused with MetadataError before a buffer or a list of the
    claimed chunks is made (cv2's limits: 2^20 pixels a side, 2^30 in
    all, tiles under 1 GiB), through every reader of the chain."""
    path = tmp_path / "forged.tif"
    img = np.random.default_rng(12).integers(0, 256, (32, 32, 3)).astype(np.uint8)
    write_tiff(path, [img], tile=(16, 16),
               extra_tags={256: (4, [width]), 257: (4, [height]), 322: (4, [tile[1]]),
                           323: (4, [tile[0]])})
    with pytest.raises(MetadataError, match=what):
        readers.ImageReader(path).read(0)
    with pytest.raises(MetadataError, match=what):
        ImageExtractor._read_plane(str(path), None, 32, 32)
    if width > 1 << 20:  # the reference's cv2 refuses it too (it sizes nothing either)
        assert cv2_read(path) is None


@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_ycbcr_jpeg_in_tiff_decodes_as_cv2(tmp_path, sampling):
    """Compression 7 with photometric YCbCr (6) and YCbCrSubsampling: tiles
    and strips, full streams and JPEGTables with abbreviated ones,
    baseline and progressive (libtiff warns, then reads it); libjpeg
    converts to RGB as ``JPEGCOLORMODE_RGB`` asks."""
    factors = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "440": (1, 2), "411": (4, 1)}
    img = colour_image("noise", (64, 80), 2)
    for tiled in (True, False):
        for abbreviated in (False, True):
            for progressive in (False, True):
                th, tw = (32, 48) if tiled else (32, 80)
                chunks, tables = [], None
                for y in range(0, 64, th):
                    for x in range(0, 80, tw):
                        pad = np.zeros((th, tw, 3), np.uint8)
                        blk = img[y:y + th, x:x + tw]
                        pad[:blk.shape[0], :blk.shape[1]] = blk
                        stream = encode(pad[:, :, ::-1], 90, sampling, progressive)
                        if abbreviated:
                            tables, stream = make_decode_well.split_tables(stream)
                        chunks.append(stream)
                path = tmp_path / f"{tiled}{abbreviated}{progressive}.tif"
                write_tiff(path, [img], photometric=6, tile=(th, tw) if tiled else None,
                           rows_per_strip=th, compression=7, ycbcr_subsampling=factors[sampling],
                           jpeg_tables=tables, chunks=[chunks])
                assert hold_file(path) == "equal", path.name


def test_grey_and_planar_rgb_jpeg_in_tiff_decode_as_cv2(tmp_path):
    """JPEG chunks of one component: a grey page, and an RGB page in
    planes (a stream a plane, no colour conversion), tiled and in strips,
    with and without JPEGTables."""
    img = colour_image("noise", (64, 80), 3)
    for tiled in (True, False):
        for abbreviated in (False, True):
            th, tw = (32, 48) if tiled else (32, 80)
            for name, planes, kw in (("grey", [img[:, :, 0]], {"photometric": 1}),
                                     ("rgb", [img[:, :, p] for p in range(3)],
                                      {"photometric": 2, "planar": 2})):
                chunks, tables = [], None
                for plane in planes:
                    for y in range(0, 64, th):
                        for x in range(0, 80, tw):
                            pad = np.zeros((th, tw), np.uint8)
                            blk = plane[y:y + th, x:x + tw]
                            pad[:blk.shape[0], :blk.shape[1]] = blk
                            stream = encode(pad, 90)
                            if abbreviated:
                                tables, stream = make_decode_well.split_tables(stream)
                            chunks.append(stream)
                path = tmp_path / f"{name}{tiled}{abbreviated}.tif"
                write_tiff(path, [img if name == "rgb" else img[:, :, 0]],
                           tile=(th, tw) if tiled else None, rows_per_strip=th, compression=7,
                           jpeg_tables=tables, chunks=[chunks], **kw)
                assert hold_file(path) == "equal", path.name


def test_pillow_jpeg_tiffs_decode_as_cv2(tmp_path):
    """Pillow's (libtiff's) JPEG TIFFs: RGB with JPEGTables and grey; and
    cv2's own, which it writes with empty strips at 64x80 (both refuse)
    and readable at 37x53."""
    from PIL import Image

    for i, img in enumerate((colour_image("smooth", (64, 80), 0),
                             colour_image("noise", (37, 53), 1))):
        Image.fromarray(img).save(tmp_path / f"rgb{i}.tif", compression="jpeg")
        Image.fromarray(img[:, :, 0]).save(tmp_path / f"g{i}.tif", compression="jpeg")
        for name in (f"rgb{i}.tif", f"g{i}.tif"):
            want = cv2_read(tmp_path / name)
            assert_same(readers.read_tiff_page_cv2(tmp_path / name, 0), want, name)
            assert_same(readers.ImageReader(tmp_path / name).read(0),
                        j_readers.ImageReader(tmp_path / name).read(0), name)
    for shape, held in (((64, 80), "refused"), ((37, 53), "equal")):
        path = tmp_path / f"cv{shape[0]}.tif"
        cv2.imwrite(str(path), colour_image("smooth", shape, 0), [cv2.IMWRITE_TIFF_COMPRESSION, 7])
        assert hold_file(path) == held, shape


def test_the_motivating_files_decode_as_the_reference(tmp_path):
    """The eight files the port refused before: RGB LZW, RGB and grey
    JPEG-in-TIFF, float32, 16-bit RGB, 16-bit tiled deflate TIFFs, a
    progressive and a 4:2:0 colour JPEG; each a (64, 80) plane equal to
    the reference's, float32 bit for bit."""
    from PIL import Image

    rng = np.random.default_rng(12)
    rgb = rng.integers(0, 256, (64, 80, 3)).astype(np.uint8)
    Image.fromarray(rgb).save(tmp_path / "rgb_lzw.tif", compression="tiff_lzw")
    Image.fromarray(rgb).save(tmp_path / "rgb_jpeg.tif", compression="jpeg")
    Image.fromarray(rgb[:, :, 0]).save(tmp_path / "grey_jpeg.tif", compression="jpeg")
    f32 = (rng.random((64, 80)) * 3000).astype(np.float32)
    cv2.imwrite(str(tmp_path / "f32.tif"), f32)
    cv2.imwrite(str(tmp_path / "rgb16.tif"), rng.integers(0, 65536, (64, 80, 3)).astype(np.uint16))
    write_tiff(tmp_path / "tiled16.tif", [rng.integers(0, 65536, (64, 80)).astype(np.uint16)],
               tile=(32, 32), compression=8)
    (tmp_path / "prog.jpg").write_bytes(encode(rgb[:, :, 0], 90, None, True))
    (tmp_path / "c420.jpg").write_bytes(encode(rgb, 90, "420"))
    for name in ("rgb_lzw.tif", "rgb_jpeg.tif", "grey_jpeg.tif", "f32.tif", "rgb16.tif",
                 "tiled16.tif", "prog.jpg", "c420.jpg"):
        want = j_readers.ImageReader(tmp_path / name).read(0)
        got = readers.ImageReader(tmp_path / name).read(0)
        assert got.shape == (64, 80)
        assert_same(got, want, name)
        if got.dtype == np.float32:
            assert got.view(np.uint32).tobytes() == want.view(np.uint32).tobytes()


def test_pages_read_as_asked(tmp_path):
    """A 3-page colour TIFF: page 0 equals the reference's page 0; page k
    equals ``cv2.imreadmulti``'s page k (the reference's imextract reads
    it so); the reference's ``ImageReader.read(k)`` returns page 0
    (ROADMAP C), the port's returns page k."""
    rng = np.random.default_rng(13)
    pages = [np.full((37, 53, 3), 200 * (k % 2), np.uint8)
             + rng.integers(0, 50, (37, 53, 3)).astype(np.uint8) for k in range(3)]
    path = tmp_path / "pages.tif"
    write_tiff(path, pages, compression=5, tile=(16, 16))
    ok, multi = cv2.imreadmulti(str(path), flags=cv2.IMREAD_UNCHANGED)
    assert ok and len(multi) == 3
    assert_same(readers.ImageReader(path).read(0), j_readers.ImageReader(path).read(0))
    for k in range(3):
        want = cv2.cvtColor(multi[k], cv2.COLOR_BGR2GRAY)
        assert_same(readers.ImageReader(path).read(k), want, str(k))
        assert_same(ImageExtractor._read_plane(str(path), k, 37, 53),
                    JExtractor._read_plane(str(path), k, 37, 53), str(k))
    assert_same(j_readers.ImageReader(path).read(1), j_readers.ImageReader(path).read(0))
    assert not np.array_equal(readers.ImageReader(path).read(1), readers.ImageReader(path).read(0))
    with pytest.raises(MetadataError, match="no page 3"):
        readers.ImageReader(path).read(3)


def test_the_parse_cache_sees_a_rewritten_colour_map(tmp_path):
    """A palette TIFF rewritten in place with another colour map (same
    size and IFD, the map's bytes elsewhere): the next read sees it."""
    rng = np.random.default_rng(14)
    idx = rng.integers(0, 256, (37, 53)).astype(np.uint8)
    path = tmp_path / "pal.tif"
    for seed in (0, 1):
        cmap = np.random.default_rng(seed).integers(0, 65536, (3, 256))
        write_tiff(path, [idx], photometric=3, colormap=cmap, tile=(16, 16))
        assert_same(readers.read_tiff_page_cv2(path, 0), cv2_read(path), str(seed))


@pytest.mark.parametrize("width", list(range(1, 40)) + [255, 256, 257])
def test_float_gray_is_cv2s(width):
    """``to_gray`` of float32 BGR and BGRA at every tail length of cv2's
    vector blocks: bit for bit (cv2's kernel fuses multiply-adds in an
    order that depends on the pixel's place in its row)."""
    rng = np.random.default_rng(width)
    for scn in (3, 4):
        for img in ((rng.random((3, width, scn)) * 65535).astype(np.float32),
                    (rng.standard_normal((3, width, scn)) * 1e3).astype(np.float32)):
            want = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
            assert png.to_gray(img).view(np.uint32).tobytes() == want.view(np.uint32).tobytes()
        for dt in (np.uint8, np.uint16):
            img = rng.integers(0, np.iinfo(dt).max, (3, width, scn), endpoint=True).astype(dt)
            assert_same(png.to_gray(img), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))


def test_float_planes_cast_as_the_reference(tmp_path):
    """A float32 TIFF with fractional, negative, out-of-range and NaN
    values through both packages' metaconfig and imextract: the stores
    are equal (``np.asarray(img, np.uint16)`` in both)."""
    vals = np.array([0.4, 0.6, 1.5, -0.5, -1.0, -1.5, -300.7, 65535.9, 65536.0, 70000.7, 1e9,
                     -1e9, np.nan, np.inf, -np.inf, 12345.0], np.float32)
    src = tmp_path / "src"
    src.mkdir()
    for s in range(2):
        plane = np.resize(np.roll(vals, s), (8, 12)).astype(np.float32)
        write_tiff(src / f"A01_s{s}_DAPI.tif", [plane], tile=(16, 16))
    args = {"source_dir": str(src)}
    assert ingest(tmp_path / "port", args, port=True) == ingest(tmp_path / "ref", args, port=False)
    got = ExperimentStore.open(tmp_path / "port").read_sites(None, channel=0)
    want = JStore.open(tmp_path / "ref").read_sites(None, channel=0)
    assert_same(got, want)
    assert got.max() == 65535 and 4464 in got


# --------------------------------------------- containers and threads
def test_czi_colour_and_progressive_subblocks_read_as_the_reference(tmp_path, monkeypatch):
    """CZI compression 1 subblocks that are colour (4:2:0, 4:2:2) and
    progressive JPEG: the port's ``CZIReader`` equals the reference's."""
    planes8 = np.random.default_rng(15).integers(0, 255, (4, 1, 24, 40), dtype=np.uint8)
    variants = iter([dict(sampling="420"), dict(sampling="422", progressive=True),
                     dict(progressive=True), dict(sampling="444", rst=2)])
    original = test_czi._compress

    def compress(data, compression, hilo, plane=None):
        if compression != 1:
            return original(data, compression, hilo, plane=plane)
        kw = next(variants)
        img = np.asarray(plane, np.uint8)
        if "sampling" in kw:
            r, g, b = decode_well_colour(img)
            img = np.stack([b, g, r], -1)
        return encode(img, 90, kw.get("sampling"), kw.get("progressive", False), kw.get("rst", 0))

    monkeypatch.setattr(test_czi, "_compress", compress)
    path = tmp_path / "c.czi"
    test_czi.write_czi(path, planes8, pixel_type=0, compression=1)
    with readers.CZIReader(path) as r, j_readers.CZIReader(path) as j:
        for s in range(4):
            assert_same(r.read_plane(s, 0, 0, 0, 0), j.read_plane(s, 0, 0, 0, 0), str(s))


def test_rgb_stk_and_chunky_lsm_read_as_the_reference(tmp_path):
    """An RGB ``.stk`` and a chunky-RGB ``.lsm``: their readers decline
    them in both packages, and the TIFF path decodes them as the
    reference's cv2 does."""
    stk = tmp_path / "rgb.stk"
    test_stk._write_rgb_stk(stk)
    lsm = tmp_path / "rgb.lsm"
    info = struct.pack("<IiiiiiI", 0x00400494, 40, 53, 37, 1, 3, 1) + bytes(12)
    write_tiff(lsm, [np.random.default_rng(16).integers(0, 256, (37, 53, 3)).astype(np.uint8)],
               compression=5, predictor=2, extra_tags={34412: (1, list(info))})
    for path in (stk, lsm):
        assert readers.read_container_plane(path, 0) is None
        assert j_readers.read_container_plane(path, 0) is None
        want = j_readers.ImageReader(path).read(0)
        assert_same(readers.ImageReader(path).read(0), want, path.name)
        assert_same(readers.BFImageReader(path).read(0), want, path.name)


def test_threads_decode_as_one(tmp_path):
    """8 threads decoding different files at once (imextract's pool) give
    the serial results: the decoders keep their state per call."""
    rng = np.random.default_rng(17)
    paths = []
    for i in range(16):
        img = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
        if i % 4 == 0:
            path = tmp_path / f"{i}.jpg"
            path.write_bytes(encode(img, 90, "420", progressive=bool(i % 8)))
        elif i % 4 == 1:
            path = tmp_path / f"{i}.jpg"
            path.write_bytes(b"\xff\xd8\xff" + bytes(40))  # refused: thread-local errors
        elif i % 4 == 2:
            path = tmp_path / f"{i}.tif"
            write_tiff(path, [img.astype(np.float32)], tile=(16, 16), compression=8,
                       predictor=3)
        else:
            path = tmp_path / f"{i}.tif"
            write_tiff(path, [img], tile=(16, 32), compression=5, extra_samples=None)
        paths.append(str(path))

    def read(path):
        try:
            return ImageExtractor._read_plane(path, None, 48, 64)
        except MetadataError as e:
            return str(e)

    serial = [read(p) for p in paths]
    for _ in range(3):
        with cf.ThreadPoolExecutor(8) as pool:
            for got, want in zip(pool.map(read, paths * 2), serial * 2):
                if isinstance(want, str):
                    assert got == want
                else:
                    assert_same(got, want)


# ------------------------------------------------- the slice as a whole
def run_jterator(store, port: bool, max_objects: int):
    (store.root / "cp.pipe.json").write_text(json.dumps(benchmarks.CELL_PAINTING_PIPE))
    if port:
        capacity.reset_routing_history()
        step = get_step("jterator")(store, device="cpu")
    else:
        j_capacity_reset()
        step = j_get_step("jterator")(store)
    step.init({"pipe": "cp.pipe.json", "batch_size": 4, "max_objects": max_objects})
    for i in step.list_batches():
        step.run(i)
    step.collect()


def test_the_decode_well_through_ingest_and_config_3(tmp_path):
    """``chip_smoke.py`` phase 13's decode well at 96x96 on the CPU: the
    30 variants (TIFF, JPEG, PNG, BMP, PGM, PPM, the port's ImageWriter
    JPEGs, arithmetic-coded, lossless, CMYK, YCCK and block-smoothed JPEG,
    SGILog TIFF) through both packages' metaconfig (``pattern``, rows of 3
    sites), imextract and jterator config 3.  The stores are equal plane
    for plane, save the planar 16-bit RGB file (the reference's cv2 reads
    it from uninitialised memory), which equals its written pixels through
    the integer colour formula; with that plane set in the reference's
    store as well, the labels are equal bit for bit and the features
    within ``FEATURE_TIERS``."""
    n_sites = max(site for site, _ in DECODE_WELL) + 1
    data = benchmarks.synthetic_cell_painting_batch(n_sites, size=96, seed=0)
    px = {ch: data[ch].astype(np.uint16) for ch in ("DAPI", "Actin")}
    src = tmp_path / "src"
    src.mkdir()
    expected = decode_well_tiffs(container_writers, src, px)
    decode_well_port_files(container_writers, writers, src, px)
    for name, blob in {**make_decode_well.jpeg_family(px),
                       **make_decode_well.committed_family(px),
                       **make_decode_well.stream_family(px)}.items():
        (src / name).write_bytes(blob)
    assert sorted(p.name for p in src.iterdir()) == sorted(v[0] for v in DECODE_WELL.values())
    args = {"source_dir": str(src), "pattern": DECODE_WELL_PATTERN,
            "sites_per_well_x": DECODE_WELL_ROW}
    assert ingest(tmp_path / "port", args, port=True) == ingest(tmp_path / "ref", args,
                                                                port=False)
    port, ref = ExperimentStore.open(tmp_path / "port"), JStore.open(tmp_path / "ref")
    assert port.n_sites == n_sites
    mapping = json.loads((tmp_path / "port" / "workflow" / "metaconfig" /
                          "file_mapping.json").read_text())
    by_name = {v[0]: k for k, v in DECODE_WELL.items()}
    planar = DECODE_WELL[0, "Actin"][0]
    for e in mapping:
        key = by_name[e["path"].rsplit("/", 1)[1]]
        ch = port.experiment.channel_index(key[1])
        got = port.read_sites([e["site_index"]], channel=ch)[0]
        if key in expected:
            assert_same(got, np.asarray(expected[key], np.uint16), str(key))
        if e["path"].endswith(planar):
            ref.write_sites(got[None], [e["site_index"]], channel=ch)
            continue
        assert_same(got, ref.read_sites([e["site_index"]], channel=ch)[0], str(key))
    run_jterator(ref, port=False, max_objects=64)
    run_jterator(port, port=True, max_objects=64)
    assert_same_labels(port, ref)
    assert port.read_labels(None, "nuclei").max() > 0
    for name in ("nuclei", "cells"):
        assert_same_features(ref.read_features(name), port.read_features(name), FEATURE_TIERS)


def test_the_committed_fixtures_decode_to_the_manifest(tmp_path):
    """``tests/data/decode_well/``: the manifest lists every file of sites
    2-14; each committed one and each the smoke writes
    (``chip_smoke.decode_well_port_files``, written here the same way)
    decodes, in the reference and in the port, to the manifest's dtype,
    shape and sha256 (a float plane's uint16 cast, which imextract stores,
    to ``stored_sha256`` too); the port's JPEGs hash to ``cv2.imencode``'s
    stream of the same array; the committed set stays under 256 KiB and is
    what ``make_decode_well.py`` writes; the JPEG-in-TIFF's tables and
    tiles are as it writes them."""
    manifest = json.loads((DECODE_WELL_DIR / "manifest.json").read_text())
    files = {e["file"]: e for e in manifest["files"]}
    assert sorted(files) == sorted(v[0] for k, v in DECODE_WELL.items() if k[0] >= 2)
    px = make_decode_well.well_sites()
    jpegs = decode_well_port_files(container_writers, writers, tmp_path, px)
    total = 0
    for name, e in files.items():
        path = (DECODE_WELL_DIR if e["committed"] else tmp_path) / name
        if e["committed"]:
            total += path.stat().st_size
        for plane in (JExtractor._read_plane(str(path), None, *e["shape"]),
                      ImageExtractor._read_plane(str(path), None, *e["shape"])):
            assert str(plane.dtype) == e["dtype"] and list(plane.shape) == e["shape"]
            assert hashlib.sha256(np.ascontiguousarray(plane).tobytes()).hexdigest() == \
                e["sha256"], name
            assert ("stored_sha256" in e) == (plane.dtype.kind == "f"), name
            if "stored_sha256" in e:
                stored = np.ascontiguousarray(np.asarray(plane, np.uint16))
                assert hashlib.sha256(stored.tobytes()).hexdigest() == e["stored_sha256"]
        assert DECODE_WELL[e["site"], e["channel"]] == (name, e["variant"])
        if name in jpegs:
            stream = cv2.imencode(".jpg", jpegs[name])[1].tobytes()
            assert path.read_bytes() == stream
            assert hashlib.sha256(stream).hexdigest() == e["stream_sha256"]
    assert set(jpegs) == {n for n, e in files.items() if "stream_sha256" in e}
    assert total < 256 * 1024
    for name, blob in make_decode_well.stream_family(px).items():
        assert (DECODE_WELL_DIR / name).read_bytes() == blob, name
    tiff = readers.read_tiff_page_cv2(DECODE_WELL_DIR / DECODE_WELL[3, "Actin"][0], 0)
    assert tiff.shape == (256, 256, 3)


def test_the_smoke_integer_colour_is_to_gray():
    """The smoke's integer formula (:func:`chip_smoke.gray15`) is cv2's
    ``BGR2GRAY`` at 8 and 16 bits."""
    rng = np.random.default_rng(18)
    for dt in (np.uint8, np.uint16):
        bgr = rng.integers(0, np.iinfo(dt).max, (9, 11, 3), endpoint=True).astype(dt)
        want = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
        np.testing.assert_array_equal(gray15(bgr[..., 0], bgr[..., 1], bgr[..., 2]), want)
