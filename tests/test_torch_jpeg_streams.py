"""The JPEG streams the port once refused where cv2 reads them --
arithmetic-coded (SOF9 sequential, SOF10 progressive), lossless (SOF3)
at 2-8 bits, CMYK and YCCK, progressive streams whose scans stop early
(libjpeg's block smoothing) -- decoded by ``csrc/host/jpeg.cpp`` against
the reference on the CPU: ``cv2.imdecode(..., IMREAD_UNCHANGED)``
(OpenCV 5.0.0, libjpeg-turbo 3.1.2), and ``tmlibrary_tpu``'s
``ImageReader.read``, ``ImageExtractor._read_plane``, ``CZIReader`` and
the metaconfig probe on ``.jpg`` files, CZI JPEG subblocks and JPEG-in-TIFF.

The streams come from the seeded writers of ``tests/jpeg_streams.py``: a
QM coder after libjpeg's ``jcarith.c`` (each of its streams is also held
to cv2's pixels of the same coefficients Huffman coded, so the coder is
libjpeg's), a lossless coder (computed or raw differences, so the
decoder's modulo-2^16 arithmetic is reached), Pillow's CMYK streams with
the Adobe transform byte set to 2 for YCCK, and progressive streams cut
after each of their scans.  Sizes 1x1, 8x8, odd edges (17x33, 37x53),
4:2:0 with partial iMCUs, restart intervals.  What cv2 reads no image of
is refused naming the feature, each case shown to be None in cv2.
Tolerance: exact (dtype, shape and every byte).
"""

import io

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import jpeg_streams as js
import test_czi
from test_torch_cv2_images import reference_probe
from tmlibrary_tpu import readers as j_readers
from tmlibrary_tpu.workflow.steps.imextract import ImageExtractor as JExtractor
from tmlibrary_tpu_torch import native, readers
from tmlibrary_tpu_torch.container_writers import write_tiff
from tmlibrary_tpu_torch.errors import MetadataError
from tmlibrary_tpu_torch.workflow.steps.imextract import ImageExtractor
from tmlibrary_tpu_torch.workflow.steps.metaconfig import probe_shape

torch.set_num_threads(1)

SHAPES = [(1, 1), (8, 8), (17, 33), (37, 53), (24, 40)]
FACTORS = {"grey": [(1, 1)], "444": [(1, 1)] * 3, "420": [(2, 2), (1, 1), (1, 1)],
           "422": [(2, 1), (1, 1), (1, 1)], "440": [(1, 2), (1, 1), (1, 1)],
           "411": [(4, 1), (1, 1), (1, 1)]}


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


def assert_same(got, want, what=""):
    assert isinstance(got, np.ndarray), (what, got)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def hold(stream: bytes, what=""):
    """The port's decode of ``stream`` is cv2's, or both refuse it."""
    want, got = cv2_decode(stream), port_decode(stream)
    if want is None:
        assert isinstance(got, str), what
    else:
        assert_same(got, want, what)
    return want


def planes(shape, n: int, seed: int):
    """``n`` seeded 8-bit planes: a ramp, noise and their mix."""
    rng = np.random.default_rng(seed)
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    ramp = ((yy * 5 + xx * 3) % 256).astype(np.uint8)
    noise = rng.integers(0, 256, shape).astype(np.uint8)
    return [ramp, noise, (ramp // 2 + noise // 2).astype(np.uint8), 255 - ramp][:n]


def coefficients(shape, layout: str, quality: int, seed: int):
    factors = FACTORS[layout]
    q = js.quality_table(js.STD_LUMA_Q, quality)
    cq = js.quality_table(js.STD_CHROMA_Q, quality)
    tables = [q] + [cq] * (len(factors) - 1)
    geom = js.Geometry(*shape, factors)
    return geom, js.dct_coefficients(geom, planes(shape, len(factors), seed), tables), tables


# ------------------------------------------------------------ arithmetic
@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("layout", sorted(FACTORS))
def test_arithmetic_sequential_streams_decode_as_cv2(layout, restart):
    """SOF9 streams of one interleaved scan: cv2's pixels, which are also
    cv2's pixels of the same coefficients in a baseline Huffman stream."""
    for i, shape in enumerate(SHAPES):
        for quality in (50, 95):
            geom, coef, tables = coefficients(shape, layout, quality, i)
            stream = js.arith_stream(geom, coef, tables, restart=restart)
            want = hold(stream, f"{shape} q{quality}")
            assert want is not None
            np.testing.assert_array_equal(
                want, cv2_decode(js.huffman_stream(geom, coef, tables, restart=restart)))


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("layout", ["grey", "444", "420", "422", "411"])
def test_arithmetic_progressive_streams_decode_as_cv2(layout, restart):
    """SOF10 streams by libjpeg's simple progression (DC first and
    refinement, AC first and refinement): cv2's pixels, and those of the
    same coefficients sequential."""
    for i, shape in enumerate(SHAPES):
        geom, coef, tables = coefficients(shape, layout, 90, i + 10)
        stream = js.arith_stream(geom, coef, tables, progressive=True, restart=restart)
        want = hold(stream, str(shape))
        np.testing.assert_array_equal(want, cv2_decode(js.arith_stream(geom, coef, tables)))


def test_arithmetic_conditioning_tables_and_scans():
    """DAC conditioning (DC L and U, AC Kx; libjpeg takes any Kx, refuses
    L > U), table slots past 3 (arithmetic coding has 16), non-interleaved
    sequential scans and a progression with non-interleaved DC scans."""
    shape = (37, 53)
    geom, coef, tables = coefficients(shape, "420", 85, 3)
    want = cv2_decode(js.huffman_stream(geom, coef, tables))
    for cond in ({"L": [2] * 16, "U": [5] * 16}, {"L": [1] * 16, "U": [1] * 16},
                 {"K": [1] * 16}, {"K": [63] * 16}, {"U": [15] * 16}):
        assert_same(port_decode(js.arith_stream(geom, coef, tables, conditioning=cond)), want,
                    str(cond))
    for cond in ({"K": [0] * 16}, {"K": [200] * 16}):  # coded with Kx 5, read with another
        hold(js.arith_stream(geom, coef, tables)[:2] + js.dac([(1, 0, cond["K"][0])]) +
             js.arith_stream(geom, coef, tables)[2:], str(cond))
    bad_dac = js.arith_stream(geom, coef, tables, conditioning={"L": [0] * 16, "U": [1] * 16})
    bad_dac = bad_dac[:2] + js.dac([(0, 0, 0x12)]) + bad_dac[2:]
    assert cv2_decode(bad_dac) is None
    with pytest.raises(MetadataError, match="DAC"):
        native.jpeg_decode_array(bad_dac)
    slots = [(5, 9), (15, 4), (15, 4)]
    assert_same(port_decode(js.arith_stream(geom, coef, tables, tables=slots)), want)
    assert_same(port_decode(js.arith_stream(geom, coef, tables, sequential_scans=[[0], [2], [1]],
                                            restart=5)), want)
    script = [((0,), 0, 0, 0, 0), ((1,), 0, 0, 0, 0), ((2,), 0, 0, 0, 0), ((0,), 1, 63, 0, 0),
              ((1,), 1, 63, 0, 0), ((2,), 1, 63, 0, 0)]
    assert_same(port_decode(js.arith_stream(geom, coef, tables, progressive=True,
                                            script=script)), want)


@pytest.mark.parametrize("layout", ["grey", "420", "411"])
def test_huffman_data_read_as_arithmetic_decodes_as_cv2(layout):
    """Baseline streams relabelled SOF9 and SOF10: the QM decoder reads
    Huffman data, meets spectral and magnitude overflows (ct = -1: the
    rest of the restart interval left as it was), zeros past the EOI
    marker -- cv2's pixels, not just some image."""
    for i, shape in enumerate(SHAPES):
        for restart in (0, 2):
            geom, coef, tables = coefficients(shape, layout, 75, i + 20)
            base = js.huffman_stream(geom, coef, tables, restart=restart)
            at = base.index(b"\xff\xc0")
            for marker in (b"\xff\xc9", b"\xff\xca"):
                hold(base[:at] + marker + base[at + 2:], f"{shape} {marker.hex()} rst{restart}")


def damaged_stream(kind: str) -> bytes:
    shape = (24, 40)
    if kind.startswith("arithmetic"):
        geom, coef, tables = coefficients(shape, "420", 85, 4)
        return js.arith_stream(geom, coef, tables, progressive=kind.endswith("progressive"),
                               restart=3)
    if kind == "CMYK":
        return js.set_adobe_transform(pillow_cmyk(shape, 5, 90), 2)
    rgb = planes(shape, 3, 6)
    if kind == "lossless":
        return js.lossless_stream(rgb, [(2, 2), (1, 1), (1, 1)], psv=7, restart_rows=1)
    return js.lossless_stream(rgb, scans=[[0], [1], [2]], psv=2, restart_rows=2)


@pytest.mark.parametrize("kind", ["arithmetic", "arithmetic progressive", "lossless",
                                  "lossless in 3 scans", "CMYK"])
def test_damaged_streams_decode_as_libjpeg(kind):
    """Byte flips and truncations (bare, and ended by EOI) of each new
    kind of stream: cv2's pixels, or an error in both (a lossless
    component that no scan reached fails: libjpeg does not pre-zero its
    samples)."""
    rng = np.random.default_rng(30 + len(kind))
    stream = damaged_stream(kind)
    for i in range(150):
        m = bytearray(stream)
        m[int(rng.integers(2, len(m)))] ^= int(rng.integers(1, 256))
        hold(bytes(m), f"flip {i}")
    for i in range(30):
        cut = int(rng.integers(4, len(stream)))
        hold(stream[:cut] + b"\xff\xd9", f"cut {cut} + EOI")
        hold(stream[:cut], f"cut {cut}")


# -------------------------------------------------------------- lossless
@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_predictors_and_point_transforms_decode_as_cv2(psv):
    """Grey SOF3 streams of predictor ``psv``, point transforms 0-3,
    restart intervals of 0-2 rows: cv2's pixels, which are the samples
    coded (their low bits cleared by the point transform)."""
    for i, shape in enumerate(SHAPES):
        img = planes(shape, 2, i)[i % 2]
        for pt in (0, 1, 3):
            for rows in (0, 1, 2):
                stream = js.lossless_stream([img], psv=psv, pt=pt, restart_rows=rows,
                                            table="optimal")
                want = hold(stream, f"{shape} pt{pt} rst{rows}")
                np.testing.assert_array_equal(want, (img >> pt) << pt)


def test_lossless_differences_wrap_as_libjpeg():
    """Raw differences far outside the samples (category 16 too): the
    decoder's modulo-2^16 sums, predictions from the 16-bit values and
    8-bit stores are libjpeg's, under every predictor and restarts."""
    rng = np.random.default_rng(40)
    for shape in ((1, 1), (7, 9), (16, 33)):
        for psv in range(1, 8):
            for spread in (256, 40000):
                d = rng.integers(-spread, spread, shape)
                d.flat[0] = -32768
                for pt, rows in ((0, 0), (2, 1)):
                    hold(js.lossless_stream([np.zeros(shape, int)], psv=psv, pt=pt, diffs=[d],
                                            restart_rows=rows, table="optimal"),
                         f"{shape} psv{psv} {spread}")


def test_lossless_colour_precisions_and_scans_decode_as_cv2():
    """Three components without a JFIF or Adobe segment (read as RGB in
    lossless mode) or with Adobe transform 0, subsampled (replicated: no
    fancy upsampling), in one scan or three, restarts; precisions 2-8;
    four components (CMYK, Adobe transform 0 or none)."""
    rng = np.random.default_rng(41)
    for i, shape in enumerate(SHAPES[1:]):
        rgb = planes(shape, 3, i)
        for factors in (None, [(2, 2), (1, 1), (1, 1)], [(1, 2), (1, 1), (1, 1)],
                        [(4, 1), (1, 1), (1, 1)]):
            for app, ids in ((b"", (1, 2, 3)), (b"", (82, 71, 66)), (js.adobe(0), (1, 2, 3)),
                             (b"", (7, 8, 9))):
                want = hold(js.lossless_stream(rgb, factors, psv=5, ids=ids, app=app,
                                               restart_rows=1), str((shape, factors, ids)))
                assert want is not None and want.shape == shape + (3,)
                if factors is None:
                    np.testing.assert_array_equal(want, np.stack(rgb[::-1], -1))
        hold(js.lossless_stream(rgb, scans=[[0], [2], [1]], psv=3, restart_rows=2))
        hold(js.lossless_stream(rgb, [(2, 2), (1, 1), (1, 1)], scans=[[0], [1, 2]], psv=6))
        for p in range(2, 9):
            img = rng.integers(0, 1 << p, shape)
            want = hold(js.lossless_stream([img], precision=p, psv=7, pt=min(1, p - 2)))
            np.testing.assert_array_equal(want, (img >> min(1, p - 2)) << min(1, p - 2))
        cmyk = planes(shape, 4, i + 5)
        for app in (b"", js.adobe(0)):
            hold(js.lossless_stream(cmyk, psv=1, app=app), "lossless CMYK")


def test_cv2s_cmyk_conversion_on_every_ink_and_black():
    """A lossless Adobe CMYK stream of every (ink, K) pair: cv2's
    ``icvCvt_CMYK2BGR_8u_C4C3R`` (``k - ((255 - ink) * k >> 8)``) exactly."""
    c, k = np.meshgrid(np.arange(256), np.arange(256))
    cmyk = [c, (c * 7) % 256, (c * 13 + 5) % 256, k]
    want = hold(js.lossless_stream(cmyk, app=js.adobe(0)))
    ink = lambda x: k - ((255 - x) * k >> 8)  # noqa: E731
    np.testing.assert_array_equal(want, np.stack([ink(cmyk[2]), ink(cmyk[1]), ink(cmyk[0])], -1))


# ------------------------------------------------------------ CMYK, YCCK
def pillow_cmyk(shape, seed: int, quality: int) -> bytes:
    img = np.random.default_rng(seed).integers(0, 256, shape + (4,)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img, "CMYK").save(buf, "JPEG", quality=quality)
    return buf.getvalue()


@pytest.mark.parametrize("transform", [0, 1, 2])
def test_cmyk_and_ycck_streams_decode_as_cv2(transform):
    """Pillow's Adobe CMYK streams (transform 0) read as CMYK, as YCCK
    (transform 2: ``ycck_cmyk_convert``) and with the unknown transform 1
    (libjpeg assumes YCCK), baseline and progressive, with restarts, then
    into BGR as cv2 turns CMYK into three channels."""
    for i, shape in enumerate(SHAPES):
        for quality in (60, 95):
            stream = js.set_adobe_transform(pillow_cmyk(shape, i, quality), transform)
            want = hold(stream, f"{shape} q{quality}")
            assert want is not None and want.shape == shape + (3,)
    img = np.random.default_rng(50).integers(0, 256, (37, 53, 4)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img, "CMYK").save(buf, "JPEG", quality=90, progressive=True)
    hold(js.set_adobe_transform(buf.getvalue(), transform), "progressive")
    geom = js.Geometry(37, 53, [(2, 2), (1, 1), (1, 1), (2, 2)])
    q = js.quality_table(js.STD_LUMA_Q, 80)
    coef = js.dct_coefficients(geom, [img[..., c] for c in range(4)], [q] * 4)
    hold(js.arith_stream(geom, coef, [q] * 4, app=js.adobe(transform), restart=2), "subsampled")


# ------------------------------------------------------- block smoothing
SAMPLINGS = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


@pytest.mark.parametrize("sampling", sorted(SAMPLINGS) + ["grey"])
def test_progressive_streams_cut_short_are_block_smoothed_as_cv2(sampling):
    """cv2's progressive streams ended (EOI) after each of their scans but
    the last: libjpeg-turbo 3.1's ``decompress_smooth_data`` over the
    latched coefficient bits (the 5x5 DC neighbourhood, the DC itself
    while no AC data has come) -- cv2's pixels at every cut; 1- and
    2-block-wide components, 4:2:0 with a partial last iMCU row."""
    rng = np.random.default_rng(60)
    for shape in ((1, 1), (9, 9), (17, 33), (37, 53), (8, 40), (40, 8), (23, 100)):
        img = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
        yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
        smooth = np.dstack([(yy * 5) % 256, (xx * 7) % 256, ((yy + xx) * 3) % 256]).astype(
            np.uint8)
        for src in (img, smooth):
            for quality, rst in ((30, 0), (90, 2)):
                params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                          cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
                if sampling == "grey":
                    stream = cv2.imencode(".jpg", src[..., 0], params)[1].tobytes()
                else:
                    stream = cv2.imencode(".jpg", src, params + [
                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]])[1].tobytes()
                for k in range(1, len(js.scan_starts(stream))):
                    assert hold(js.cut_after_scans(stream, k), f"{shape} cut {k}") is not None


def test_progressive_streams_cut_inside_a_scan_are_block_smoothed_as_cv2():
    """cv2's progressive streams ended (EOI) a fifth, half and four fifths
    into each scan's data: the Huffman decoder meets the marker, reads
    zeros to the scan's end and stops counting rows as decoded with data,
    so rows past ``last_good_iMCU_row`` are smoothed by the coefficient
    bits from before the component's last scan -- cv2's pixels."""
    rng = np.random.default_rng(61)
    for shape in ((37, 53), (64, 80)):
        img = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
        for sampling, rst in (("420", 0), ("444", 2)):
            stream = cv2.imencode(".jpg", img, [
                cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]])[1].tobytes()
            starts = js.scan_starts(stream) + [len(stream) - 2]
            for k in range(len(starts) - 1):
                for frac in (0.2, 0.5, 0.8):
                    cut = int(starts[k] + 20 + (starts[k + 1] - starts[k] - 20) * frac)
                    hold(stream[:cut] + b"\xff\xd9", f"{shape} {sampling} scan {k} at {frac}")


def test_arithmetic_progressive_streams_cut_short_are_block_smoothed_as_cv2():
    for i, shape in enumerate(SHAPES):
        for layout in ("grey", "420", "422"):
            geom, coef, tables = coefficients(shape, layout, 80, i + 70)
            stream = js.arith_stream(geom, coef, tables, progressive=True, restart=3)
            for k in range(1, len(js.scan_starts(stream))):
                assert hold(js.cut_after_scans(stream, k), f"{shape} {layout} {k}") is not None


# ------------------------------------------------------- what cv2 refuses
def test_what_cv2_reads_no_image_of_is_refused_naming_it():
    """Valid streams cv2 returns None for: 12-bit sequential, lossless at
    12 and 16 bits, arithmetic-coded lossless (SOF11), hierarchical SOF5-7
    and SOF13-15, 2 components, fractional sampling, lossless colour that
    needs a conversion (JFIF or Adobe YCbCr, YCCK), lossless without a
    Huffman table, a lossless component no scan holds."""
    shape = (16, 24)
    img = planes(shape, 1, 0)[0]
    geom, coef, tables = coefficients(shape, "grey", 80, 0)
    base = js.huffman_stream(geom, coef, tables)
    at = base.index(b"\xff\xc0")
    twelve = bytearray(base)
    twelve[at + 1], twelve[at + 4] = 0xC1, 12
    rgb = planes(shape, 3, 1)
    lossless = js.lossless_stream([img], table=js.STD_DC)
    g2 = js.Geometry(*shape, [(1, 1), (1, 1)])
    g3 = js.Geometry(*shape, [(3, 1), (2, 1), (1, 1)])
    frac = [np.zeros((g3.bhp[c], g3.bwp[c], 64), np.int64) for c in range(3)]
    cases = {
        "12-bit JPEG": bytes(twelve),
        "12-bit lossless JPEG": js.lossless_stream([img.astype(int) * 16], precision=12),
        "16-bit lossless JPEG": js.lossless_stream([img.astype(int) * 256], precision=16),
        "arithmetic-coded lossless JPEG \\(SOF11\\)":
            js.lossless_stream([img], marker=0xCB),
        "2-component JPEG": js.huffman_stream(g2, js.dct_coefficients(
            g2, [img, img], [tables[0]] * 2), [tables[0]] * 2),
        "fractional JPEG sampling": js.huffman_stream(g3, frac, [tables[0]] * 3),
        "lossless JPEG in YCbCr": js.lossless_stream(rgb, app=js.JFIF),
        "lossless JPEG in YCbCr ": js.lossless_stream(rgb, app=js.adobe(1)),
        "lossless YCCK JPEG": js.lossless_stream(planes(shape, 4, 2), app=js.adobe(2)),
        "Huffman table 0x0 was not defined": lossless.replace(js.dht(0, 0, js.STD_DC), b""),
        "lossless component that no scan holds": js.lossless_stream(rgb, scans=[[0], [1], [2]])
        [:js.scan_starts(js.lossless_stream(rgb, scans=[[0], [1], [2]]))[2]] + b"\xff\xd9",
    }
    for m, name in ((0xC5, "SOF5"), (0xC6, "SOF6"), (0xC7, "SOF7"), (0xCD, "SOF13"),
                    (0xCE, "SOF14"), (0xCF, "SOF15")):
        cases[f"hierarchical .*\\({name}\\)"] = base[:at] + bytes([0xFF, m]) + base[at + 2:]
    for what, stream in cases.items():
        assert cv2_decode(stream) is None, what
        with pytest.raises(MetadataError, match=what.strip()):
            native.jpeg_decode_array(stream)


def test_the_header_names_the_process():
    """``native.jpeg_header``: the SOF marker, its process and precision,
    read up to the first SOS (where a colour conversion libjpeg refuses
    is already refused)."""
    shape = (16, 24)
    geom, coef, tables = coefficients(shape, "420", 80, 0)
    cases = {0xC0: js.huffman_stream(geom, coef, tables),
             0xC9: js.arith_stream(geom, coef, tables),
             0xCA: js.arith_stream(geom, coef, tables, progressive=True),
             0xC3: js.lossless_stream(planes(shape, 3, 0), precision=8)}
    for sof, stream in cases.items():
        head = native.jpeg_header(stream)
        assert (head["sof"], head["height"], head["width"], head["precision"]) == (
            sof, 16, 24, 8)
        assert head["process"] == native.JPEG_PROCESSES[sof]
        assert head["sampling"][0] == ((1, 1) if sof == 0xC3 else (2, 2))
    with pytest.raises(MetadataError, match="YCbCr"):
        native.jpeg_header(js.lossless_stream(planes(shape, 3, 0), app=js.JFIF))
    assert native.jpeg_header(js.lossless_stream(planes(shape, 3, 0), app=js.JFIF),
                              native.JPEG_RAW)["components"] == 3


# ------------------------------------------- through the readers and steps
def variant_streams(shape, seed: int) -> dict:
    """One stream of each variant, named for a file."""
    geom, coef, tables = coefficients(shape, "420", 85, seed)
    ggrey, cgrey, tgrey = coefficients(shape, "grey", 85, seed)
    cut = cv2.imencode(".jpg", np.dstack(planes(shape, 3, seed)), [
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 85])[1].tobytes()
    return {
        "arith.jpg": js.arith_stream(geom, coef, tables, restart=2),
        "arith_prog.jpg": js.arith_stream(ggrey, cgrey, tgrey, progressive=True),
        "lossless.jpg": js.lossless_stream(planes(shape, 1, seed), psv=7, pt=1),
        "lossless_rgb.jpg": js.lossless_stream(planes(shape, 3, seed), [(2, 2), (1, 1), (1, 1)]),
        "cmyk.jpg": pillow_cmyk(shape, seed, 90),
        "ycck.jpg": js.set_adobe_transform(pillow_cmyk(shape, seed, 90), 2),
        "smoothed.jpg": js.cut_after_scans(cut, 1),
        "arith_smoothed.jpg": js.cut_after_scans(js.arith_stream(
            geom, coef, tables, progressive=True), 2),
    }


def test_files_read_as_the_reference(tmp_path):
    """Each variant as a ``.jpg``: the port's ``ImageReader.read``,
    imextract ``_read_plane`` and metaconfig probe give the reference's
    plane and shape."""
    for i, shape in enumerate(((1, 1), (17, 33), (24, 40))):
        for name, stream in variant_streams(shape, i).items():
            path = tmp_path / f"{i}_{name}"
            path.write_bytes(stream)
            want = j_readers.ImageReader(path).read(0)
            assert_same(readers.ImageReader(path).read(0), want, path.name)
            assert_same(ImageExtractor._read_plane(str(path), None, *shape),
                        JExtractor._read_plane(str(path), None, *shape), path.name)
            assert probe_shape(str(path)) == reference_probe(path) == shape


def test_czi_jpeg_subblocks_of_every_variant_read_as_the_reference(tmp_path, monkeypatch):
    """CZI compression 1 subblocks holding each variant: the port's
    ``CZIReader`` equals the reference's (``cv2.imdecode`` and
    ``cvtColor``)."""
    shape = (24, 40)
    streams = list(variant_streams(shape, 7).values())
    planes8 = np.zeros((len(streams), 1) + shape, np.uint8)
    it = iter(streams)
    original = test_czi._compress

    def compress(data, compression, hilo, plane=None):
        return next(it) if compression == 1 else original(data, compression, hilo, plane=plane)

    monkeypatch.setattr(test_czi, "_compress", compress)
    path = tmp_path / "v.czi"
    test_czi.write_czi(path, planes8, pixel_type=0, compression=1)
    with readers.CZIReader(path) as r, j_readers.CZIReader(path) as j:
        for s in range(len(streams)):
            assert_same(r.read_plane(s, 0, 0, 0, 0), j.read_plane(s, 0, 0, 0, 0), str(s))


def test_jpeg_in_tiff_strips_of_every_variant_decode_as_cv2(tmp_path):
    """JPEG (compression 7) pages whose strips are arithmetic-coded,
    progressive, cut short, lossless or CMYK, as libtiff hands them to
    libjpeg: grey, RGB, YCbCr (``JPEGCOLORMODE_RGB``) and CMYK (components
    as stored, then libtiff's CMYK put routine) -- cv2's page."""
    shape = (32, 48)
    grey, *_ = planes(shape, 1, 3)
    rgb = planes(shape, 3, 4)
    g1, c1, t1 = coefficients(shape, "grey", 80, 5)
    g3, c3, t3 = coefficients(shape, "444", 80, 6)
    gy, cy, ty = coefficients(shape, "420", 80, 7)
    cases = {
        "grey arithmetic": (js.arith_stream(g1, c1, t1), 1, 1),
        "grey arithmetic progressive": (js.arith_stream(g1, c1, t1, progressive=True), 1, 1),
        "grey lossless": (js.lossless_stream([grey], psv=5), 1, 1),
        "RGB arithmetic": (js.arith_stream(g3, c3, t3, ids=[82, 71, 66]), 2, 3),
        "RGB lossless": (js.lossless_stream(rgb), 2, 3),
        "YCbCr arithmetic": (js.arith_stream(gy, cy, ty), 6, 3),
        "YCbCr arithmetic cut short": (js.cut_after_scans(
            js.arith_stream(gy, cy, ty, progressive=True), 2), 6, 3),
        "CMYK": (pillow_cmyk(shape, 8, 90), 5, 4),
    }
    for what, (stream, phot, spp) in cases.items():
        path = tmp_path / "j.tif"
        page = np.zeros(shape + ((spp,) if spp > 1 else ()), np.uint8)
        write_tiff(path, [page], photometric=phot, compression=7, chunks=[[stream]],
                   ycbcr_subsampling=(2, 2) if phot == 6 else None)
        want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        assert want is not None, what
        assert_same(readers.read_tiff_page_cv2(path, 0), want, what)
        assert_same(ImageExtractor._read_plane(str(path), None, *shape),
                    JExtractor._read_plane(str(path), None, *shape), what)
