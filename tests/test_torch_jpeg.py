"""The port's JPEG codec (``csrc/host/jpeg.cpp`` through
:mod:`tmlibrary_tpu_torch.native`) against ``cv2`` (libjpeg-turbo), and
its CZI JPEG subblocks against the JAX package's ``CZIReader``.

Grey streams from ``cv2.imencode`` at qualities 10-100, at odd sizes and
with restart intervals, decode bit for bit as ``cv2.imdecode(...,
IMREAD_UNCHANGED)`` decodes them; so do byte flips and truncations of
them (the same pixels, or an error in both).  The port's encoder
(integer forward DCT) writes streams that cv2 and the port decode alike,
and phase 13's JPEG sites hash to ``chip_smoke.JPEG_DIGEST``.
Progressive, colour and arithmetic-coded streams decode as cv2 decodes
them (their full coverage is ``tests/test_torch_decode.py`` and
``tests/test_torch_jpeg_streams.py``); what cv2 reads no image of --
hierarchical and 12-bit streams, a DCT stream relabelled lossless -- is
refused naming the feature.  ``tests/test_czi.py:522-570`` is
mirrored for the port.  Tolerance: exact.
"""

import cv2
import numpy as np
import pytest

import test_czi
from chip_smoke import JPEG_DIGEST, jpeg_digest, jpeg_sites
from tmlibrary_tpu import errors as j_errors
from tmlibrary_tpu import readers as j_readers
from tmlibrary_tpu_torch import container_writers as cw
from tmlibrary_tpu_torch import native, readers
from tmlibrary_tpu_torch.errors import MetadataError

SHAPES = [(8, 8), (1, 1), (13, 17), (40, 56), (99, 101), (7, 300), (129, 64)]


def image(kind: str, shape, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    h, w = shape
    if kind == "noise":
        return rng.integers(0, 256, shape).astype(np.uint8)
    if kind == "ramp":
        return (np.add.outer(np.arange(h), np.arange(w)) * 3 % 256).astype(np.uint8)
    return np.clip(rng.normal(100, 40, shape), 0, 255).astype(np.uint8)


def cv2_decode(stream: bytes):
    try:
        return cv2.imdecode(np.frombuffer(stream, np.uint8), cv2.IMREAD_UNCHANGED)
    except cv2.error:
        return None


def port_decode(stream: bytes):
    try:
        return native.jpeg_decode_array(stream)
    except MetadataError:
        return None


@pytest.mark.parametrize("quality", [10, 25, 50, 75, 90, 95, 100])
@pytest.mark.parametrize("kind", ["noise", "ramp", "blobs"])
def test_cv2_streams_decode_bit_for_bit(kind, quality):
    for shape in SHAPES:
        img = image(kind, shape, quality)
        for rst in (0, 1, 3):
            params = [cv2.IMWRITE_JPEG_QUALITY, quality]
            if rst:
                params += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
            ok, stream = cv2.imencode(".jpg", img, params)
            assert ok
            want = cv2_decode(stream.tobytes())
            h, w, raw = native.jpeg_decode(stream.tobytes())
            assert (h, w) == want.shape == native.jpeg_dimensions(stream.tobytes())
            np.testing.assert_array_equal(np.frombuffer(raw, np.uint8).reshape(h, w), want,
                                          err_msg=f"{shape} rst {rst}")


@pytest.mark.parametrize("quality", [10, 50, 95, 100])
def test_the_port_encoder_streams_decode_alike(quality):
    for kind in ("noise", "ramp", "blobs"):
        for shape in SHAPES:
            img = image(kind, shape, 1)
            stream = native.jpeg_encode(img, quality=quality)
            got = native.jpeg_decode_array(stream)
            np.testing.assert_array_equal(got, cv2_decode(stream))
            if quality >= 95 and kind != "noise":
                assert np.abs(got.astype(int) - img).mean() < 3  # close to the source


def test_phase_13_sites_hash_to_the_pinned_digest():
    sites = jpeg_sites()
    streams = [native.jpeg_encode(s, quality=95) for s in sites]
    assert jpeg_digest([cv2_decode(s) for s in streams]) == JPEG_DIGEST
    assert jpeg_digest([native.jpeg_decode_array(s) for s in streams]) == JPEG_DIGEST


def patched(stream: bytes, marker_from: bytes, marker_to: bytes) -> bytes:
    at = stream.index(marker_from)
    return stream[:at] + marker_to + stream[at + len(marker_to):]


def refused_streams() -> dict:
    img = image("blobs", (24, 32))
    base = cv2.imencode(".jpg", img)[1].tobytes()
    sof = base.index(b"\xff\xc0")
    twelve = bytearray(base)
    twelve[sof + 4] = 12
    return {
        "progressive": (cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1]
                        .tobytes(), "progressive"),
        "colour": (cv2.imencode(".jpg", np.dstack([img, img[::-1], img]))[1].tobytes(),
                   "multi-component JPEG \\(3 components\\)"),
        "arithmetic": (patched(base, b"\xff\xc0", b"\xff\xc9"), "arithmetic-coded"),
        "lossless": (patched(base, b"\xff\xc0", b"\xff\xc3"), "lossless"),
        "hierarchical": (patched(base, b"\xff\xc0", b"\xff\xc5"), "hierarchical"),
        "12-bit": (bytes(twelve), "12-bit JPEG"),
        "not a JPEG": (b"GIF89a" + bytes(40), "signature"),
    }


#: cases the decoder refused until it read progressive, colour and
#: arithmetic-coded streams: they now decode as cv2 decodes them
DECODED = ("progressive", "colour", "arithmetic")


@pytest.mark.parametrize("case", sorted(refused_streams()))
def test_refusals_name_the_feature(case):
    stream, what = refused_streams()[case]
    if case in DECODED:
        want = cv2_decode(stream)
        assert want is not None
        np.testing.assert_array_equal(native.jpeg_decode_array(stream), want)
        return
    assert cv2_decode(stream) is None
    with pytest.raises(MetadataError, match=what):
        native.jpeg_decode(stream)


def jpeg_mutations(blob: bytes, rng, flips: int, cuts: int):
    for _ in range(flips):
        pos = int(rng.integers(0, len(blob)))
        m = bytearray(blob)
        m[pos] ^= int(rng.integers(1, 256))
        yield bytes(m)
    for _ in range(cuts):
        yield blob[:int(rng.integers(1, len(blob)))]


@pytest.mark.parametrize("shape, rst", [((12, 14), 0), ((40, 56), 0), ((64, 64), 2),
                                        ((130, 150), 0)])
def test_damaged_streams_decode_as_libjpeg(shape, rst):
    """Flipped entropy bytes (symbol 0 for a bad code, zero bits past a
    marker, grey once data ran out, restart resync), damaged headers and
    truncations: the pixels cv2 gives, or an error in both."""
    rng = np.random.default_rng(shape[0] + rst)
    img = rng.integers(0, 255, shape).astype(np.uint8)
    stream = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_RST_INTERVAL, rst] if rst else [])[1]
    for i, m in enumerate(jpeg_mutations(stream.tobytes(), rng, 200, 40)):
        want, got = cv2_decode(m), port_decode(m)
        if want is None or got is None:
            assert want is None and got is None, i
        else:
            np.testing.assert_array_equal(got, want, err_msg=str(i))


# -------------------------------------------- tests/test_czi.py:522-570
def test_czi_gray8_round_trip(tmp_path):
    """pixel_type 0 (Gray8) decodes uncompressed and zstd0, in both
    packages, from both packages' writers."""
    planes8 = np.random.default_rng(81).integers(0, 255, (2, 1, 16, 20), dtype=np.uint8)
    for comp in (0, 5):
        for name, write in (("ref", test_czi.write_czi), ("port", cw.write_czi)):
            path = tmp_path / f"{name}_{comp}.czi"
            write(path, planes8, pixel_type=0, compression=comp)
            for pkg in (readers, j_readers):
                with pkg.CZIReader(path) as r:
                    for s in range(2):
                        out = r.read_plane(s, 0, 0, 0, 0)
                        assert out.dtype == np.uint8
                        np.testing.assert_array_equal(out, planes8[s, 0])


def test_czi_jpeg_subblocks_decode_as_cv2(tmp_path):
    """compression=1 decodes to cv2's own decode of the embedded stream,
    from the reference's writer (cv2's encoder) and from the port's."""
    planes8 = np.random.default_rng(82).integers(0, 255, (1, 1, 24, 24), dtype=np.uint8)
    for name, write, encode in (
            ("ref", test_czi.write_czi, lambda p: cv2.imencode(".jpg", p)[1].tobytes()),
            ("port", cw.write_czi, lambda p: native.jpeg_encode(p, quality=95))):
        path = tmp_path / f"{name}.czi"
        write(path, planes8, pixel_type=0, compression=1)
        golden = cv2_decode(encode(planes8[0, 0]))
        with readers.CZIReader(path) as r:
            out = r.read_plane(0, 0, 0, 0, 0)
        np.testing.assert_array_equal(out, golden)
        with j_readers.CZIReader(path) as r:
            np.testing.assert_array_equal(r.read_plane(0, 0, 0, 0, 0), golden)
        assert np.abs(out.astype(int) - planes8[0, 0].astype(int)).mean() < 12


def test_czi_jpeg_geometry_and_damage_are_refused_as_the_reference(tmp_path):
    planes8 = np.random.default_rng(84).integers(0, 255, (1, 1, 24, 24), dtype=np.uint8)
    path = tmp_path / "j.czi"
    test_czi.write_czi(path, planes8, pixel_type=0, compression=1)
    blob = bytearray(path.read_bytes())
    sof = blob.index(b"\xff\xc0")
    blob[sof + 5:sof + 7] = (20).to_bytes(2, "big")  # the stream says 20 rows
    path.write_bytes(bytes(blob))
    with pytest.raises(MetadataError, match=r"decodes to \(20, 24\), directory says \(24, 24\)"):
        with readers.CZIReader(path) as r:
            r.read_plane(0, 0)
    with pytest.raises(j_errors.MetadataError, match="directory says"):
        with j_readers.CZIReader(path) as r:
            r.read_plane(0, 0)
    blob[sof:sof + 2] = b"\xff\xc2"  # progressive, with a baseline scan's Ss/Se: both refuse
    path.write_bytes(bytes(blob))
    with pytest.raises(MetadataError,
                       match="corrupt JPEG subblock: corrupt JPEG: invalid progressive"):
        with readers.CZIReader(path) as r:
            r.read_plane(0, 0)
    with pytest.raises(j_errors.MetadataError, match="corrupt JPEG subblock"):
        with j_readers.CZIReader(path) as r:
            r.read_plane(0, 0)


def test_czi_zstd1_hilo_on_gray8_is_rejected(tmp_path):
    planes8 = np.random.default_rng(83).integers(0, 255, (1, 1, 8, 10), dtype=np.uint8)
    path = tmp_path / "h8.czi"
    cw.write_czi(path, planes8, pixel_type=0, compression=6, hilo=False)
    blob = bytearray(path.read_bytes())
    marker = blob.find(b"\x03\x01\x00")
    assert marker > 0
    blob[marker + 2] = 1
    path.write_bytes(bytes(blob))
    with readers.CZIReader(path) as r:
        with pytest.raises(MetadataError, match="hi-lo packing on a non-16-bit"):
            r.read_plane(0, 0, 0, 0, 0)
    with j_readers.CZIReader(path) as r:
        with pytest.raises(j_errors.MetadataError, match="hi-lo packing on a non-16-bit"):
            r.read_plane(0, 0, 0, 0, 0)
