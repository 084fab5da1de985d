"""The port's PNG codec (``tmlibrary_tpu_torch/io/png.py``) against cv2.

PNGs written by cv2 (8/16-bit grey, RGB, RGBA) and by a small encoder
here (grey with alpha, which cv2 cannot write, and each of the five
filter types on every row, several ``IDAT`` chunks) decode equal to
``cv2.imread(..., IMREAD_UNCHANGED)``; colour converts to grey equal to
``cv2.cvtColor(..., COLOR_BGR2GRAY)`` bit for bit; the port's encodes
decode equal under cv2; interlaced, palette, low-bit-depth and ``tRNS``
files decode as cv2 reads them, corrupt ones raise by name.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tmlibrary_tpu_torch.errors import MetadataError, NotSupportedError
from tmlibrary_tpu_torch.io import png

COLOR_SAMPLES = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _filter_row(kind: int, row: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """The PNG filter ``kind`` applied to one row of bytes (the encoder's
    side of what the codec undoes)."""
    x = row.astype(np.int32)
    up = prior.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) >> 1
    else:
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    return ((x - pred) & 0xFF).astype(np.uint8)


def make_png(pixels: np.ndarray, ctype: int, filters=None, n_idat: int = 1,
             interlace: int = 0, extra: bytes = b"", depth=None) -> bytes:
    """A PNG of ``pixels`` ((H, W) or (H, W, samples), in PNG sample order)
    with the given filter type per row."""
    h, w = pixels.shape[:2]
    depth = depth or pixels.dtype.itemsize * 8
    samples = COLOR_SAMPLES.get(ctype, 1)
    rows = np.ascontiguousarray(pixels, ">u2" if depth == 16 else "u1").view(np.uint8)
    rows = rows.reshape(h, -1)
    bpp = samples * depth // 8
    filters = filters if filters is not None else [0] * h
    raw = bytearray()
    prior = np.zeros(rows.shape[1], np.uint8)
    for y in range(h):
        raw.append(filters[y])
        raw += _filter_row(filters[y], rows[y], prior, bpp).tobytes()
        prior = rows[y]
    data = zlib.compress(bytes(raw))
    cut = [len(data) * i // n_idat for i in range(n_idat + 1)]
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)) + extra
    for a, b in zip(cut, cut[1:]):
        out += _chunk(b"IDAT", data[a:b])
    return out + _chunk(b"IEND", b"")


def cv2_decode(data: bytes, tmp_path, name="x.png") -> np.ndarray:
    path = tmp_path / name
    path.write_bytes(data)
    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (64, 96)])
def test_cv2_written_pngs_decode_as_cv2_reads_them(tmp_path, dtype, channels, shape):
    rng = np.random.default_rng(channels * 100 + shape[0])
    size = shape if channels == 1 else shape + (channels,)
    img = rng.integers(0, np.iinfo(dtype).max + 1, size).astype(dtype)
    path = tmp_path / "c.png"
    assert cv2.imwrite(str(path), img)
    got = png.read(path)
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if channels > 1:
        np.testing.assert_array_equal(png.to_gray(got), cv2.cvtColor(want, cv2.COLOR_BGR2GRAY))
    assert png.info(path)[:2] == shape


@pytest.mark.parametrize("depth", [8, 16])
def test_grey_with_alpha_decodes_as_cv2_reads_it(tmp_path, depth):
    rng = np.random.default_rng(depth)
    px = rng.integers(0, 1 << depth, (9, 13, 2)).astype(np.uint16 if depth == 16 else np.uint8)
    data = make_png(px, 4, filters=[k % 5 for k in range(9)])
    want = cv2_decode(data, tmp_path)
    got = png.decode(data)
    assert want.shape == (9, 13, 4) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(png.to_gray(got), cv2.cvtColor(want, cv2.COLOR_BGR2GRAY))
    np.testing.assert_array_equal(png.to_gray(got), px[..., 0])


def test_a_suggested_palette_and_ancillary_chunks_are_skipped(tmp_path):
    px = np.random.default_rng(1).integers(0, 256, (6, 5, 3)).astype(np.uint8)
    data = make_png(px, 2, filters=[4, 3, 2, 1, 0, 4],
                    extra=_chunk(b"PLTE", bytes(range(48))) + _chunk(b"gAMA", b"\0\0\xb1\x8f")
                    + _chunk(b"tEXt", b"Software\0test"))
    np.testing.assert_array_equal(png.decode(data), cv2_decode(data, tmp_path))
    with pytest.raises(MetadataError, match="second IHDR"):
        png.decode(data[:33] + data[8:33] + data[33:])


@settings(max_examples=30, deadline=None)
@given(h=st.integers(1, 300), w=st.integers(1, 257), ctype=st.sampled_from([0, 2, 4, 6]),
       depth=st.sampled_from([8, 16]), seed=st.integers(0, 2**31 - 1),
       n_idat=st.integers(1, 3), data=st.data())
def test_every_filter_type_decodes_as_cv2_reads_it(tmp_path_factory, h, w, ctype, depth,
                                                   seed, n_idat, data):
    rng = np.random.default_rng(seed)
    samples = COLOR_SAMPLES[ctype]
    shape = (h, w) if samples == 1 else (h, w, samples)
    px = rng.integers(0, 1 << depth, shape).astype(np.uint8 if depth == 8 else np.uint16)
    if data.draw(st.booleans()):  # smooth content, where the predictors matter
        px = np.sort(px, axis=1)
    filters = data.draw(st.lists(st.integers(0, 4), min_size=h, max_size=h))
    encoded = make_png(px, ctype, filters=filters, n_idat=n_idat)
    want = cv2_decode(encoded, tmp_path_factory.mktemp("f"))
    got = png.decode(encoded)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if got.ndim == 3:
        np.testing.assert_array_equal(png.to_gray(got), cv2.cvtColor(want, cv2.COLOR_BGR2GRAY))


@settings(max_examples=25, deadline=None)
@given(h=st.integers(1, 300), w=st.integers(1, 257), depth=st.sampled_from([8, 16]),
       seed=st.integers(0, 2**31 - 1))
def test_the_ports_encodes_decode_under_cv2(tmp_path_factory, h, w, depth, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 1 << depth, (h, w)).astype(np.uint8 if depth == 8 else np.uint16)
    path = png.write(tmp_path_factory.mktemp("e") / "e.png", img)
    back = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert back.dtype == img.dtype
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(png.read(path), img)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_bgr2gray_matches_cv2_on_every_extreme(dtype):
    top = np.iinfo(dtype).max
    vals = np.array([0, 1, 2, top // 2, top - 1, top], dtype)
    grid = np.stack(np.meshgrid(vals, vals, vals, indexing="ij"), -1).reshape(-1, 1, 3)
    for img in (grid, np.concatenate([grid, grid[..., :1]], -1)):
        np.testing.assert_array_equal(png.to_gray(img), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))


def test_what_the_codec_does_not_take_raises_by_name(tmp_path):
    """Adam7, palette, 4-bit grey and ``tRNS``, refused here until the
    port read what libpng reads, now decode as cv2 reads them (every
    variant: ``tests/test_torch_cv2_images.py``); what libpng refuses --
    an unknown critical chunk, a bit depth the colour type does not take,
    a palette image without ``PLTE``, a bad CRC or signature, a truncated
    file -- still raises by name."""
    from test_torch_cv2_images import write_png

    px = np.arange(16, dtype=np.uint8).reshape(4, 4)
    cases = {
        "interlaced": write_png(px, 0, 8, interlace=1),
        "palette": write_png(px, 3, 8, extra=_chunk(b"PLTE", bytes(range(48)))),
        "4-bit": write_png(px % 16, 0, 4),
        "tRNS": write_png(px, 0, 8, extra=_chunk(b"tRNS", b"\0\x07")),
    }
    for name, data in cases.items():
        np.testing.assert_array_equal(png.decode(data, name), cv2_decode(data, tmp_path),
                                      err_msg=name)
    with pytest.raises(NotSupportedError, match="'XyZw'"):  # an unknown critical chunk
        png.decode(make_png(px, 0, extra=_chunk(b"XyZw", b"x")))
    for bad, what in ((make_png(px, 2, depth=4), "4-bit RGB"),
                      (make_png(px, 3), "without PLTE")):
        assert cv2_decode(bad, tmp_path) is None
        with pytest.raises(MetadataError, match=what):
            png.decode(bad)
    good = make_png(px, 0)
    broken = bytearray(good)
    broken[-20] ^= 0xFF  # inside the IDAT payload: its CRC fails
    for bad, what in ((bytes(broken), "CRC"), (b"GIF89a" + good[6:], "signature"),
                      (good[:40], "runs past|IEND|truncated")):
        with pytest.raises(MetadataError, match=what):
            png.decode(bad)
    (tmp_path / "i.png").write_bytes(cases["interlaced"])
    assert png.info(tmp_path / "i.png") == (4, 4, 8, 0)
    # the encoder takes grey, BGR and BGRA at 8 and 16 bits, nothing else
    for img in (np.arange(12, dtype=np.uint8).reshape(2, 2, 3),
                np.arange(16, dtype=np.uint16).reshape(2, 2, 4) * 4000):
        np.testing.assert_array_equal(png.decode(png.encode(img)), img)
    with pytest.raises(NotSupportedError):
        png.encode(np.zeros((2, 2, 2), np.uint8))
    with pytest.raises(NotSupportedError):
        png.encode(np.zeros((2, 2), np.float32))
    assert not png.is_png(tmp_path / "missing.png")
