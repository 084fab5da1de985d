"""The PNG, TIFF, BMP and Netpbm images cv2 reads that the port refused
until now, decoded by the port's own codecs (``io/png.py``,
``readers.decode_tiff_page``, ``io/bmp.py``, ``io/pnm.py``,
``csrc/host/raster.cpp``) against the reference on the CPU: ``cv2.imread
(path, IMREAD_UNCHANGED)`` (OpenCV 5.0.0, libpng 1.6.58, libtiff 4.7.1)
behind ``tmlibrary_tpu.readers.ImageReader.read``,
``ImageExtractor._read_plane`` and the metaconfig probe
(``metaconfig.py:365-371``: ``cv2.imread(...).shape[:2]``, or a refusal
where cv2 returns None).

The fixtures come from seeded writers here (PNG of every colour type and
depth, plain and Adam7; BMP of every depth, RLE4/RLE8 with runs,
absolute runs, deltas, ends of line and of bitmap, top-down and OS/2;
PBM/PGM/PPM ASCII and binary, PAM) and from ``container_writers.write_tiff``
with explicit tags (orientation 1-8, 1/2/4/10/12/14/24-bit samples,
YCbCr without JPEG and its subsamplings, CMYK, CIELab, grey of 3 or 4
samples, planar MinIsWhite grey with alpha, a JPEG strip smaller than its
segment).  Held bit for bit (dtype and shape too); where cv2 returns None
the port raises ``MetadataError`` naming the file.  One case is held
against a refusal (ROADMAP C): a 4x4-subsampled YCbCr strip page whose
units libtiff reads from memory it never wrote (a clipped 4x4 tile,
which libtiff misreads deterministically, is held to cv2).  Sizes at
most 96x96.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from tmlibrary_tpu import readers as j_readers
from tmlibrary_tpu.workflow.steps.imextract import ImageExtractor as JExtractor
from tmlibrary_tpu_torch import readers
from tmlibrary_tpu_torch.container_writers import write_tiff
from tmlibrary_tpu_torch.errors import MetadataError, NotSupportedError
from tmlibrary_tpu_torch.io import bmp, png, pnm
from tmlibrary_tpu_torch.workflow.steps.imextract import ImageExtractor
from tmlibrary_tpu_torch.workflow.steps.metaconfig import probe_shape

torch.set_num_threads(1)

SHAPES = [(1, 1), (5, 7), (12, 12), (37, 53), (20, 30)]


# --------------------------------------------------------------- holds
def cv2_read(path):
    try:
        return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    except cv2.error:
        return None


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 -- a refusal on either side
        return e


def reference_probe(path):
    """The reference metaconfig's site-shape probe (``metaconfig.py:365-371``)."""
    dims = j_readers.container_dimensions(str(path))
    if dims is not None:
        return tuple(dims)
    img = cv2_read(path)
    if img is None:
        raise MetadataError(f"cannot read probe image {path}")
    return img.shape[:2]


def hold(path, decode=None):
    """The port against the reference on ``path``: the format's decoder
    (``decode``, default the TIFF page) against ``cv2.imread``, then
    ``ImageReader.read``, ``ImageExtractor._read_plane`` and the probe
    against the reference's; each refusal on the port's side a
    ``MetadataError`` naming the file.  Returns ``"equal"`` or
    ``"refused"``."""
    want = cv2_read(path)
    decode = decode or (lambda p: readers.read_tiff_page_cv2(p, 0))
    got = _outcome(lambda: decode(path))
    if want is None:
        assert isinstance(got, (MetadataError, NotSupportedError)), (path, got)
    else:
        assert isinstance(got, np.ndarray), (path, got)
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=str(path))
    h, w = (want.shape[:2] if want is not None else (1, 1))
    for port_fn, ref_fn in (
            (lambda: readers.ImageReader(path).read(0),
             lambda: j_readers.ImageReader(path).read(0)),
            (lambda: ImageExtractor._read_plane(str(path), None, h, w),
             lambda: JExtractor._read_plane(str(path), None, h, w)),
            (lambda: probe_shape(str(path)), lambda: reference_probe(path))):
        mine, ref = _outcome(port_fn), _outcome(ref_fn)
        if isinstance(ref, Exception):
            assert isinstance(mine, MetadataError), (path, mine, ref)
            assert path.name in str(mine), mine
        else:
            assert not isinstance(mine, Exception), (path, mine)
            if isinstance(ref, tuple):
                assert tuple(mine) == tuple(ref), path
            else:
                assert mine.dtype == ref.dtype and mine.shape == ref.shape, path
                np.testing.assert_array_equal(mine, ref, err_msg=str(path))
    return "refused" if want is None else "equal"


# ---------------------------------------------------------------- PNG
def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _filter(kind: int, row: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    x, up = row.astype(np.int32), prior.astype(np.int32)
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


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """``(rows, n)`` samples as PNG rows of ``depth`` bits a sample."""
    if depth == 16:
        return np.ascontiguousarray(samples, ">u2").view(np.uint8).reshape(len(samples), -1)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = ((samples[:, :, None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(len(samples), -1), axis=1)


def write_png(img: np.ndarray, ctype: int, depth: int, interlace: int = 0,
              filters=(0, 1, 2, 3, 4), extra: bytes = b"") -> bytes:
    """A PNG of ``img`` (samples in the file's order) at ``depth`` bits,
    Adam7 pass by pass when ``interlace``, cycling the filter types over
    the rows of every pass; ``extra`` chunks before the image data."""
    h, w = img.shape[:2]
    spp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    px = np.asarray(img).reshape(h, w, spp)
    bpp = max(1, depth * spp // 8)
    raw, k = bytearray(), 0
    for x0, y0, dx, dy in (png.ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = px[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack_rows(sub.reshape(sub.shape[0], -1).astype(np.int64), depth)
        prior = np.zeros(rows.shape[1], np.uint8)
        for r in rows:
            f = filters[k % len(filters)]
            k += 1
            raw.append(f)
            raw += _filter(f, r, prior, bpp).tobytes()
            prior = r
    return (png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                         interlace))
            + extra + _chunk(b"IDAT", zlib.compress(bytes(raw))) + _chunk(b"IEND", b""))


def png_variants(rng, ctype: int, depth: int, shape) -> list:
    """``(name, bytes)`` of a seeded image of this colour type and depth,
    with the ``tRNS`` and palette variants libpng treats apart."""
    h, w = shape
    spp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    img = rng.integers(0, 1 << depth, (h, w, spp))
    if ctype != 3:
        out = [("plain", img, b"")]
        if ctype == 0:
            out.append(("tRNS", img, _chunk(b"tRNS", struct.pack(">H", int(img[0, 0, 0])))))
        if ctype == 2:
            out.append(("tRNS", img, _chunk(b"tRNS", struct.pack(">3H", *map(int, img[0, 0])))))
            out.append(("tRNS of 2 bytes, dropped", img, _chunk(b"tRNS", b"\0\1")))
        return out
    n = int(rng.integers(1, (1 << depth) + 1))
    plte = _chunk(b"PLTE", rng.integers(0, 256, 3 * n).astype(np.uint8).tobytes())
    trns = _chunk(b"tRNS", rng.integers(0, 256, max(1, n // 2)).astype(np.uint8).tobytes())
    return [("palette", img, plte), ("palette and tRNS", img, plte + trns),
            ("tRNS before PLTE, dropped", img, trns + plte),
            ("tRNS past the palette, dropped", img,
             plte + _chunk(b"tRNS", bytes(range(n + 1))) if n < 256 else plte)]


@pytest.mark.parametrize("ctype, depth", [(c, d) for c, ds in sorted(png.DEPTHS.items())
                                          for d in ds])
@pytest.mark.parametrize("interlace", [0, 1])
def test_every_png_colour_type_and_depth_decodes_as_cv2(tmp_path, ctype, depth, interlace):
    """Palette at 1, 2, 4 and 8 bits with and without ``tRNS`` (BGR, or
    BGRA), grey at 1, 2 and 4 bits (expanded as libpng expands them),
    ``tRNS`` on grey (dropped) and RGB (the key colour transparent) at 8
    and 16 bits, each plain and Adam7 (pass by pass, every filter type),
    at shapes where Adam7's passes are empty."""
    rng = np.random.default_rng(ctype * 100 + depth * 2 + interlace)
    for shape in SHAPES:
        for name, img, extra in png_variants(rng, ctype, depth, shape):
            path = tmp_path / f"c{shape[0]}x{shape[1]}.png"
            path.write_bytes(write_png(img, ctype, depth, interlace, extra=extra))
            assert hold(path, png.read) == "equal", (name, shape)
            assert png.info(path) == (*shape, depth, ctype)


# --------------------------------------------------------------- TIFF
def tiff_case(tmp_path, name, pages, **kw):
    path = tmp_path / f"{name}.tif"
    write_tiff(path, pages, **kw)
    return hold(path)


LAYOUTS = {"strips": dict(rows_per_strip=3), "tiles": dict(tile=(16, 16)),
           "edge tiles": dict(tile=(8, 16))}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype", ["u1", "u2", "f4"])
def test_tiff_orientations_flip_as_cv2(tmp_path, layout, dtype):
    """Orientation 1-8 at 8 and 16 bits and float, grey and RGB, strips,
    whole and edge tiles: 2-4 flipped as cv2 flips them (through libtiff's
    RGBA interface a horizontal flip acts within each tile), 5-8 turned on
    square pages and refused elsewhere, as cv2 5.0 returns None there."""
    rng = np.random.default_rng(len(layout) + len(dtype))
    held = set()
    for shape in ((12, 12), (20, 30)):
        for spp in (1, 3):
            for o in range(1, 9):
                img = rng.integers(0, 250, shape + (spp,)).astype(dtype)
                held.add(tiff_case(tmp_path, f"o{o}_{spp}_{shape[1]}", [img[..., 0] if spp == 1
                                                                       else img],
                                   orientation=o, **LAYOUTS[layout]))
    assert held == {"equal", "refused"}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tiff_sub_byte_and_odd_depths_decode_as_cv2(tmp_path, layout):
    """1-, 2- and 4-bit grey (MinIsBlack and MinIsWhite) and palette pages
    (cv2 reads 1-bit grey as 0/255, 1-bit palette as the grey of its
    colours, 4-bit palette as BGR and refuses the rest), 10-, 12-, 14-bit
    grey, RGB, RGBA and grey of 3 or 4 samples (shifted to the top of 16
    bits), 24-bit samples (refused), on strips and tiles, 1-bit and 4-bit
    pages under Orientation 3 too."""
    rng = np.random.default_rng(len(layout))
    lay = LAYOUTS[layout]
    seen = set()
    for shape in ((5, 7), (20, 30)):
        for bits in (1, 2, 4):
            for phot in (0, 1, 3):
                v = rng.integers(0, 1 << bits, shape)
                cmap = rng.integers(0, 1 << 16, (3, 1 << bits)) if phot == 3 else None
                for o in (1, 3):
                    seen.add(tiff_case(tmp_path, f"b{bits}_{phot}_{o}", [v.astype(np.uint8)],
                                       photometric=phot, bits=bits, colormap=cmap,
                                       orientation=o, **lay))
        for bits in (10, 12, 14, 24):
            for phot, spp, extra in ((1, 1, None), (0, 1, None), (2, 3, None), (2, 4, [2]),
                                     (1, 3, None), (1, 4, [0]), (3, 1, None), (1, 2, [2])):
                v = rng.integers(0, 1 << bits, shape + (spp,)).astype(np.uint32)
                cmap = rng.integers(0, 1 << 16, (3, 1 << bits)) if phot == 3 and bits < 24 \
                    else None
                seen.add(tiff_case(tmp_path, f"b{bits}_{phot}_{spp}",
                                   [v[..., 0] if spp == 1 else v], photometric=phot, bits=bits,
                                   colormap=cmap, extra_samples=extra, **lay))
    assert seen == {"equal", "refused"}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tiff_ycbcr_cmyk_and_lab_decode_as_cv2(tmp_path, layout):
    """YCbCr without JPEG at every subsampling libtiff's put routines take
    (and 1x4, which cv2 refuses), with default and explicit
    YCbCrCoefficients/ReferenceBlackWhite, deflated too, planar 1x1;
    CMYK chunky and planar (InkSet 2 refused); CIELab at 8 and 16 bits
    (planar refused), as libtiff's tif_color.c converts them."""
    rng = np.random.default_rng(len(layout) + 7)
    lay = LAYOUTS[layout]
    for shape in ((5, 7), (12, 12), (16, 32)):
        ycc = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
        for sub in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2), (4, 4), (1, 4)):
            for comp in (1, 8):
                path = tmp_path / f"y{sub}{comp}.tif"
                write_tiff(path, [ycc], photometric=6, ycbcr_subsampling=sub, compression=comp,
                           **lay)
                quirk = sub == (4, 4) and "tile" not in lay and -(-shape[1] // 4) % 2
                if quirk:  # ROADMAP C: cv2 reads unwritten memory, the port refuses it by name
                    with pytest.raises(NotSupportedError, match="4x4"):
                        readers.read_tiff_page_cv2(path, 0)
                else:
                    assert hold(path) == ("refused" if sub == (1, 4) else "equal"), (sub, shape)
        assert tiff_case(tmp_path, "ycoef", [ycc], photometric=6, ycbcr_subsampling=(2, 2),
                         extra_tags={529: (5, [2125, 10000, 7154, 10000, 721, 10000]),
                                     532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])},
                         **lay) == "equal"
        assert tiff_case(tmp_path, "yplanar", [ycc], photometric=6, ycbcr_subsampling=(1, 1),
                         planar=2, **lay) == "equal"
        cmyk = rng.integers(0, 256, shape + (4,)).astype(np.uint8)
        for planar in (1, 2):
            assert tiff_case(tmp_path, f"cmyk{planar}", [cmyk], photometric=5, planar=planar,
                             **lay) == "equal"
        assert tiff_case(tmp_path, "ink2", [cmyk], photometric=5, extra_tags={332: (3, [2])},
                         **lay) == "refused"
        for dt in ("u1", "u2"):
            lab = rng.integers(0, 256 if dt == "u1" else 1 << 16, shape + (3,)).astype(dt)
            assert tiff_case(tmp_path, f"lab{dt}", [lab], photometric=8, **lay) == "equal"
            assert tiff_case(tmp_path, f"labp{dt}", [lab], photometric=8, planar=2,
                             **lay) == "refused"


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tiff_grey_of_several_samples_decodes_as_cv2(tmp_path, layout):
    """Grey pages of 3 or 4 samples (8 bits: the first sample, MinIsWhite
    inverted; 16 bits: cv2's BGRA2Gray; 32/64 bits: colour, which
    ``cvtColor`` refuses for integers), and planar grey with alpha of
    every ExtraSamples value, MinIsWhite (not inverted there) and
    MinIsBlack, at 8 and 16 bits."""
    rng = np.random.default_rng(len(layout) + 11)
    lay = LAYOUTS[layout]
    for shape in ((5, 7), (20, 30)):
        for dt in ("u1", "u2", "i2", "f4", "u4", "f8"):
            for phot in (0, 1):
                for spp in (3, 4):
                    img = rng.integers(0, 200, shape + (spp,)).astype(dt)
                    assert tiff_case(tmp_path, f"g{dt}{phot}{spp}", [img], photometric=phot,
                                     **lay) == "equal"
        img = rng.integers(0, 250, shape + (3,)).astype(np.uint8)
        assert tiff_case(tmp_path, "g3planar", [img], photometric=1, planar=2, **lay) == "equal"
        for dt in ("u1", "u2"):
            ga = rng.integers(0, 250, shape + (2,)).astype(dt)
            for phot in (0, 1):
                for extra in ([0], [1], [2]):
                    assert tiff_case(tmp_path, f"ga{dt}{phot}{extra[0]}", [ga], photometric=phot,
                                     planar=2, extra_samples=extra, **lay) == "equal"


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("colour", [False, True])
def test_a_jpeg_strip_smaller_than_its_segment_fills_its_corner(tmp_path, tiled, colour):
    """A JPEG strip or tile shorter or narrower than its segment: libtiff
    decodes the stream's lines, the rest of the chunk stays zero."""
    rng = np.random.default_rng(int(tiled) * 2 + int(colour))
    h, w, th = 64, 80, 32
    img = rng.integers(0, 255, (h, w, 3) if colour else (h, w)).astype(np.uint8)
    for jh, jw in ((24, 80), (32, 72), (24, 64)):
        chunks = []
        for y in range(0, h, th):
            blk = img[y:y + jh, :jw]
            params = [cv2.IMWRITE_JPEG_QUALITY, 90]
            if colour:
                params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]
            chunks.append(cv2.imencode(".jpg", blk[:, :, ::-1] if colour else blk,
                                       params)[1].tobytes())
        kw = dict(photometric=6, ycbcr_subsampling=(2, 2)) if colour else dict(photometric=1)
        assert tiff_case(tmp_path, f"j{jh}x{jw}", [img], tile=(th, w) if tiled else None,
                         rows_per_strip=th, compression=7, chunks=[chunks], **kw) == "equal"


# ---------------------------------------------------------------- BMP
def _bmp_header(size: int, w: int, h: int, bpp: int, comp: int, n_palette: int) -> bytes:
    if size == 12:
        return struct.pack("<IHHHH", 12, w, h, 1, bpp)
    return struct.pack("<IiiHHIIiiII", size, w, h, 1, bpp, comp, 0, 2835, 2835, n_palette,
                       0) + bytes(size - 40)


def write_bmp(pixels: bytes, w: int, h: int, bpp: int, comp: int = 0, palette=None,
              header: int = 40, masks=None) -> bytes:
    """A BMP of already laid-out ``pixels`` (rows in file order, padded)
    under a ``header``-byte info header (12: OS/2, 3-byte palette
    entries), a ``palette`` of (B, G, R) rows and, for ``BI_BITFIELDS``,
    R, G, B ``masks`` after the header."""
    pal = b""
    if palette is not None:
        pal = np.asarray(palette, np.uint8)
        if header != 12:
            pal = np.concatenate([pal, np.zeros((len(pal), 1), np.uint8)], axis=1)
        pal = pal.tobytes()
    tail = struct.pack("<III", *masks) if masks else b""
    info = _bmp_header(header, w, h, bpp, comp, 0 if palette is None or header == 12
                       else len(palette))
    offset = 14 + len(info) + len(tail) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset) + info + tail
            + pal + pixels)


def bmp_rows(samples: np.ndarray, bpp: int, bottom_up: bool = True) -> bytes:
    """``(h, n)`` samples of ``bpp`` bits (1, 4, 8, or bytes already) as
    BMP rows padded to 4 bytes."""
    rows = samples[::-1] if bottom_up else samples
    if bpp < 8:
        rows = np.packbits(((rows[:, :, None] >> np.arange(bpp - 1, -1, -1)) & 1)
                           .astype(np.uint8).reshape(len(rows), -1), axis=1)
    rows = np.asarray(rows, np.uint8)
    pad = (-rows.shape[1]) % 4
    return np.concatenate([rows, np.zeros((len(rows), pad), np.uint8)], axis=1).tobytes()


def rle_stream(idx: np.ndarray, bits: int, rng, deltas: bool) -> bytes:
    """An RLE4/RLE8 stream of the palette indices ``idx`` (rows bottom-up
    as stored): runs of equal indices (RLE4: alternating pairs), absolute
    runs, an end of line a row, a delta now and then (skipping pixels the
    decoder then gives index 0), an end of bitmap."""
    out = bytearray()
    h, w = idx.shape
    rows = idx[::-1]
    y = 0
    while y < h:
        row, x = rows[y], 0
        while x < w:
            if deltas and x == 0 and y + 1 < h and rng.random() < 0.2:
                dx, dy = int(rng.integers(0, w)), 1
                out += bytes([0, 2, dx, dy])
                y += dy
                row, x = rows[y], dx
                continue
            n = int(rng.integers(1, 9))
            n = min(n, w - x, 255)
            seg = row[x:x + n]
            if n >= 3 and rng.random() < 0.5:  # absolute
                if bits == 8:
                    data = bytes(seg.astype(np.uint8))
                else:
                    padded = np.concatenate([seg, [0] * (n % 2)]).astype(np.uint8)
                    data = bytes((padded[0::2] << 4) | padded[1::2])
                data += bytes((-len(data)) % 2)
                out += bytes([0, n]) + data
            else:
                if bits == 8:
                    out += bytes([n, int(seg[0])])
                else:
                    pair = (int(seg[0]) << 4) | int(seg[1] if n > 1 else 0)
                    out += bytes([n, pair])
            x += n
        out += b"\0\0"  # end of line
        y += 1
    return bytes(out + b"\0\1")


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (20, 30), (37, 53)])
def test_bmp_of_every_depth_decodes_as_cv2(tmp_path, shape):
    """1-, 4- and 8-bit palettes (grey ones give one channel), RLE4 and
    RLE8 (with deltas), 16-bit 5-5-5 (``BI_RGB`` and masks) and 5-6-5,
    24-bit, 32-bit ``BI_RGB`` (alpha dropped) and ``BI_BITFIELDS`` (BGRA),
    bottom-up and top-down, 40-, 108- and 124-byte headers, OS/2 bitmaps,
    and what cv2 refuses (16-bit masks other than 5-5-5/5-6-5, 2-bit)."""
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    h, w = shape
    files = {}
    for bpp in (1, 4, 8):
        n = 1 << bpp
        grey = np.repeat(rng.integers(0, 256, (n, 1)), 3, axis=1)
        colour = rng.integers(0, 256, (n, 3))
        idx = rng.integers(0, n, shape)
        for name, pal in (("grey", grey), ("colour", colour)):
            for header in (40, 124, 12):
                for top_down in (False, True) if header != 12 else (False,):
                    files[f"p{bpp}{name}{header}{top_down}.bmp"] = write_bmp(
                        bmp_rows(idx, bpp, not top_down), w, -h if top_down else h, bpp,
                        palette=pal, header=header)
        if bpp in (4, 8):
            for name, pal in (("grey", grey), ("colour", colour)):
                for deltas in (False, True):
                    stream = rle_stream(idx, bpp, rng, deltas)
                    files[f"rle{bpp}{name}{deltas}.bmp"] = write_bmp(
                        stream, w, h, bpp, comp=2 if bpp == 4 else 1, palette=pal)
    px16 = rng.integers(0, 1 << 16, shape).astype("<u2")
    rows16 = bmp_rows(px16.view(np.uint8).reshape(h, -1), 8)
    files["555.bmp"] = write_bmp(rows16, w, h, 16)
    files["555m.bmp"] = write_bmp(rows16, w, h, 16, comp=3, masks=(0x7C00, 0x3E0, 0x1F))
    files["565.bmp"] = write_bmp(rows16, w, h, 16, comp=3, masks=(0xF800, 0x7E0, 0x1F))
    files["444m.bmp"] = write_bmp(rows16, w, h, 16, comp=3, masks=(0xF00, 0xF0, 0xF))
    for ch in (3, 4):
        px = rng.integers(0, 256, shape + (ch,)).astype(np.uint8)
        rows = bmp_rows(px.reshape(h, -1), 8)
        for top_down in (False, True):
            rows = bmp_rows(px.reshape(h, -1), 8, not top_down)
            files[f"{ch * 8}{top_down}.bmp"] = write_bmp(rows, w, -h if top_down else h, ch * 8)
            files[f"{ch * 8}os2{top_down}.bmp"] = write_bmp(rows, w, h, ch * 8, header=12)
        if ch == 4:
            files["32m.bmp"] = write_bmp(rows, w, h, 32, comp=3, masks=(0xFF0000, 0xFF00, 0xFF))
            files["32v4.bmp"] = write_bmp(rows, w, h, 32, comp=3, header=108)
    files["2bit.bmp"] = write_bmp(bmp_rows(rng.integers(0, 4, shape), 2), w, h, 2,
                                  palette=rng.integers(0, 256, (4, 3)))
    outcomes = set()
    for name, data in files.items():
        path = tmp_path / name
        path.write_bytes(data)
        outcomes.add(hold(path, bmp.read))
    assert outcomes == {"equal", "refused"}


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (37, 53)])
def test_bmp_writes_read_back_as_cv2_writes(tmp_path, shape):
    """The port's BMP bytes are cv2's (grey with its palette, BGR, BGRA
    under the 124-byte header) and decode to the array."""
    rng = np.random.default_rng(shape[1])
    for ch in (1, 3, 4):
        img = rng.integers(0, 256, shape + ((ch,) if ch > 1 else ())).astype(np.uint8)
        data = bmp.encode(img)
        assert data == cv2.imencode(".bmp", img)[1].tobytes()
        np.testing.assert_array_equal(bmp.decode(data), img)


# ------------------------------------------------------------- Netpbm
def netpbm_files(rng, shape) -> dict:
    """Seeded P1-P7 files: ASCII and binary, 8 and 16 bits, maxvals under
    255, values past maxval, comments, and what cv2 refuses (an ASCII file
    that ends on its last digit, maxval 0, a PAM of a depth its type does
    not take)."""
    h, w = shape
    out = {}

    def ascii_rows(vals, width):
        lines = [" ".join(map(str, r)) for r in vals.reshape(h, -1)]
        return ("\n".join(lines) + "\n").encode()

    bits = rng.integers(0, 2, shape)
    out["p1.pbm"] = f"P1\n# a comment\n{w} {h}\n".encode() + ascii_rows(bits, w)
    out["p1tight.pbm"] = f"P1\n{w} {h}\n".encode() + "".join(map(str, bits.ravel())).encode()
    out["p4.pbm"] = f"P4\n{w} {h}\n".encode() + np.packbits(bits, axis=1).tobytes()
    for maxval in (1, 100, 255, 1000, 65535):
        vals = rng.integers(0, maxval + 1, shape)
        over = np.minimum(vals + (vals % 3 == 0) * 7, 65535)
        wide = maxval > 255
        raw = np.ascontiguousarray(vals, ">u2" if wide else np.uint8).tobytes()
        out[f"p2_{maxval}.pgm"] = f"P2\n{w} {h}\n{maxval}\n".encode() + ascii_rows(over, w)
        out[f"p5_{maxval}.pgm"] = f"P5 {w} {h} {maxval}\n".encode() + raw
        rgb = rng.integers(0, maxval + 1, shape + (3,))
        raw3 = np.ascontiguousarray(rgb, ">u2" if wide else np.uint8).tobytes()
        out[f"p3_{maxval}.ppm"] = f"P3\n{w} {h}\n#c\n{maxval}\n".encode() + ascii_rows(rgb, w * 3)
        out[f"p6_{maxval}.ppm"] = f"P6\n{w} {h}\n{maxval}\n".encode() + raw3
    out["p2_end.pgm"] = f"P2\n{w} {h}\n255\n".encode() + ascii_rows(
        rng.integers(0, 256, shape), w)[:-1]
    out["p5_maxval0.pgm"] = f"P5\n{w} {h}\n0\n".encode() + bytes(h * w)
    out["p5_short.pgm"] = f"P5\n{w} {h}\n255\n".encode() + bytes(h * w - 1)
    for tupl, depth in (("GRAYSCALE", 1), ("GRAYSCALE_ALPHA", 2), ("RGB", 3), ("RGB_ALPHA", 4),
                        (None, 1), (None, 3), (None, 4), (None, 2), ("GRAYSCALE", 3)):
        for maxval in (255, 100, 65535):
            vals = rng.integers(0, maxval + 1, shape + (depth,))
            raw = np.ascontiguousarray(vals, ">u2" if maxval > 255 else np.uint8).tobytes()
            head = f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {depth}\nMAXVAL {maxval}\n" + (
                f"TUPLTYPE {tupl}\n" if tupl else "") + "ENDHDR\n"
            out[f"p7_{tupl}_{depth}_{maxval}.pam"] = head.encode() + raw
    bw = rng.integers(0, 256, shape).astype(np.uint8)
    out["p7_bw.pam"] = (f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH 1\nMAXVAL 1\nTUPLTYPE BLACKANDWHITE\n"
                        f"ENDHDR\n").encode() + bw.tobytes()
    return out


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (20, 30)])
def test_netpbm_files_decode_as_cv2(tmp_path, shape):
    """Every P1-P7 variant of :func:`netpbm_files` against cv2 and the
    reference's readers; colour ones convert to grey as ``cvtColor``
    converts them, a 2-channel PAM raises on both sides."""
    rng = np.random.default_rng(shape[0] + shape[1])
    outcomes = set()
    for name, data in netpbm_files(rng, shape).items():
        path = tmp_path / name
        path.write_bytes(data)
        outcomes.add(hold(path, pnm.read))
    assert outcomes == {"equal", "refused"}


def test_bmp_and_netpbm_sites_reach_imextract_and_the_probe(tmp_path):
    """A directory of BMP and PGM sites (by ``pattern``) through both
    packages' metaconfig and imextract: the same site shape, the same
    planes; a GIF is still refused by name."""
    from tmlibrary_tpu_torch.workflow.steps.imextract import _unreadable

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (24, 40)).astype(np.uint8)
    (tmp_path / "a.bmp").write_bytes(bmp.encode(img))
    (tmp_path / "a.pgm").write_bytes(pnm.encode(img.astype(np.uint16) * 250, 5))
    for name in ("a.bmp", "a.pgm"):
        path = tmp_path / name
        assert probe_shape(str(path)) == reference_probe(path) == (24, 40)
        np.testing.assert_array_equal(ImageExtractor._read_plane(str(path), None, 24, 40),
                                      JExtractor._read_plane(str(path), None, 24, 40))
    (tmp_path / "g.gif").write_bytes(b"GIF89a" + bytes(20))
    assert "GIF" in str(_unreadable(str(tmp_path / "g.gif"), None))
