"""Write the committed files of ``chip_smoke.py`` phase 13's decode well
into ``tests/data/decode_well/``, with ``manifest.json``.

The card's machine has no cv2 and no JAX package, so what only cv2 (or a
writer here) can make is committed, and every digest is: the JPEG family
of sites 2-3 (encoded by cv2), the 8-bit palette PNG and the 16-bit Adam7
PNG of site 4, the RLE4 BMP of site 6 (written here) and the JPEG streams
of sites 9-12 and 14 that the port's encoder does not write (arithmetic-
coded and lossless by ``tests/jpeg_streams.py``, CMYK and YCCK by Pillow,
progressive streams cut short).  The smoke writes the rest itself: the
four TIFFs of sites 0-1 (``chip_smoke.decode_well_tiffs``, held to their
pixels), and the TIFFs, PGM, PPM and JPEGs of sites 5-8 and the SGILog
TIFFs of sites 12-14 (``chip_smoke.decode_well_port_files``, with the
port's ``ImageWriter`` and ``container_writers.write_sgilog_tiff``), which
this script writes the same way to take their digests.  The sites are the
first 15 of ``benchmarks.synthetic_cell_painting_batch(384, size=256,
seed=0)``, phase 13's plate; 8-bit variants cut each plane as ``min(v >>
4, 255)`` and colour ones give it R = v, G = 3v/4, B = v/2
(``chip_smoke.decode_well_colour``).  The manifest holds each file of
sites 2-14 with its variant, whether it is committed, the shape, dtype and
sha256 of the reference's decode of it (``tmlibrary_tpu``'s
``ImageExtractor._read_plane``; for a float decode also
``stored_sha256``, that of the uint16 plane imextract stores), and for
the port's JPEGs the sha256 of ``cv2.imencode``'s stream of the same
array, which the smoke holds the card machine's files against.

Run from the repository root, on a machine with cv2, Pillow and the JAX
package::

    python tests/make_decode_well.py

It writes the same bytes on every run (cv2's and Pillow's encoders are
deterministic, the sites are seeded); ``tests/test_torch_decode.py``
checks that the committed files and the smoke's decode to the manifest.
"""

from __future__ import annotations

import hashlib
import json
import struct
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from tmlibrary_tpu_torch import container_writers, writers  # noqa: E402

#: phase 13's plate: its first 15 sites are the decode well's
PLATE_SITES, SIZE, WELL_SITES = 384, 256, 15
#: the JPEG-in-TIFF's tiles, multiples of 16 that leave edge tiles at 256
JPEG_TIFF_TILE = (112, 96)
QUALITY = 90


def well_sites(n: int = PLATE_SITES, size: int = SIZE) -> dict:
    """The first 15 sites of the seeded plate, uint16 as phase 13 casts them."""
    from tmlibrary_tpu_torch import benchmarks

    data = benchmarks.synthetic_cell_painting_batch(n, size=size, seed=0)
    return {ch: data[ch][:WELL_SITES].astype(np.uint16) for ch in ("DAPI", "Actin")}


def split_tables(stream: bytes) -> tuple[bytes, bytes]:
    """A JPEG stream as ``(JPEGTables, abbreviated stream)``: the DQT and
    DHT segments move to a tables-only stream, as libtiff writes them."""
    segs, at = [], 2
    while stream[at + 1] != 0xDA:
        (length,) = struct.unpack(">H", stream[at + 2:at + 4])
        segs.append((stream[at + 1], stream[at:at + 2 + length]))
        at += 2 + length
    tables = b"\xff\xd8" + b"".join(s for m, s in segs if m in (0xDB, 0xC4)) + b"\xff\xd9"
    rest = b"\xff\xd8" + b"".join(s for m, s in segs if m not in (0xDB, 0xC4)) + stream[at:]
    return tables, rest


def jpeg_family(px: dict) -> dict:
    """File name -> bytes of the well's JPEG-family variants (sites 2 and
    3 of ``px``), encoded by cv2."""
    import cv2

    v8, bgr = chip_smoke.decode_well_v8, chip_smoke.decode_well_bgr

    def enc(img, *params):
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, QUALITY, *params])
        assert ok
        return buf.tobytes()

    names = {k: v[0] for k, v in chip_smoke.DECODE_WELL.items()}
    out = {
        names[2, "DAPI"]: enc(bgr(v8(px["DAPI"][2])), cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                              cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
        names[2, "Actin"]: enc(v8(px["Actin"][2]), cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
        names[3, "DAPI"]: enc(bgr(v8(px["DAPI"][3])), cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                              cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                              cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 4),
    }
    # the JPEG-in-TIFF: one YCbCr 4:2:0 stream a tile, the tables apart
    img = bgr(v8(px["Actin"][3]))
    size = img.shape[0]
    th, tw = JPEG_TIFF_TILE
    tables, chunks = None, []
    for y in range(0, size, th):
        for x in range(0, size, tw):
            tile = np.zeros((th, tw, 3), np.uint8)
            blk = img[y:y + th, x:x + tw]
            tile[:blk.shape[0], :blk.shape[1]] = blk
            tables, abbreviated = split_tables(
                enc(tile, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420))
            chunks.append(abbreviated)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "t.tif"
        container_writers.write_tiff(path, [img[:, :, ::-1]], photometric=6,
                                     tile=JPEG_TIFF_TILE, compression=7,
                                     ycbcr_subsampling=(2, 2), jpeg_tables=tables,
                                     chunks=[chunks])
        out[names[3, "Actin"]] = path.read_bytes()
    return out


def rle4_stream(idx: np.ndarray) -> bytes:
    """An RLE4 stream of 4-bit palette indices ``(h, w)`` (rows bottom-up
    as a BMP stores them): a run of two or more equal pixels as one
    encoded run, three or more unequal ones as an absolute run, the rest
    as runs of one or two, an end of line after every row and an end of
    bitmap."""
    out = bytearray()
    for row in idx[::-1].tolist():
        x, w = 0, len(row)
        while x < w:
            run = 1
            while x + run < w and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 2:
                out += bytes([run, row[x] << 4 | row[x]])
                x += run
                continue
            end = x + 1  # unequal pixels up to the next run of two
            while end < w and end - x < 255 and not (end + 1 < w and row[end] == row[end + 1]):
                end += 1
            seg = row[x:end]
            if len(seg) >= 3:
                padded = seg + [0] * (len(seg) % 2)
                data = bytes(a << 4 | b for a, b in zip(padded[0::2], padded[1::2]))
                out += bytes([0, len(seg)]) + data + bytes(len(data) % 2)
            else:
                for i in range(0, len(seg), 2):
                    pair = seg[i:i + 2]
                    out += bytes([len(pair), pair[0] << 4 | (pair[1] if len(pair) > 1 else 0)])
            x = end
        out += b"\0\0"
    return bytes(out + b"\0\1")


def committed_family(px: dict) -> dict:
    """File name -> bytes of the well's committed PNGs (site 4) and RLE4
    BMP (site 6), written by the seeded writers of
    ``tests/test_torch_cv2_images.py``."""
    from test_torch_cv2_images import _chunk, write_bmp, write_png

    names = {k: v[0] for k, v in chip_smoke.DECODE_WELL.items()}
    grey = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    v8 = chip_smoke.decode_well_v8(px["DAPI"][4])
    idx = (chip_smoke.decode_well_v8(px["Actin"][6]) >> 4).astype(np.int64)
    size = idx.shape
    return {
        names[4, "DAPI"]: write_png(v8, 3, 8, extra=_chunk(b"PLTE", grey.tobytes())),
        names[4, "Actin"]: write_png(px["Actin"][4], 0, 16, interlace=1),
        names[6, "Actin"]: write_bmp(rle4_stream(idx), size[1], size[0], 4, comp=2,
                                     palette=grey[::17][:16]),
    }


def stream_family(px: dict) -> dict:
    """File name -> bytes of the well's JPEG streams of sites 9-12 and 14,
    which the port's encoder does not write: arithmetic-coded (sequential
    with restarts, progressive 4:2:0, 4:2:2 under DAC conditioning) and
    lossless streams by ``tests/jpeg_streams.py``, Pillow's Adobe CMYK
    stream and one read as YCCK (YCbCr of the inverted colours and K 255,
    Adobe transform 2), and progressive streams cut short, which libjpeg
    block-smooths (cv2's 4:2:0 after its DC scan, an arithmetic grey one
    after its first AC scan)."""
    import io

    import cv2
    from PIL import Image

    import jpeg_streams as js

    names = {k: v[0] for k, v in chip_smoke.DECODE_WELL.items()}
    v8, bgr = chip_smoke.decode_well_v8, chip_smoke.decode_well_bgr
    q = js.quality_table(js.STD_LUMA_Q, QUALITY)
    cq = js.quality_table(js.STD_CHROMA_Q, QUALITY)

    def grey(plane):
        geom = js.Geometry(*plane.shape, [(1, 1)])
        return geom, js.dct_coefficients(geom, [plane], [q]), [q]

    def colour(img, factors):
        ycc = cv2.cvtColor(img, cv2.COLOR_BGR2YCrCb)
        geom = js.Geometry(*img.shape[:2], factors)
        tables = [q, cq, cq]
        return geom, js.dct_coefficients(geom, [ycc[..., 0], ycc[..., 2], ycc[..., 1]],
                                         tables), tables

    def pillow_cmyk(planes) -> bytes:
        """The four planes as a stream stores them (Pillow inverts CMYK
        as it writes it, the Adobe convention)."""
        buf = io.BytesIO()
        Image.fromarray(255 - np.stack(planes, -1).astype(np.uint8), "CMYK").save(
            buf, "JPEG", quality=75)
        return buf.getvalue()

    out = {names[9, "DAPI"]: js.arith_stream(*grey(v8(px["DAPI"][9])), restart=8),
           names[9, "Actin"]: js.arith_stream(*colour(bgr(v8(px["Actin"][9])),
                                                      [(2, 2), (1, 1), (1, 1)]),
                                              progressive=True),
           names[10, "DAPI"]: js.lossless_stream([v8(px["DAPI"][10])], psv=7, pt=1,
                                                 table="optimal"),
           names[14, "Actin"]: js.arith_stream(*colour(bgr(v8(px["Actin"][14])),
                                                       [(2, 1), (1, 1), (1, 1)]),
                                               conditioning={"L": [1] * 16, "U": [4] * 16,
                                                             "K": [2] * 16})}
    r, g, b = chip_smoke.decode_well_colour(v8(px["Actin"][10]))
    k = np.full_like(r, 255)
    out[names[10, "Actin"]] = pillow_cmyk([r, g, b, k])
    inverted = 255 - bgr(v8(px["DAPI"][11]))
    ycc = cv2.cvtColor(inverted, cv2.COLOR_BGR2YCrCb)
    out[names[11, "DAPI"]] = js.set_adobe_transform(
        pillow_cmyk([ycc[..., 0], ycc[..., 2], ycc[..., 1], k]), 2)
    progressive = cv2.imencode(".jpg", bgr(v8(px["Actin"][11])), [
        cv2.IMWRITE_JPEG_QUALITY, QUALITY, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])[1].tobytes()
    out[names[11, "Actin"]] = js.cut_after_scans(progressive, 1)
    out[names[12, "DAPI"]] = js.cut_after_scans(
        js.arith_stream(*grey(v8(px["DAPI"][12])), progressive=True), 2)
    return out


def reference_decode(path: Path, size: int) -> np.ndarray:
    """The JAX package's plane of ``path``, as its imextract reads it."""
    from tmlibrary_tpu.workflow.steps.imextract import ImageExtractor

    return ImageExtractor._read_plane(str(path), None, size, size)


def manifest_entry(path: Path, site: int, channel: str, variant: str, size: int,
                   committed: bool) -> dict:
    plane = reference_decode(path, size)
    entry = {"file": path.name, "site": site, "channel": channel, "variant": variant,
             "committed": committed, "shape": list(plane.shape), "dtype": str(plane.dtype),
             "sha256": hashlib.sha256(np.ascontiguousarray(plane).tobytes()).hexdigest()}
    if plane.dtype.kind == "f":  # what imextract stores of it
        entry["stored_sha256"] = hashlib.sha256(
            np.ascontiguousarray(np.asarray(plane, np.uint16)).tobytes()).hexdigest()
    return entry


def manifest_entries(px: dict, out_dir: Path, written: Path, size: int = SIZE) -> list:
    """The manifest's entries for sites 2-14 (committed files in
    ``out_dir``, the smoke's in ``written``): the reference's decode of
    each, ``cv2.imencode``'s stream of each port-written JPEG."""
    import cv2

    jpegs = chip_smoke.decode_well_port_files(container_writers, writers, written, px)
    committed = set(jpeg_family(px)) | set(committed_family(px)) | set(stream_family(px))
    entries = []
    for (site, channel), (name, variant) in sorted(chip_smoke.DECODE_WELL.items()):
        if site < 2:
            continue
        path = (out_dir if name in committed else written) / name
        entry = manifest_entry(path, site, channel, variant, size, name in committed)
        if name in jpegs:
            ok, buf = cv2.imencode(".jpg", jpegs[name])
            assert ok
            entry["stream_sha256"] = hashlib.sha256(buf.tobytes()).hexdigest()
        entries.append(entry)
    return entries


def main() -> int:
    out_dir = chip_smoke.DECODE_WELL_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    px = well_sites()
    files = {**jpeg_family(px), **committed_family(px), **stream_family(px)}
    for name, blob in files.items():
        (out_dir / name).write_bytes(blob)
    with tempfile.TemporaryDirectory() as tmp:
        entries = manifest_entries(px, out_dir, Path(tmp))
    (out_dir / "manifest.json").write_text(json.dumps(
        {"source": "the first 15 sites of benchmarks.synthetic_cell_painting_batch(384, "
                   "size=256, seed=0), 8-bit variants cut as min(v >> 4, 255)",
         "files": entries}, indent=1) + "\n")
    total = sum((out_dir / name).stat().st_size for name in files)
    print(f"wrote {len(files)} files ({total} bytes) and manifest.json ({len(entries)} "
          f"entries) to {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
