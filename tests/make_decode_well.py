"""Write the JPEG-family files of ``chip_smoke.py`` phase 13's decode well
into ``tests/data/decode_well/``, with ``manifest.json``.

The card's machine has no JPEG encoder, so these four files are
committed; the four TIFF variants of the well are written by the smoke
itself (``chip_smoke.decode_well_tiffs``).  The sites are the first four
of ``benchmarks.synthetic_cell_painting_batch(384, size=256, seed=0)``,
phase 13's plate; each plane is cut to 8 bits as ``min(v >> 4, 255)``
and, for the colour variants, given R = v, G = 3v/4, B = v/2
(``chip_smoke.decode_well_colour``).  cv2 encodes every stream; the
manifest holds each file's variant, shape and dtype and the sha256 of
the reference's decode of it (``tmlibrary_tpu``'s
``ImageExtractor._read_plane``), which the smoke holds the card
machine's decode against.

Run from the repository root, on a machine with cv2 and the JAX
package::

    python tests/make_decode_well.py

It writes the same bytes on every run (cv2's encoder is deterministic,
the sites are seeded); ``tests/test_torch_decode.py`` checks that the
committed files decode to the manifest's digests.
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
from tmlibrary_tpu_torch import container_writers  # noqa: E402

#: phase 13's plate: its first 4 sites are the decode well's
PLATE_SITES, SIZE = 384, 256
#: the JPEG-in-TIFF's tiles, multiples of 16 that leave edge tiles at 256
JPEG_TIFF_TILE = (112, 96)
QUALITY = 90


def well_sites(n: int = PLATE_SITES, size: int = SIZE) -> dict:
    """The first 4 sites of the seeded plate, uint16 as phase 13 casts them."""
    from tmlibrary_tpu_torch import benchmarks

    data = benchmarks.synthetic_cell_painting_batch(n, size=size, seed=0)
    return {ch: data[ch][:4].astype(np.uint16) for ch in ("DAPI", "Actin")}


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

    def v8(p):
        return np.minimum(p >> 4, 255).astype(np.uint8)

    def bgr(v):
        r, g, b = chip_smoke.decode_well_colour(v)
        return np.stack([b, g, r], -1)

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


def reference_decode(path: Path, size: int) -> np.ndarray:
    """The JAX package's plane of ``path``, as its imextract reads it."""
    from tmlibrary_tpu.workflow.steps.imextract import ImageExtractor

    return ImageExtractor._read_plane(str(path), None, size, size)


def manifest_entry(path: Path, site: int, channel: str, variant: str, size: int) -> dict:
    plane = reference_decode(path, size)
    return {"file": path.name, "site": site, "channel": channel, "variant": variant,
            "shape": list(plane.shape), "dtype": str(plane.dtype),
            "sha256": hashlib.sha256(np.ascontiguousarray(plane).tobytes()).hexdigest()}


def main() -> int:
    out_dir = chip_smoke.DECODE_WELL_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    files = jpeg_family(well_sites())
    entries = []
    for (site, channel), (name, variant) in sorted(chip_smoke.DECODE_WELL.items()):
        if name not in files:
            continue
        (out_dir / name).write_bytes(files[name])
        entries.append(manifest_entry(out_dir / name, site, channel, variant, SIZE))
    (out_dir / "manifest.json").write_text(json.dumps(
        {"source": "the first 4 sites of benchmarks.synthetic_cell_painting_batch(384, "
                   "size=256, seed=0), cut to 8 bits as min(v >> 4, 255)",
         "files": entries}, indent=1) + "\n")
    total = sum((out_dir / e["file"]).stat().st_size for e in entries)
    print(f"wrote {len(entries)} files ({total} bytes) and manifest.json to {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
