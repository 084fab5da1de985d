"""Writers of microscope container files, for fixtures and benches.

Counterparts: the writers of the JAX package's reader tests
(``tests/test_nd2.py`` ``write_nd2``, ``tests/test_czi.py`` ``write_czi``,
``tests/test_lif.py``, ``test_dv.py``, ``test_stk.py``, ``test_lsm.py``,
``test_oib.py`` and ``test_flex.py``), copied so that the card's machine,
which cannot import those tests, writes the same bytes: ND2 (v3 chunk
map), CZI (ZISRAW; its JPEG and zstd subblocks through the port's own
codecs, so those bytes differ from the tests' ``cv2``/``zstandard``
ones), LIF, DeltaVision, MetaMorph STK, Zeiss
LSM (with the LZW encoder its compressed strips use), OLE2 compound
files, Olympus OIB/OIF and Opera FLEX.  Each writes exactly what
:mod:`tmlibrary_tpu_torch.readers` documents for its format.
:func:`write_packbits_stk` adds a single-IFD STK with a PackBits strip,
which the STK reader declines and the plain TIFF path reads.
:func:`write_ims` writes Bitplane Imaris files through the port's HDF5
writer (:mod:`tmlibrary_tpu_torch.io.hdf5`), as ``tests/test_ims.py``
does through ``h5py``, and :func:`write_jpeg_sites` a directory of grey
``.jpg`` site files.  :func:`write_tiff` writes the TIFF layouts beyond
the grey strips (tiles, colour, planar, float, JPEG chunks given whole)
with struct and zlib, for the decode of what the JAX package hands to
``cv2``, and :func:`write_sgilog_tiff` a LogL or LogLuv page in libtiff's
SGILog coding from integer codes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from tmlibrary_tpu_torch import native
from tmlibrary_tpu_torch.readers import ND2Reader


def _entry(tag, typ, count, value):
    """One classic little-endian TIFF IFD entry."""
    return struct.pack("<HHII", tag, typ, count, value)


MAGIC = 0x0ABECEDA


def _chunk(name: bytes, payload: bytes) -> bytes:
    return struct.pack("<IIQ", MAGIC, len(name), len(payload)) + name + payload


def _lv_u32(name: str, value: int) -> bytes:
    encoded = (name + "\x00").encode("utf-16-le")
    return (
        struct.pack("<BB", 3, len(name) + 1) + encoded + struct.pack("<I", value)
    )


def _lv_f64(name: str, value: float) -> bytes:
    encoded = (name + "\x00").encode("utf-16-le")
    return (
        struct.pack("<BB", 5, len(name) + 1) + encoded
        + struct.pack("<d", value)
    )


def _lv_str(name: str, value: str) -> bytes:
    encoded = (name + "\x00").encode("utf-16-le")
    return (
        struct.pack("<BB", 6, len(name) + 1) + encoded
        + (value + "\x00").encode("utf-16-le")
    )


def _lv_compound(name: str, inner: bytes) -> bytes:
    encoded = (name + "\x00").encode("utf-16-le")
    return (
        struct.pack("<BB", 11, len(name) + 1) + encoded
        + struct.pack("<IQ", 1, len(inner)) + inner
    )


def experiment_chunk(loops) -> bytes:
    """LV payload for ImageMetadataLV!: nested SLxExperiment levels,
    ``loops`` = [(eType, size)] or [(eType, size, points)] or
    [(eType, size, points, keys)] outermost first; ``points`` =
    [(y, x), ...] emits XYPosLoop stage coords in uLoopPars, ``keys``
    overrides the per-point compound names (default zero-padded)."""
    inner = b""
    for spec in reversed(loops):
        etype, size = spec[0], spec[1]
        level = _lv_u32("eType", etype) + _lv_u32("uiLoopSize", size)
        if len(spec) > 2 and spec[2] is not None:
            keys = spec[3] if len(spec) > 3 else [
                f"i{i:010d}" for i in range(len(spec[2]))
            ]
            pts = b"".join(
                _lv_compound(
                    key,
                    _lv_f64("dPosX", x) + _lv_f64("dPosY", y),
                )
                for key, (y, x) in zip(keys, spec[2])
            )
            level += _lv_compound("uLoopPars", _lv_compound("Points", pts))
        if inner:
            level += _lv_compound("ppNextLevelEx", inner)
        inner = level
    return _lv_compound("SLxExperiment", inner)


def write_nd2(path, planes: np.ndarray, timestamps=None,
              declare_sequences=None, loops=None,
              channel_names=None, compression=None) -> None:
    """``planes``: (n_seq, H, W, C) uint16.  ``declare_sequences``
    overstates ``uiSequenceCount`` to mimic an aborted acquisition.
    ``loops``: [(eType, size), ...] emits an ImageMetadataLV!
    SLxExperiment tree (outermost first).  ``compression``:
    None (raw) | "lossless" (eCompression=0, zlib payloads) |
    "lossy" (eCompression=1, which the reader must refuse)."""
    n_seq, h, w, c = planes.shape
    inner = (
        _lv_u32("uiWidth", w)
        + _lv_u32("uiHeight", h)
        + _lv_u32("uiComp", c)
        + _lv_u32("uiBpcInMemory", 16)
        + _lv_u32("uiSequenceCount", declare_sequences or n_seq)
    )
    if compression is not None:
        inner += _lv_u32(
            "eCompression", {"lossless": 0, "lossy": 1}[compression]
        )
    attr_name = ("SLxImageAttributes" + "\x00").encode("utf-16-le")
    attrs = (
        struct.pack("<BB", 11, len("SLxImageAttributes") + 1)
        + attr_name
        + struct.pack("<IQ", 5, len(inner))
        + inner
    )

    blob = bytearray()
    offsets: dict[bytes, int] = {}

    def emit(name: bytes, payload: bytes) -> None:
        offsets[name] = len(blob)
        blob.extend(_chunk(name, payload))

    emit(ND2Reader.SIG_FILE, b"\x03\x00")
    emit(b"ImageAttributesLV!", attrs)
    if loops is not None:
        emit(b"ImageMetadataLV!", experiment_chunk(loops))
    if channel_names is not None:
        plane_meta = b"".join(
            _lv_compound(f"a{i}", _lv_str("sDescription", n))
            for i, n in enumerate(channel_names)
        )
        emit(b"ImageMetadataSeqLV|0!", _lv_compound(
            "SLxPictureMetadata",
            _lv_compound("sPicturePlanes", plane_meta)))
    for s in range(n_seq):
        ts = float(timestamps[s]) if timestamps is not None else 1000.0 * s
        pixels = planes[s].tobytes()
        if compression == "lossless":
            pixels = zlib.compress(pixels)
        payload = struct.pack("<d", ts) + pixels
        emit(b"ImageDataSeq|%d!" % s, payload)

    cmap = bytearray()
    for name, off in offsets.items():
        cmap += name + struct.pack("<QQ", off, 16 + len(name))
    cmap += ND2Reader.SIG_MAP + struct.pack("<QQ", 0, 0)
    map_offset = len(blob)
    blob.extend(_chunk(ND2Reader.SIG_MAP, bytes(cmap)))
    blob.extend(struct.pack("<Q", map_offset))
    path.write_bytes(bytes(blob))


def _segment(sid: bytes, payload: bytes) -> bytes:
    header = sid.ljust(16, b"\x00") + struct.pack("<qq", len(payload), len(payload))
    return header + payload


def _czi_entry(pixel_type, file_pos, compression, dims, pyramid=0) -> bytes:
    """dims: list of (name, start, size)."""
    out = b"DV" + struct.pack("<iqii", pixel_type, file_pos, 0, compression)
    out += bytes([pyramid]) + b"\x00" * 5  # PyramidType + reserved
    out += struct.pack("<i", len(dims))
    for name, start, size in dims:
        out += name.encode().ljust(4, b"\x00")
        out += struct.pack("<iifi", start, size, float(start), size)
    return out


def metadata_xml(channel_names) -> bytes:
    chans = "".join(
        f'<Channel Id="Channel:{i}" Name="{n}"/>'
        for i, n in enumerate(channel_names)
    )
    doc = ("<ImageMetadata><Metadata><Information><Image><Dimensions>"
           f"<Channels>{chans}</Channels>"
           "</Dimensions></Image></Information></Metadata></ImageMetadata>")
    return doc.encode()


def czi_payload(plane: np.ndarray, compression: int, hilo: bool = False) -> bytes:
    """One CZI subblock's data: the plane's bytes (0), a grey baseline
    JPEG at quality 95 (1), a Zstandard frame (5, zstd0), or the zstd1
    header ``[3, 1, hilo]`` and a frame of the plane -- with ``hilo`` its
    low bytes, then its high bytes (6).  The codecs are the port's own
    (:func:`tmlibrary_tpu_torch.native.jpeg_encode`,
    :func:`~tmlibrary_tpu_torch.native.zstd_compress`), where the JAX
    package's tests call ``cv2.imencode`` and ``zstandard``
    (``tests/test_czi.py:35-60``)."""
    data = np.ascontiguousarray(plane).tobytes()
    if compression == 0:
        return data
    if compression == 1:
        return native.jpeg_encode(plane, quality=95)
    if hilo:
        a = np.frombuffer(data, "<u2")
        data = (a & 0xFF).astype(np.uint8).tobytes() + (a >> 8).astype(np.uint8).tobytes()
    frame = native.zstd_compress(data)
    return bytes([3, 1, int(hilo)]) + frame if compression == 6 else frame


def write_czi(path, planes: np.ndarray, pixel_type=1, compression=0, hilo=False, n_tiles=1,
              with_pyramid=False, global_m=False, tile_origins=None,
              channel_names=None) -> None:
    """``planes``: (S, C, H, W) uint16 — one z-plane, one tpoint.  With
    ``n_tiles`` > 1 the S axis is reinterpreted as S*M (mosaic tiles,
    S fastest-outer): planes[s*M+m] carries dims S=s, M=m.  With
    ``with_pyramid`` a half-size pyramid copy of each subblock is
    interleaved (must be skipped by the reader).  Subblocks are coded by
    :func:`czi_payload` with ``compression`` 0, 1, 5 or 6 (and ``hilo``
    for zstd1)."""
    n_sm, n_c, h, w = planes.shape
    assert n_sm % n_tiles == 0
    blob = bytearray()
    # file header segment: payload with directory position at offset 36
    file_payload = bytearray(512)
    blob.extend(_segment(b"ZISRAWFILE", bytes(file_payload)))

    def add_subblock(data, dims, pyramid=0):
        file_pos = len(blob)
        entry = _czi_entry(pixel_type, file_pos, compression, dims, pyramid)
        sub_payload = bytearray(struct.pack("<iiq", 0, 0, len(data)))
        sub_payload += entry
        pad = max(256, 16 + len(entry)) - len(sub_payload)
        sub_payload += b"\x00" * pad
        sub_payload += data
        blob.extend(_segment(b"ZISRAWSUBBLOCK", bytes(sub_payload)))
        entries.append(_czi_entry(pixel_type, file_pos, compression, dims, pyramid))

    entries = []
    for sm in range(n_sm):
        s, m = divmod(sm, n_tiles)
        for c in range(n_c):
            y0, x0 = (tile_origins[m] if tile_origins else (0, 0))
            dims = [("X", x0, w), ("Y", y0, h), ("C", c, 1), ("Z", 0, 1),
                    ("T", 0, 1), ("S", s, 1)]
            if n_tiles > 1:
                dims.append(("M", sm if global_m else m, 1))
            add_subblock(czi_payload(planes[sm, c], compression, hilo), dims)
            if with_pyramid:
                half = planes[sm, c][::2, ::2]
                pdims = [("X", 0, half.shape[1]), ("Y", 0, half.shape[0]),
                         ("C", c, 1), ("Z", 0, 1), ("T", 0, 1), ("S", s, 1)]
                add_subblock(czi_payload(half, compression, hilo), pdims, pyramid=1)

    meta_pos = 0
    if channel_names is not None:
        meta_pos = len(blob)
        xml = metadata_xml(channel_names)
        meta_payload = struct.pack("<ii", len(xml), 0) + b"\x00" * 248 + xml
        blob.extend(_segment(b"ZISRAWMETADATA", meta_payload))
    dir_pos = len(blob)
    dir_payload = struct.pack("<i", len(entries)) + b"\x00" * 124
    dir_payload += b"".join(entries)
    blob.extend(_segment(b"ZISRAWDIRECTORY", dir_payload))
    # patch DirectoryPosition (and MetadataPosition, which follows it)
    # into the file header payload at the spec offset:
    # major(4) minor(4) reserved(8) guids(32) file_part(4) = 52
    struct.pack_into("<q", blob, 32 + 52, dir_pos)
    struct.pack_into("<q", blob, 32 + 60, meta_pos)
    path.write_bytes(bytes(blob))


def _series_xml(name: str, block_id: str, h: int, w: int, n_c: int,
                n_z: int = 1, n_t: int = 1, bits: int = 16,
                lut_names=None) -> str:
    """One Element with planar channel layout: C outermost, then Z, T."""
    item = bits // 8
    plane = h * w * item
    chans = "".join(
        f'<ChannelDescription Resolution="{bits}" '
        f'BytesInc="{c * n_z * n_t * plane}"'
        + (f' LUTName="{lut_names[c]}"' if lut_names else "")
        + "/>"
        for c in range(n_c)
    )
    dims = (
        f'<DimensionDescription DimID="1" NumberOfElements="{w}" BytesInc="{item}"/>'
        f'<DimensionDescription DimID="2" NumberOfElements="{h}" BytesInc="{w * item}"/>'
    )
    if n_z > 1:
        dims += (f'<DimensionDescription DimID="3" NumberOfElements="{n_z}" '
                 f'BytesInc="{n_t * plane}"/>')
    if n_t > 1:
        dims += (f'<DimensionDescription DimID="4" NumberOfElements="{n_t}" '
                 f'BytesInc="{plane}"/>')
    size = n_c * n_z * n_t * plane
    return (
        f'<Element Name="{name}"><Data><Image><ImageDescription>'
        f"<Channels>{chans}</Channels><Dimensions>{dims}</Dimensions>"
        f"</ImageDescription></Image></Data>"
        f'<Memory Size="{size}" MemoryBlockID="{block_id}"/></Element>'
    )


def write_lif(path, series: list[np.ndarray], bits: int = 16,
              lut_names=None) -> None:
    """``series``: list of (C, Z, T, H, W) uint16 arrays (planar layout)."""
    elements = []
    for i, arr in enumerate(series):
        n_c, n_z, n_t, h, w = arr.shape
        elements.append(
            _series_xml(f"Series{i}", f"MemBlock_{i}", h, w, n_c, n_z,
                        n_t, bits, lut_names=lut_names)
        )
    xml = (
        '<LMSDataContainerHeader Version="2"><Element Name="root"><Children>'
        + "".join(elements)
        + "</Children></Element></LMSDataContainerHeader>"
    )
    xml_bytes = xml.encode("utf-16-le")
    blob = bytearray()
    header = struct.pack("<II", 0x70, 5 + len(xml_bytes)) + b"\x2a"
    header += struct.pack("<I", len(xml)) + xml_bytes
    blob += header
    for i, arr in enumerate(series):
        data = arr.astype(f"<u{bits // 8}").tobytes()
        bid = f"MemBlock_{i}".encode("utf-16-le")
        content = b"\x2a" + struct.pack("<Q", len(data))
        content += b"\x2a" + struct.pack("<I", len(f"MemBlock_{i}")) + bid
        blob += struct.pack("<II", 0x70, len(content)) + content + data
    path.write_bytes(bytes(blob))


def write_dv(path, planes, sequence=0, byte_order="<", mode=6,
             ext_size=96, declare_sections=None):
    """``planes``: (W, Z, T, H, W) uint16-ish array indexed [c][z][t]."""
    n_w, n_z, n_t, h, w = planes.shape
    nsec = declare_sections if declare_sections is not None else n_w * n_z * n_t
    header = bytearray(1024)
    struct.pack_into(f"{byte_order}4i", header, 0, w, h, nsec, mode)
    struct.pack_into(f"{byte_order}i", header, 92, ext_size)
    struct.pack_into(f"{byte_order}h", header, 96, -16224)
    struct.pack_into(f"{byte_order}h", header, 180, n_t)
    struct.pack_into(f"{byte_order}h", header, 182, sequence)
    struct.pack_into(f"{byte_order}h", header, 196, n_w)
    dtype = np.dtype(byte_order + {0: "u1", 1: "i2", 2: "f4", 6: "u2"}[mode])

    def section_index(z, c, t):
        if sequence == 0:  # ZTW
            return (c * n_t + t) * n_z + z
        if sequence == 1:  # WZT
            return (t * n_z + z) * n_w + c
        return (t * n_w + c) * n_z + z  # ZWT

    sections = [None] * (n_w * n_z * n_t)
    for c in range(n_w):
        for z in range(n_z):
            for t in range(n_t):
                sections[section_index(z, c, t)] = planes[c, z, t]
    blob = bytearray(header) + bytearray(ext_size)
    for sec in sections:
        blob += np.ascontiguousarray(sec, dtype).tobytes()
    path.write_bytes(bytes(blob))


def write_stk(path, planes, paged=False, declare_planes=None, bits=16):
    """``planes``: (Z, H, W) uint16 (or uint8 with ``bits=8``)."""
    n_z, h, w = planes.shape
    dtype = "<u2" if bits == 16 else "<u1"
    data = b"".join(np.ascontiguousarray(p, dtype).tobytes() for p in planes)
    plane_bytes = h * w * (bits // 8)
    buf = bytearray(b"II*\x00\x00\x00\x00\x00")
    if not paged:
        data_off = len(buf)
        buf += data
        uic_off = len(buf)
        n_uic = declare_planes if declare_planes is not None else n_z
        buf += b"\x00" * (8 * n_uic)  # UIC2 RATIONALs (values unused)
        entries = [
            _entry(256, 3, 1, w),
            _entry(257, 3, 1, h),
            _entry(258, 3, 1, bits),
            _entry(259, 3, 1, 1),
            _entry(262, 3, 1, 1),
            _entry(273, 4, 1, data_off),
            _entry(277, 3, 1, 1),
            _entry(278, 3, 1, h),
            _entry(279, 4, 1, plane_bytes),
            _entry(33629, 5, n_uic, uic_off),  # UIC2: count = n planes
        ]
        ifd_off = len(buf)
        buf += struct.pack("<H", len(entries)) + b"".join(entries)
        buf += b"\x00\x00\x00\x00"
        struct.pack_into("<I", buf, 4, ifd_off)
    else:
        offs = []
        for p in range(n_z):
            offs.append(len(buf))
            buf += data[p * plane_bytes:(p + 1) * plane_bytes]
        ifd_offs, next_pos = [], []
        for p in range(n_z):
            entries = [
                _entry(256, 3, 1, w),
                _entry(257, 3, 1, h),
                _entry(258, 3, 1, bits),
                _entry(259, 3, 1, 1),
                _entry(273, 4, 1, offs[p]),
                _entry(277, 3, 1, 1),
                _entry(278, 3, 1, h),
                _entry(279, 4, 1, plane_bytes),
            ]
            ifd_offs.append(len(buf))
            buf += struct.pack("<H", len(entries)) + b"".join(entries)
            next_pos.append(len(buf))
            buf += b"\x00\x00\x00\x00"
        struct.pack_into("<I", buf, 4, ifd_offs[0])
        for p in range(n_z - 1):
            struct.pack_into("<I", buf, next_pos[p], ifd_offs[p + 1])
    path.write_bytes(bytes(buf))


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW, kept in 9-bit codes by clearing early (valid, just not
    maximally compressed — decoders must honor mid-stream Clears)."""
    codes = [256]
    d = {bytes([i]): i for i in range(256)}
    nxt = 258
    w = b""
    for byte in data:
        wc = w + bytes([byte])
        if wc in d:
            w = wc
            continue
        codes.append(d[w])
        d[wc] = nxt
        nxt += 1
        w = bytes([byte])
        if nxt >= 509:  # stay below the 9->10 bit switch
            codes.append(256)
            d = {bytes([i]): i for i in range(256)}
            nxt = 258
    if w:
        codes.append(d[w])
    codes.append(257)
    acc = nbits = 0
    out = bytearray()
    for c in codes:
        acc = (acc << 9) | c
        nbits += 9
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
    if nbits:
        out.append((acc << (8 - nbits)) & 0xFF)
    return bytes(out)


def write_lsm(path, planes, compression=1, predictor=1, thumbnails=True,
              magic=0x00400494, declare_z=None):
    """``planes``: (T, Z, C, H, W) uint16."""
    n_t, n_z, n_c, h, w = planes.shape
    buf = bytearray(b"II*\x00\x00\x00\x00\x00")

    cz_off = len(buf)
    buf += struct.pack(
        "<IiiiiiI", magic, 40, w, h,
        declare_z if declare_z is not None else n_z, n_c, n_t,
    )
    buf += b"\x00" * 12  # struct tail (unread)

    thumb = np.zeros((2, 2), "<u2").tobytes()

    def encode(plane):
        arr = np.ascontiguousarray(plane, "<u2")
        if predictor == 2:
            d = arr.astype(np.int64)
            d[:, 1:] = d[:, 1:] - d[:, :-1]
            arr = (d % 65536).astype("<u2")
        raw = arr.tobytes()
        return lzw_encode(raw) if compression == 5 else raw

    ifd_offs, next_pos = [], []

    def emit_ifd(entries):
        ifd_offs.append(len(buf))
        buf.extend(struct.pack("<H", len(entries)) + b"".join(entries))
        next_pos.append(len(buf))
        buf.extend(b"\x00\x00\x00\x00")

    first = True
    for t in range(n_t):
        for z in range(n_z):
            strips = [encode(planes[t, z, c]) for c in range(n_c)]
            offs, counts = [], []
            for s in strips:
                offs.append(len(buf))
                counts.append(len(s))
                buf.extend(s)
            off_pos = len(buf)
            for o in offs:
                buf.extend(struct.pack("<I", o))
            cnt_pos = len(buf)
            for c in counts:
                buf.extend(struct.pack("<I", c))
            entries = [
                _entry(254, 4, 1, 0),
                _entry(256, 3, 1, w),
                _entry(257, 3, 1, h),
                _entry(258, 3, 1, 16),
                _entry(259, 3, 1, compression),
                _entry(262, 3, 1, 1),
                _entry(273, 4, n_c, off_pos if n_c > 1 else offs[0]),
                _entry(277, 3, 1, n_c),
                _entry(278, 3, 1, h),
                _entry(279, 4, n_c, cnt_pos if n_c > 1 else counts[0]),
                _entry(284, 3, 1, 2),
            ]
            if predictor != 1:
                entries.append(_entry(317, 3, 1, predictor))
            if first:
                entries.append(_entry(34412, 1, 40, cz_off))
                first = False
            entries.sort(key=lambda e: struct.unpack_from("<H", e)[0])
            emit_ifd(entries)
            if thumbnails:
                toff = len(buf)
                buf.extend(thumb)
                emit_ifd([
                    _entry(254, 4, 1, 1),  # reduced-resolution image
                    _entry(256, 3, 1, 2), _entry(257, 3, 1, 2),
                    _entry(258, 3, 1, 16), _entry(259, 3, 1, 1),
                    _entry(273, 4, 1, toff), _entry(277, 3, 1, 1),
                    _entry(278, 3, 1, 2), _entry(279, 4, 1, len(thumb)),
                ])
    struct.pack_into("<I", buf, 4, ifd_offs[0])
    for p in range(len(ifd_offs) - 1):
        struct.pack_into("<I", buf, next_pos[p], ifd_offs[p + 1])
    path.write_bytes(bytes(buf))


SECT = 512
MINI = 64
FREE = 0xFFFFFFFF
END = 0xFFFFFFFE
FATSECT = 0xFFFFFFFD


def tiff_bytes(plane: np.ndarray) -> bytes:
    """Minimal single-IFD little-endian grayscale TIFF."""
    h, w = plane.shape
    bits = plane.dtype.itemsize * 8
    data = np.ascontiguousarray(plane).tobytes()
    buf = bytearray(b"II*\x00\x00\x00\x00\x00")
    data_off = len(buf)
    buf += data
    entries = [
        _entry(256, 3, 1, w),
        _entry(257, 3, 1, h),
        _entry(258, 3, 1, bits),
        _entry(259, 3, 1, 1),
        _entry(262, 3, 1, 1),
        _entry(273, 4, 1, data_off),
        _entry(277, 3, 1, 1),
        _entry(278, 3, 1, h),
        _entry(279, 4, 1, len(data)),
    ]
    ifd_off = len(buf)
    buf += struct.pack("<H", len(entries)) + b"".join(entries)
    buf += b"\x00\x00\x00\x00"
    struct.pack_into("<I", buf, 4, ifd_off)
    return bytes(buf)


# ------------------------------------------------------------- CFB writer
def _pad(b: bytes, unit: int) -> bytes:
    rem = len(b) % unit
    return b + b"\x00" * (unit - rem) if rem else b


def write_cfb(files: "dict[str, bytes]", sect: int = SECT) -> bytes:
    """CFB container holding ``files`` ("Storage/Stream" paths allowed,
    one nesting level).  Streams < 4096 bytes land in the mini stream.
    ``sect``: 512 (v3, default) or 4096 (v4)."""
    assert sect in (512, 4096)
    per_fat = sect // 4
    # ---- directory tree -------------------------------------------------
    entries: list[dict] = [dict(
        name="Root Entry", type=5, left=FREE, right=FREE, child=FREE,
        start=END, size=0,
    )]
    storages: dict[str, int] = {}
    children: dict[int, list[int]] = {0: []}

    def add_entry(name, etype, parent) -> int:
        eid = len(entries)
        entries.append(dict(name=name, type=etype, left=FREE, right=FREE,
                            child=FREE, start=END, size=0))
        children.setdefault(eid, [])
        children[parent].append(eid)
        return eid

    stream_ids: dict[str, int] = {}
    for path in files:
        parent = 0
        parts = path.split("/")
        for storage in parts[:-1]:
            key = "/".join(parts[: parts.index(storage) + 1])
            if key not in storages:
                storages[key] = add_entry(storage, 1, parent)
            parent = storages[key]
        stream_ids[path] = add_entry(parts[-1], 2, parent)

    for parent, kids in children.items():
        if not kids:
            continue
        entries[parent]["child"] = kids[0]
        for a, b in zip(kids, kids[1:]):
            entries[a]["right"] = b

    # ---- payload placement ---------------------------------------------
    mini_payload = bytearray()
    minifat: list[int] = []
    large: list[tuple[str, bytes]] = []
    for path, payload in files.items():
        e = entries[stream_ids[path]]
        e["size"] = len(payload)
        if len(payload) < 4096:
            first = len(minifat)
            n = max(1, (len(payload) + MINI - 1) // MINI)
            for i in range(n):
                minifat.append(first + i + 1 if i < n - 1 else END)
            e["start"] = first
            mini_payload += _pad(payload, MINI)
        else:
            large.append((path, payload))

    dir_raw = bytearray()
    for e in entries:
        name = e["name"].encode("utf-16-le") + b"\x00\x00"
        ent = bytearray(128)
        ent[: len(name)] = name
        struct.pack_into("<H", ent, 64, len(name))
        ent[66] = e["type"]
        ent[67] = 1
        struct.pack_into("<3I", ent, 68, e["left"], e["right"], e["child"])
        struct.pack_into("<I", ent, 116, e["start"] & 0xFFFFFFFF)
        struct.pack_into("<Q", ent, 120, e["size"])
        dir_raw += ent
    n_dir = len(_pad(bytes(dir_raw), sect)) // sect

    minifat_raw = b"".join(struct.pack("<I", v) for v in minifat)
    n_minifat = len(_pad(minifat_raw, sect)) // sect if minifat else 0
    mini_raw = _pad(bytes(mini_payload), sect)
    n_mini = len(mini_raw) // sect
    n_large = [len(_pad(p, sect)) // sect for _, p in large]

    body = n_dir + n_minifat + n_mini + sum(n_large)
    n_fat = 1
    while (body + n_fat + per_fat - 1) // per_fat > n_fat:
        n_fat += 1
    total = body + n_fat

    # sector order: [FAT][dir][miniFAT][ministream][large...]
    fat = [FREE] * (n_fat * per_fat)
    nxt = 0
    for i in range(n_fat):
        fat[nxt] = FATSECT
        nxt += 1

    def place(n_sectors) -> int:
        nonlocal nxt
        start = nxt
        for i in range(n_sectors):
            fat[nxt] = nxt + 1 if i < n_sectors - 1 else END
            nxt += 1
        return start

    dir_start = place(n_dir)
    minifat_start = place(n_minifat) if n_minifat else END
    mini_start = place(n_mini) if n_mini else END
    for (path, payload), n in zip(large, n_large):
        entries[stream_ids[path]]["start"] = place(n)
    if mini_payload:
        entries[0]["start"] = mini_start
        entries[0]["size"] = len(mini_payload)

    # directory raw must be rebuilt: large-stream starts were just placed
    dir_raw = bytearray()
    for e in entries:
        name = e["name"].encode("utf-16-le") + b"\x00\x00"
        ent = bytearray(128)
        ent[: len(name)] = name
        struct.pack_into("<H", ent, 64, len(name))
        ent[66] = e["type"]
        ent[67] = 1
        struct.pack_into("<3I", ent, 68, e["left"], e["right"], e["child"])
        struct.pack_into("<I", ent, 116, e["start"] & 0xFFFFFFFF)
        struct.pack_into("<Q", ent, 120, e["size"])
        dir_raw += ent

    header = bytearray(sect)  # v3: header == one 512-byte sector; v4: padded
    header[:8] = b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1"
    struct.pack_into("<H", header, 24, 0x3E)
    struct.pack_into("<H", header, 26, 3 if sect == 512 else 4)
    struct.pack_into("<H", header, 28, 0xFFFE)
    struct.pack_into("<H", header, 30, 9 if sect == 512 else 12)
    struct.pack_into("<H", header, 32, 6)
    struct.pack_into("<I", header, 44, n_fat)
    struct.pack_into("<I", header, 48, dir_start)
    struct.pack_into("<I", header, 56, 4096)
    struct.pack_into("<I", header, 60, minifat_start)
    struct.pack_into("<I", header, 64, n_minifat)
    struct.pack_into("<I", header, 68, END)
    struct.pack_into("<I", header, 72, 0)
    for i in range(109):
        struct.pack_into("<I", header, 76 + 4 * i,
                         i if i < n_fat else FREE)

    out = bytearray(header)
    out += b"".join(struct.pack("<I", v) for v in fat)
    out += _pad(bytes(dir_raw), sect)
    if n_minifat:
        out += _pad(minifat_raw, sect)
    out += mini_raw
    for (_, payload), n in zip(large, n_large):
        out += _pad(payload, sect)
    assert len(out) == sect + total * sect
    return bytes(out)


# ------------------------------------------------------------ OIF fixture
def oif_text(w, h, c, z, t) -> str:
    lines = ["[Version Info]", 'SystemName="FLUOVIEW FV1000"']
    for i, (code, size) in enumerate(
        (("X", w), ("Y", h), ("C", c), ("Z", z), ("T", t))
    ):
        lines += [
            f"[Axis {i} Parameters Common]",
            f'AxisCode="{code}"',
            f"MaxSize={size}",
        ]
    return "\r\n".join(lines) + "\r\n"


def plane_name(c, z, t) -> str:
    return f"s_C{c + 1:03d}Z{z + 1:03d}T{t + 1:03d}.tif"


def write_oif(dirpath, stem, stack: np.ndarray):
    """``stack``: (C, Z, T, H, W) uint16 -> ``<stem>.oif`` + files dir."""
    n_c, n_z, n_t, h, w = stack.shape
    main = dirpath / f"{stem}.oif"
    main.write_bytes(
        b"\xff\xfe"
        + oif_text(w, h, n_c, n_z, n_t).encode("utf-16-le")
    )
    files = dirpath / f"{stem}.oif.files"
    files.mkdir()
    for c in range(n_c):
        for z in range(n_z):
            for t in range(n_t):
                (files / plane_name(c, z, t)).write_bytes(
                    tiff_bytes(stack[c, z, t])
                )
    return main


def write_oib(path, stack: np.ndarray, with_info=True, nested=True):
    """``stack``: (C, Z, T, H, W) -> OIB compound file."""
    n_c, n_z, n_t, h, w = stack.shape
    prefix = "Storage00001/" if nested else ""
    files: dict[str, bytes] = {}
    info_lines = ["[OibSaveInfo]", 'Version="2.0.0.0"']
    idx = 0
    for c in range(n_c):
        for z in range(n_z):
            for t in range(n_t):
                stream = f"Stream{idx:05d}" if with_info else plane_name(c, z, t)
                files[prefix + stream] = tiff_bytes(stack[c, z, t])
                if with_info:
                    info_lines.append(f"{stream}={plane_name(c, z, t)}")
                idx += 1
    main_stream = f"Stream{idx:05d}" if with_info else "main.oif"
    files[prefix + main_stream] = (
        b"\xff\xfe"
        + oif_text(w, h, n_c, n_z, n_t).encode("utf-16-le")
    )
    if with_info:
        info_lines.append(f"{main_stream}=main.oif")
        files["OibInfo.txt"] = (
            b"\xff\xfe"
            + "\r\n".join(info_lines).encode("utf-16-le")
        )
    path.write_bytes(write_cfb(files))
    return path


def flex_xml(n_fields, channel_names) -> bytes:
    arrays = []
    for _f in range(n_fields):
        for name in channel_names:
            arrays.append(f'    <Array Name="{name}"/>')
    doc = (
        '<Root xmlns="http://www.perkinelmer.com/flex">\n  <Arrays>\n'
        + "\n".join(arrays)
        + "\n  </Arrays>\n</Root>"
    )
    return doc.encode()


def write_flex(path, planes: np.ndarray, channel_names=("Exp1Cam1",),
               xml: "bytes | None" = b"auto"):
    """``planes``: (n_pages, H, W) uint16, channel-fastest page order."""
    n_pages, h, w = planes.shape
    if xml == b"auto":
        assert n_pages % len(channel_names) == 0
        xml = flex_xml(n_pages // len(channel_names), channel_names)
    buf = bytearray(b"II*\x00\x00\x00\x00\x00")
    xml_off = None
    if xml is not None:
        xml_off = len(buf)
        buf += xml
        if len(buf) % 2:
            buf += b"\x00"
    data_offs = []
    for p in range(n_pages):
        data_offs.append(len(buf))
        buf += np.ascontiguousarray(planes[p], "<u2").tobytes()
    ifd_offs = []
    next_ptr_pos = []
    for p in range(n_pages):
        entries = [
            _entry(256, 3, 1, w),
            _entry(257, 3, 1, h),
            _entry(258, 3, 1, 16),
            _entry(259, 3, 1, 1),
            _entry(262, 3, 1, 1),
            _entry(273, 4, 1, data_offs[p]),
            _entry(277, 3, 1, 1),
            _entry(278, 3, 1, h),
            _entry(279, 4, 1, h * w * 2),
        ]
        if xml_off is not None:
            entries.append(_entry(65200, 2, len(xml), xml_off))
        entries.sort(key=lambda e: struct.unpack_from("<H", e)[0])
        ifd_offs.append(len(buf))
        buf += struct.pack("<H", len(entries)) + b"".join(entries)
        next_ptr_pos.append(len(buf))
        buf += b"\x00\x00\x00\x00"
    struct.pack_into("<I", buf, 4, ifd_offs[0])
    for p in range(n_pages - 1):
        struct.pack_into("<I", buf, next_ptr_pos[p], ifd_offs[p + 1])
    path.write_bytes(bytes(buf))
    return path


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 2-128 equal bytes as one, the rest as literals."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i
        while j + 1 < n and data[j + 1] != data[j] and j - i < 127:
            j += 1
        out += bytes([j - i]) + data[i:j + 1]
        i = j + 1
    return bytes(out)


def write_packbits_stk(path, plane: np.ndarray) -> None:
    """A single-IFD STK (UIC2 count 1) whose one strip is PackBits: the
    STK reader declines a compressed single-IFD stack, so the file reads
    through the plain TIFF path.  ``plane``: (H, W) uint16."""
    h, w = plane.shape
    data = packbits_encode(np.ascontiguousarray(plane, "<u2").tobytes())
    buf = bytearray(b"II*\x00\x00\x00\x00\x00")
    data_off = len(buf)
    buf += data
    if len(buf) % 2:
        buf += b"\x00"
    uic_off = len(buf)
    buf += b"\x00" * 8
    entries = [
        _entry(256, 3, 1, w), _entry(257, 3, 1, h), _entry(258, 3, 1, 16),
        _entry(259, 3, 1, 32773), _entry(262, 3, 1, 1),
        _entry(273, 4, 1, data_off), _entry(277, 3, 1, 1),
        _entry(278, 3, 1, h), _entry(279, 4, 1, len(data)),
        _entry(33629, 5, 1, uic_off),
    ]
    ifd_off = len(buf)
    buf += struct.pack("<H", len(entries)) + b"".join(entries)
    buf += b"\x00\x00\x00\x00"
    struct.pack_into("<I", buf, 4, ifd_off)
    path.write_bytes(bytes(buf))


def write_ims(path, planes: np.ndarray, channel_names=None, pad: int = 7, chunks=None,
              compression: "str | None" = None) -> None:
    """A Bitplane Imaris ``.ims`` file through the port's HDF5 writer, as
    ``tests/test_ims.py:15-40`` writes one through ``h5py``.  ``planes``:
    (C, Z, T, H, W); each ``DataSet/ResolutionLevel 0/TimePoint t/Channel
    c/Data`` is (Z, H + pad, W + pad) with the true size in the
    byte-character attributes ``X``/``Y``/``Z`` of ``DataSetInfo/Image``
    and names in ``DataSetInfo/Channel c``.  ``chunks`` (and
    ``compression='gzip'``) store the data chunked and deflated, as
    Imaris itself writes it; otherwise it is contiguous."""
    from tmlibrary_tpu_torch.io import hdf5

    n_c, n_z, n_t, h, w = planes.shape
    root = hdf5.Group()
    info = root.require_group("DataSetInfo/Image")
    for name, val in (("X", w), ("Y", h), ("Z", n_z)):
        info.attrs[name] = np.frombuffer(str(val).encode(), dtype="S1")
    for c in range(n_c):
        g = root.require_group(f"DataSetInfo/Channel {c}")
        if channel_names:
            g.attrs["Name"] = np.frombuffer(channel_names[c].encode(), dtype="S1")
    filters = [(1, (4,))] if compression == "gzip" else []
    for t in range(n_t):
        for c in range(n_c):
            padded = np.zeros((n_z, h + pad, w + pad), planes.dtype)
            padded[:, :h, :w] = planes[c, :, t]
            root.put(f"DataSet/ResolutionLevel 0/TimePoint {t}/Channel {c}/Data",
                     hdf5.Dataset(padded, chunks=chunks, filters=filters if chunks else ()))
    hdf5.write(path, root)


def write_jpeg_sites(directory, planes: "dict[tuple[str, int, str], np.ndarray]") -> None:
    """Grey ``.jpg`` site files, ``<well>_s<site>_<channel>.jpg`` (the
    default filename style with the JPEG suffix), each a baseline JPEG of
    its uint8 plane by the port's encoder at quality 95; ``planes`` maps ``(well, site,
    channel)`` to the plane."""
    from pathlib import Path

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    for (well, site, channel), plane in planes.items():
        (directory / f"{well}_s{site}_{channel}.jpg").write_bytes(
            native.jpeg_encode(plane))


def _pack_bits(block, bits: int) -> bytes:
    """A ``(rows, cols, samples)`` chunk of integers packed at ``bits``
    a sample, most significant bit first, each row from a byte."""
    rows = block.shape[0]
    v = np.asarray(block, np.uint64).reshape(rows, -1)
    shifts = np.arange(bits - 1, -1, -1, dtype=np.uint64)
    bitplane = ((v[:, :, None] >> shifts) & np.uint64(1)).astype(np.uint8).reshape(rows, -1)
    return np.packbits(bitplane, axis=1).tobytes()


def _ycbcr_units(block, hs: int, vs: int) -> bytes:
    """A ``(rows, cols, 3)`` chunk of Y, Cb, Cr as TIFF's data units:
    ``hs * vs`` luma samples, then the Cb and Cr of the unit's top-left
    pixel, units in raster order (edge units padded by repetition)."""
    rows, cols = block.shape[:2]
    uy, ux = -(-rows // vs), -(-cols // hs)
    pad = np.pad(np.asarray(block, np.uint8), ((0, uy * vs - rows), (0, ux * hs - cols), (0, 0)),
                 mode="edge")
    y = pad[:, :, 0].reshape(uy, vs, ux, hs).transpose(0, 2, 1, 3).reshape(uy, ux, vs * hs)
    chroma = pad[::vs, ::hs, 1:]
    return np.concatenate([y, chroma], axis=2).tobytes()


def _tiff_predict(block, predictor: int, spp: int, bo: str):
    """Horizontal (2) or floating-point (3) differencing of a chunk's rows:
    ``block`` is ``(rows, cols, spp)``; returns the chunk's bytes."""
    rows, cols, _ = block.shape
    if predictor == 2:
        u = block.view(np.dtype(f"u{block.dtype.itemsize}"))
        d = u.copy()
        d[:, 1:] = u[:, 1:] - u[:, :-1]
        return d.astype(d.dtype.newbyteorder(bo)).tobytes()
    if predictor == 3:
        bps = block.dtype.itemsize
        le = block.astype(block.dtype.newbyteorder("<")).reshape(rows, cols * spp)
        planes = le.view(np.uint8).reshape(rows, cols * spp, bps)[:, :, ::-1]
        x = np.ascontiguousarray(planes.transpose(0, 2, 1)).reshape(rows, -1)
        d = x.copy()
        d[:, spp:] = x[:, spp:] - x[:, :-spp]
        return d.tobytes()
    return block.astype(block.dtype.newbyteorder(bo)).tobytes()


def write_tiff(path, pages, *, photometric=None, planar=1, tile=None, rows_per_strip=None,
               compression=1, predictor=1, byteorder="<", bigtiff=False, extra_samples=None,
               colormap=None, orientation=None, ycbcr_subsampling=None, jpeg_tables=None,
               chunks=None, extra_tags=None, bits=None) -> None:
    """Write ``pages`` (arrays ``(H, W)`` or ``(H, W, S)``; the dtype gives
    BitsPerSample and SampleFormat) as a TIFF with struct and zlib alone:
    classic or BigTIFF, either byte order, strips or tiles (``tile`` =
    ``(height, width)``), PlanarConfiguration 1 or 2, compression none (1),
    LZW (5), deflate (8) or PackBits (32773) with predictor 1, 2 or 3.
    ``chunks`` (one list of encoded strips or tiles a page) replaces the
    encoder, as for JPEG (7) with ``jpeg_tables``; ``extra_tags`` adds
    ``{tag: (type, values)}`` to every IFD (RATIONAL, type 5, as a flat
    list of numerators and denominators).  ``bits`` (1-16, or 24) packs
    the integer samples at that width, most significant bit first, each
    chunk row from a byte.  A YCbCr (6) page that is not JPEG takes
    ``(H, W, 3)`` uint8 Y, Cb, Cr and is written chunky as data units of
    ``ycbcr_subsampling`` (default 2x2; each unit's chroma that of its
    top-left pixel)."""
    bo = byteorder
    pages = [np.asarray(p) for p in pages]
    body = bytearray()
    ifd_specs = []
    head = 16 if bigtiff else 8
    for pi, img in enumerate(pages):
        if img.ndim == 2:
            img = img[:, :, None]
        h, w, spp = img.shape
        kind = {"u": 1, "i": 2, "f": 3}[img.dtype.kind]
        if photometric is None:
            phot = 1 if spp in (1, 2) else 2
        else:
            phot = photometric
        if tile:
            th, tw = tile
            grid = [(y, x) for y in range(0, h, th) for x in range(0, w, tw)]
        else:
            th, tw = (rows_per_strip or h), w
            grid = [(y, 0) for y in range(0, h, th)]
        planes = [img] if planar == 1 else [img[:, :, s:s + 1] for s in range(spp)]
        datas = []
        if chunks is not None:
            datas = list(chunks[pi])
        else:
            units = phot == 6 and compression != 7 and planar == 1
            hs, vs = ycbcr_subsampling or (2, 2)
            for pl in planes:
                for y, x in grid:
                    blk = pl[y:y + th, x:x + tw]
                    if tile:  # tiles are whole: pad with zeros
                        pad = np.zeros((th, tw, pl.shape[2]), pl.dtype)
                        pad[:blk.shape[0], :blk.shape[1]] = blk
                        blk = pad
                    if units:
                        raw = _ycbcr_units(blk, hs, vs)
                    elif bits:
                        raw = _pack_bits(blk, bits)
                    else:
                        raw = _tiff_predict(np.ascontiguousarray(blk), predictor, blk.shape[2],
                                            bo)
                    if compression == 5:
                        raw = lzw_encode(raw)
                    elif compression in (8, 32946):
                        raw = zlib.compress(raw)
                    elif compression == 32773:
                        row = blk.shape[1] * blk.shape[2] * blk.dtype.itemsize
                        raw = b"".join(packbits_encode(raw[i:i + row])
                                       for i in range(0, len(raw), row))
                    datas.append(raw)
        offs = []
        for d in datas:
            offs.append(head + len(body))
            body += d
            if len(body) % 2:
                body += b"\0"
        nbits = bits or img.dtype.itemsize * 8
        tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [nbits] * spp), 259: (3, [compression]),
                262: (3, [phot]), 277: (3, [spp]), 284: (3, [planar]),
                339: (3, [kind] * spp)}
        if predictor != 1:
            tags[317] = (3, [predictor])
        if tile:
            tags[322] = (4, [tw])
            tags[323] = (4, [th])
            tags[324] = (16 if bigtiff else 4, offs)
            tags[325] = (16 if bigtiff else 4, [len(d) for d in datas])
        else:
            tags[273] = (16 if bigtiff else 4, offs)
            tags[278] = (4, [th])
            tags[279] = (16 if bigtiff else 4, [len(d) for d in datas])
        if extra_samples is not None:
            tags[338] = (3, list(extra_samples))
        if colormap is not None:
            tags[320] = (3, list(np.asarray(colormap, np.uint16).ravel()))
        if orientation is not None:
            tags[274] = (3, [orientation])
        if ycbcr_subsampling is not None:
            tags[530] = (3, list(ycbcr_subsampling))
        elif phot == 6 and compression != 7 and planar == 1:
            tags[530] = (3, [2, 2])
        if jpeg_tables is not None:
            tags[347] = (7, list(jpeg_tables))
        tags.update(extra_tags or {})
        ifd_specs.append(tags)
    # the IFDs after the image data
    fmt = {1: "B", 3: "H", 4: "I", 5: "I", 7: "B", 16: "Q"}
    inline = 8 if bigtiff else 4
    out = bytearray()
    ifd_offsets = []
    pos = head + len(body)
    for tags in ifd_specs:
        n = len(tags)
        ifd_len = (8 + n * 20 + 8) if bigtiff else (2 + n * 12 + 4)
        ifd_offsets.append(pos)
        extra = bytearray()
        entries = bytearray()
        for tag in sorted(tags):
            typ, vals = tags[tag]
            data = struct.pack(f"{bo}{len(vals)}{fmt[typ]}", *vals)
            if len(data) <= inline:
                field = data.ljust(inline, b"\0")
            else:
                field = struct.pack(bo + ("Q" if bigtiff else "I"), pos + ifd_len + len(extra))
                extra += data
                if len(extra) % 2:
                    extra += b"\0"
            count = len(vals) // 2 if typ == 5 else len(vals)
            entries += struct.pack(bo + ("HHQ" if bigtiff else "HHI"), tag, typ, count) + field
        ifd = struct.pack(bo + ("Q" if bigtiff else "H"), n) + entries
        out += ifd
        out += b"\0" * (8 if bigtiff else 4)  # next-IFD offset, patched below
        out += extra
        pos += ifd_len + len(extra)
    # patch the next-IFD offsets
    for i, off in enumerate(ifd_offsets[:-1]):
        at = off - head - len(body)
        n = len(ifd_specs[i])
        at += (8 + n * 20) if bigtiff else (2 + n * 12)
        out[at:at + (8 if bigtiff else 4)] = struct.pack(bo + ("Q" if bigtiff else "I"),
                                                          ifd_offsets[i + 1])
    if bigtiff:
        header = (b"II" if bo == "<" else b"MM") + struct.pack(bo + "HHHQ", 43, 8, 0,
                                                               ifd_offsets[0])
    else:
        header = (b"II" if bo == "<" else b"MM") + struct.pack(bo + "HI", 42, ifd_offsets[0])
    with open(path, "wb") as f:
        f.write(header + bytes(body) + bytes(out))


def _rle_plane(data: bytes, min_run: int = 4) -> bytes:
    """One byte plane of a row as libtiff's SGILog encoder codes it: runs
    of ``min_run`` or more equal bytes (at most 129) as ``128 + n - 2``
    and the byte, the bytes between as literals of at most 127 after
    their count."""
    out = bytearray()
    lit = bytearray()

    def flush():
        for j in range(0, len(lit), 127):
            chunk = lit[j:j + 127]
            out.append(len(chunk))
            out.extend(chunk)
        lit.clear()

    i, n = 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 129 and data[i + run] == data[i]:
            run += 1
        if run >= min_run:
            flush()
            out += bytes([128 + run - 2, data[i]])
            i += run
        else:
            lit.append(data[i])
            i += 1
    flush()
    return bytes(out)


#: :func:`write_sgilog_tiff`'s kinds: (photometric, compression, bytes a
#: code, run-length coded)
SGILOG_KINDS = {"L16": (32844, 34676, 2, True), "Luv32": (32845, 34676, 4, True),
                "Luv24": (32845, 34677, 3, False)}


def sgilog_chunk(codes: np.ndarray, kind: str) -> bytes:
    """Rows of integer codes as one SGILog strip or tile: each row's byte
    planes (most significant first) run-length coded for LogL16 and
    LogLuv32 (34676), three bytes a pixel for LogLuv24 (34677)."""
    _, _, nbytes, rle = SGILOG_KINDS[kind]
    c = np.asarray(codes).astype(np.int64) & ((1 << (8 * nbytes)) - 1)
    if not rle:
        return np.stack([(c >> 16) & 0xFF, (c >> 8) & 0xFF, c & 0xFF], -1).astype(
            np.uint8).tobytes()
    out = bytearray()
    for row in c:
        for shift in range(8 * (nbytes - 1), -1, -8):
            out += _rle_plane(((row >> shift) & 0xFF).astype(np.uint8).tobytes())
    return bytes(out)


def write_sgilog_tiff(path, codes: np.ndarray, kind: str, *, rows_per_strip=None, tile=None,
                      dtype=np.int16, orientation=None) -> None:
    """A one-page SGILog TIFF of ``(H, W)`` integer ``codes``: ``kind``
    ``"L16"`` (LogL, 34676: sign and 15-bit log luminance), ``"Luv32"``
    (LogLuv, 34676: that, then 8-bit u and v) or ``"Luv24"`` (LogLuv,
    34677: 10-bit log luminance and a 14-bit (u', v') index), as libtiff's
    ``tif_luv.c`` writes them; ``dtype`` gives the BitsPerSample and
    SampleFormat tags (int16 as cv2's writer leaves them)."""
    phot, compression, _, _ = SGILOG_KINDS[kind]
    codes = np.asarray(codes)
    h, w = codes.shape
    if tile:
        th, tw = tile
        chunks = []
        for y in range(0, h, th):
            for x in range(0, w, tw):
                blk = np.zeros((th, tw), np.int64)
                part = codes[y:y + th, x:x + tw]
                blk[:part.shape[0], :part.shape[1]] = part
                chunks.append(sgilog_chunk(blk, kind))
    else:
        rps = rows_per_strip or h
        chunks = [sgilog_chunk(codes[y:y + rps], kind) for y in range(0, h, rps)]
    spp = 1 if kind == "L16" else 3
    page = np.zeros((h, w, spp) if spp > 1 else (h, w), dtype)
    write_tiff(path, [page], photometric=phot, compression=compression, tile=tile,
               rows_per_strip=rows_per_strip, chunks=[chunks], orientation=orientation)
