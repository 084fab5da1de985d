"""Small JPEG stream writers for the decoder tests (not collected).

- :func:`dct_coefficients`: quantised DCT blocks of 8-bit planes under a
  SOF's sampling factors, padded to whole MCUs as libjpeg lays them out;
- :func:`huffman_stream`: a baseline (SOF0) Huffman stream of such blocks
  with the Annex K tables, the yardstick the arithmetic streams are held
  to through cv2;
- :class:`QMEncoder` and :func:`arith_stream`: the QM coder and the four
  kinds of scan after libjpeg's ``jcarith.c`` (Annex D's Qe table, DAC
  conditioning, restart intervals): sequential (SOF9) and progressive
  (SOF10) streams;
- :func:`lossless_stream`: lossless (SOF3) streams of predictors 1-7 and
  point transforms as ``jclossls.c``/``jclhuff.c`` code them;
- :func:`cut_after_scans`: a progressive stream ended after its first
  scans (EOI appended), which libjpeg block-smooths;
- :func:`set_adobe_transform`: an Adobe APP14 segment's transform byte
  changed in place (Pillow's CMYK stream read as YCCK).

Every stream is made from seeded numpy arrays; nothing here decodes.
"""

from __future__ import annotations

import struct

import numpy as np

#: natural (row-major) index of zigzag index k
NATURAL = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
           41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15,
           23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]

#: Annex K.1 and K.2 quantisation tables, natural order
STD_LUMA_Q = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24,
              40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77,
              24, 35, 55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92,
              95, 98, 112, 100, 103, 99]
STD_CHROMA_Q = [17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4 + [24, 26, 56] + \
    [99] * 5 + [47, 66] + [99] * 38

#: Annex K.3 Huffman tables: (BITS[1..16], HUFFVAL)
STD_DC = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
STD_AC = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52,
    0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3,
    0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8,
    0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
#: a lossless DC table of the 17 difference categories 0-16
LOSSLESS_DC = ([0, 0, 6, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0], list(range(17)))

#: Annex D, Table D.2 as libjpeg's jaricom.c packs it: (Qe, Next_Index_LPS
#: with Switch_MPS in bit 7, Next_Index_MPS); entry 113 is the fixed 0.5
_QE = """5a1d 1 1 1|2586 14 2 0|1114 16 3 0|080b 18 4 0|03d8 20 5 0|01da 23 6 0|00e5 25 7 0
006f 28 8 0|0036 30 9 0|001a 33 10 0|000d 35 11 0|0006 9 12 0|0003 10 13 0|0001 12 13 0
5a7f 15 15 1|3f25 36 16 0|2cf2 38 17 0|207c 39 18 0|17b9 40 19 0|1182 42 20 0|0cef 43 21 0
09a1 45 22 0|072f 46 23 0|055c 48 24 0|0406 49 25 0|0303 51 26 0|0240 52 27 0|01b1 54 28 0
0144 56 29 0|00f5 57 30 0|00b7 59 31 0|008a 60 32 0|0068 62 33 0|004e 63 34 0|003b 32 35 0
002c 33 9 0|5ae1 37 37 1|484c 64 38 0|3a0d 65 39 0|2ef1 67 40 0|261f 68 41 0|1f33 69 42 0
19a8 70 43 0|1518 72 44 0|1177 73 45 0|0e74 74 46 0|0bfb 75 47 0|09f8 77 48 0|0861 78 49 0
0706 79 50 0|05cd 48 51 0|04de 50 52 0|040f 50 53 0|0363 51 54 0|02d4 52 55 0|025c 53 56 0
01f8 54 57 0|01a4 55 58 0|0160 56 59 0|0125 57 60 0|00f6 58 61 0|00cb 59 62 0|00ab 61 63 0
008f 61 32 0|5b12 65 65 1|4d04 80 66 0|412c 81 67 0|37d8 82 68 0|2fe8 83 69 0|293c 84 70 0
2379 86 71 0|1edf 87 72 0|1aa9 87 73 0|174e 72 74 0|1424 72 75 0|119c 74 76 0|0f6b 74 77 0
0d51 75 78 0|0bb6 77 79 0|0a40 77 48 0|5832 80 81 1|4d1c 88 82 0|438e 89 83 0|3bdd 90 84 0
34ee 91 85 0|2eae 92 86 0|299a 93 87 0|2516 86 71 0|5570 88 89 1|4ca9 95 90 0|44d9 96 91 0
3e22 97 92 0|3824 99 93 0|32b4 99 94 0|2e17 93 86 0|56a8 95 96 1|4f46 101 97 0|47e5 102 98 0
41cf 103 99 0|3c3d 104 100 0|375e 99 93 0|5231 105 102 0|4c0f 106 103 0|4639 107 104 0
415e 103 99 0|5627 105 106 1|50e7 108 107 0|4b85 109 103 0|5597 110 109 0|504f 111 107 0
5a10 110 111 1|5522 112 109 0|59eb 112 111 1|5a1d 113 113 0"""
QE_TABLE = [(int(q, 16), int(nl) | (int(sw) << 7), int(nm)) for q, nl, nm, sw in
            (e.split() for e in _QE.replace("\n", "|").split("|"))]


def quality_table(base, quality: int) -> list:
    """libjpeg's ``jpeg_quality_scaling`` of a base table (baseline
    limits)."""
    quality = max(1, min(100, quality))
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return [max(1, min(255, (b * scale + 50) // 100)) for b in base]


# ------------------------------------------------------------ geometry
class Geometry:
    """libjpeg's layout of a frame (``jdinput.c``): each component's
    blocks (data units of ``unit`` samples a side: 8, or 1 lossless),
    padded to whole MCUs of the interleaved scan."""

    def __init__(self, height: int, width: int, factors, unit: int = 8):
        self.height, self.width, self.factors, self.unit = height, width, list(factors), unit
        self.maxh = max(h for h, _ in self.factors)
        self.maxv = max(v for _, v in self.factors)
        self.mcux = -(-width // (self.maxh * unit))
        self.mcuy = -(-height // (self.maxv * unit))
        self.bw = [-(-width * h // (self.maxh * unit)) for h, _ in self.factors]
        self.bh = [-(-height * v // (self.maxv * unit)) for _, v in self.factors]
        self.bwp = [self.mcux * h for h, _ in self.factors]
        self.bhp = [self.mcuy * v for _, v in self.factors]

    def mcus(self, comps):
        """Each MCU of a scan over ``comps`` as its ``[(c, by, bx)]``."""
        if len(comps) == 1:
            c = comps[0]
            for by in range(self.bh[c]):
                for bx in range(self.bw[c]):
                    yield [(c, by, bx)]
            return
        for my in range(self.mcuy):
            for mx in range(self.mcux):
                yield [(c, my * v + y, mx * h + x) for c in comps
                       for h, v in [self.factors[c]] for y in range(v) for x in range(h)]

    def plane(self, full: np.ndarray, c: int) -> np.ndarray:
        """Component ``c`` of a full-size plane: box-averaged by its
        factors, edges replicated to its padded blocks."""
        h, v = self.factors[c]
        fx, fy = self.maxh // h, self.maxv // v
        H, W = full.shape
        ph, pw = -(-H // fy) * fy, -(-W // fx) * fx
        p = np.pad(full.astype(np.float64), ((0, ph - H), (0, pw - W)), mode="edge")
        p = p.reshape(ph // fy, fy, pw // fx, fx).mean(axis=(1, 3))
        rows, cols = self.bhp[c] * self.unit, self.bwp[c] * self.unit
        return np.pad(p, ((0, rows - p.shape[0]), (0, cols - p.shape[1])), mode="edge")


def dct_coefficients(geom: Geometry, planes, qtables) -> list:
    """Each component's quantised DCT blocks ``(bhp, bwp, 64)`` in natural
    order (orthonormal 8x8 DCT of the level-shifted samples, rounded
    division by the table)."""
    from scipy.fft import dctn

    out = []
    for c, full in enumerate(planes):
        p = geom.plane(np.asarray(full), c) - 128.0
        bh, bw = geom.bhp[c], geom.bwp[c]
        blocks = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = dctn(blocks, axes=(2, 3), norm="ortho").reshape(bh, bw, 64)
        q = np.asarray(qtables[c], np.float64)
        out.append(np.rint(coef / q).astype(np.int64))
    return out


# ------------------------------------------------------------ segments
def segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def dqt(tables) -> bytes:
    """One DQT segment of ``{slot: table (natural order)}``, 8- or 16-bit
    entries as the values need."""
    body = b""
    for slot, t in sorted(tables.items()):
        wide = max(t) > 255
        body += bytes([(wide << 4) | slot])
        zz = [t[NATURAL[k]] for k in range(64)]
        body += struct.pack(">64H", *zz) if wide else bytes(zz)
    return segment(0xDB, body)


def dht(klass: int, slot: int, table) -> bytes:
    bits, vals = table
    return segment(0xC4, bytes([(klass << 4) | slot, *bits, *vals]))


def dri(interval: int) -> bytes:
    return segment(0xDD, struct.pack(">H", interval))


def dac(entries) -> bytes:
    """A DAC segment of ``[(class 0/1, slot, value)]``: DC ``(U << 4) | L``,
    AC ``Kx``."""
    return segment(0xCC, b"".join(bytes([(k << 4) | s, v]) for k, s, v in entries))


def sof(marker: int, height: int, width: int, comps, precision: int = 8) -> bytes:
    """``comps``: ``[(id, h, v, tq)]``."""
    return segment(marker, struct.pack(">BHHB", precision, height, width, len(comps)) +
                   b"".join(bytes([i, (h << 4) | v, t]) for i, h, v, t in comps))


def sos(comps, ss: int, se: int, ah: int, al: int) -> bytes:
    """``comps``: ``[(id, dc_table, ac_table)]``."""
    return segment(0xDA, bytes([len(comps)]) + b"".join(bytes([i, (d << 4) | a])
                                                         for i, d, a in comps)
                   + bytes([ss, se, (ah << 4) | al]))


JFIF = segment(0xE0, b"JFIF\0\1\1\0\0\1\0\1\0\0")


def adobe(transform: int) -> bytes:
    return segment(0xEE, b"Adobe\0\x64\0\0\0\0" + bytes([transform]))


def set_adobe_transform(stream: bytes, transform: int) -> bytes:
    """``stream`` with its Adobe APP14 segment's transform byte set."""
    at = stream.index(b"\xff\xee")
    assert stream[at + 4:at + 9] == b"Adobe"
    return stream[:at + 15] + bytes([transform]) + stream[at + 16:]


def with_restarts(mcus, interval: int, code_mcu, finish, restart):
    """Drive a scan: ``code_mcu`` each MCU, ``finish`` then a RST marker
    (``restart(n)``) every ``interval`` MCUs."""
    n = 0
    for i, mcu in enumerate(mcus):
        if interval and i and i % interval == 0:
            finish()
            restart(n)
            n = (n + 1) & 7
        code_mcu(mcu)
    finish()


# --------------------------------------------------------- Huffman out
class BitWriter:
    def __init__(self, out: bytearray):
        self.out, self.acc, self.n = out, 0, 0

    def put(self, code: int, size: int):
        for i in range(size - 1, -1, -1):
            self.acc = (self.acc << 1) | ((code >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):
        while self.n:
            self.put(1, 1)


def huff_codes(table) -> dict:
    bits, vals = table
    codes, code, p = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[p]] = (code, length)
            code += 1
            p += 1
        code <<= 1
    return codes


def _nbits(v: int) -> int:
    return abs(v).bit_length()


def huffman_stream(geom: Geometry, coefs, qtables, ids=None, restart: int = 0,
                   app: bytes = b"") -> bytes:
    """A baseline Huffman stream of the blocks ``coefs`` in one
    interleaved scan (component c quantised by ``qtables[c]``, tables 0
    for every component)."""
    ids = ids or list(range(1, len(coefs) + 1))
    dc, ac = huff_codes(STD_DC), huff_codes(STD_AC)
    out = bytearray()
    bw = BitWriter(out)
    last = [0] * len(coefs)

    def code_mcu(mcu):
        for c, by, bx in mcu:
            blk = coefs[c][by, bx]
            diff = int(blk[0]) - last[c]
            last[c] = int(blk[0])
            s = _nbits(diff)
            bw.put(*dc[s])
            if s:
                bw.put(diff if diff > 0 else (diff - 1) & ((1 << s) - 1), s)
            run = 0
            for k in range(1, 64):
                v = int(blk[NATURAL[k]])
                if v == 0:
                    run += 1
                    continue
                while run > 15:
                    bw.put(*ac[0xF0])
                    run -= 16
                s = _nbits(v)
                bw.put(*ac[(run << 4) | s])
                bw.put(v if v > 0 else (v - 1) & ((1 << s) - 1), s)
                run = 0
            if run:
                bw.put(*ac[0])

    def marker(n):
        out.extend(bytes([0xFF, 0xD0 + n]))
        last[:] = [0] * len(coefs)

    comps = list(range(len(coefs)))
    with_restarts(geom.mcus(comps), restart, code_mcu, bw.flush, marker)
    head = (app + dqt(dict(enumerate(qtables))) +
            sof(0xC0, geom.height, geom.width,
                [(ids[c], *geom.factors[c], c) for c in comps]) +
            dht(0, 0, STD_DC) + dht(1, 0, STD_AC) + (dri(restart) if restart else b"") +
            sos([(ids[c], 0, 0) for c in comps], 0, 63, 0, 0))
    return b"\xff\xd8" + head + bytes(out) + b"\xff\xd9"


# ----------------------------------------------------------- QM coder
class QMEncoder:
    """libjpeg's arithmetic encoder (``jcarith.c`` ``arith_encode``,
    ``finish_pass``) over statistics bins kept by the caller (bytearrays,
    MPS in bit 7)."""

    def __init__(self, out: bytearray):
        self.out = out
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _zeros(self):
        self.out.extend(b"\0" * self.zc)
        self.zc = 0

    def encode(self, st: bytearray, i: int, val: int):
        sv = st[i]
        qe, nl, nm = QE_TABLE[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self.out.append(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self.out.append(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self.out.append(self.buffer)
                    if self.sc:
                        self._zeros()
                        self.out.extend(b"\xff\x00" * self.sc)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self.out.append(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self.out.append(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self.out.append(self.buffer)
            if self.sc:
                self._zeros()
                self.out.extend(b"\xff\x00" * self.sc)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            b = (self.c >> 19) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self.out.append(b)
                if b == 0xFF:
                    self.out.append(0)


class ArithScan:
    """One arithmetic-coded scan's statistics and coder (``jcarith.c``):
    DC bins of 64 and AC bins of 256 a table, the fixed 0.5 bin."""

    def __init__(self, out: bytearray, ncomp: int, L=None, U=None, K=None):
        self.e = QMEncoder(out)
        self.L, self.U, self.K = L or [0] * 16, U or [1] * 16, K or [5] * 16
        self.ncomp = ncomp
        self.fixed = bytearray([113])
        self.reset_stats()

    def reset_stats(self):
        self.dc = [bytearray(64) for _ in range(16)]
        self.ac = [bytearray(256) for _ in range(16)]
        self.last = [0] * self.ncomp
        self.ctx = [0] * self.ncomp

    def dc_value(self, ci: int, tbl: int, value: int):
        """F.4's DC difference of component ``ci`` against its last value."""
        e, st = self.e, self.dc[tbl]
        i = self.ctx[ci]
        v = value - self.last[ci]
        if v == 0:
            e.encode(st, i, 0)
            self.ctx[ci] = 0
            return
        self.last[ci] = value
        e.encode(st, i, 1)
        if v > 0:
            e.encode(st, i + 1, 0)
            i += 2
            self.ctx[ci] = 4
        else:
            v = -v
            e.encode(st, i + 1, 1)
            i += 3
            self.ctx[ci] = 8
        v -= 1
        m = 0
        if v:
            e.encode(st, i, 1)
            m = 1
            v2 = v >> 1
            i = 20
            while v2:
                e.encode(st, i, 1)
                m <<= 1
                i += 1
                v2 >>= 1
        e.encode(st, i, 0)
        if m < (1 << self.L[tbl]) >> 1:
            self.ctx[ci] = 0
        elif m > (1 << self.U[tbl]) >> 1:
            self.ctx[ci] += 8
        i += 14
        m >>= 1
        while m:
            e.encode(st, i, 1 if (m & v) else 0)
            m >>= 1

    def ac_values(self, tbl: int, vals, ss: int, se: int):
        """F.5 (first scans): ``vals[k]`` the point-transformed coefficient
        at zigzag k."""
        e, st = self.e, self.ac[tbl]
        ke = se
        while ke >= ss and vals[ke] == 0:
            ke -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            e.encode(st, i, 0)
            while vals[k] == 0:
                e.encode(st, i + 1, 0)
                i += 3
                k += 1
            e.encode(st, i + 1, 1)
            v = vals[k]
            e.encode(self.fixed, 0, 0 if v > 0 else 1)
            v = abs(v)
            i += 2
            v -= 1
            m = 0
            if v:
                e.encode(st, i, 1)
                m = 1
                v2 = v >> 1
                if v2:
                    e.encode(st, i, 1)
                    m <<= 1
                    i = 189 if k <= self.K[tbl] else 217
                    v2 >>= 1
                    while v2:
                        e.encode(st, i, 1)
                        m <<= 1
                        i += 1
                        v2 >>= 1
            e.encode(st, i, 0)
            i += 14
            m >>= 1
            while m:
                e.encode(st, i, 1 if (m & v) else 0)
                m >>= 1
            k += 1
        if k <= se:
            e.encode(st, 3 * (k - 1), 1)

    def ac_refine(self, tbl: int, coef, ss: int, se: int, ah: int, al: int):
        """G.10: ``coef[k]`` the full coefficient at zigzag k."""
        e, st = self.e, self.ac[tbl]

        def shifted(v, a):
            return abs(int(v)) >> a

        ke = se
        while ke > 0 and shifted(coef[ke], al) == 0:
            ke -= 1
        kex = ke
        while kex > 0 and shifted(coef[kex], ah) == 0:
            kex -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                e.encode(st, i, 0)
            while True:
                v = shifted(coef[k], al)
                if v:
                    if v >> 1:
                        e.encode(st, i + 2, v & 1)
                    else:
                        e.encode(st, i + 1, 1)
                        e.encode(self.fixed, 0, 0 if coef[k] > 0 else 1)
                    break
                e.encode(st, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= se:
            e.encode(st, 3 * (k - 1), 1)


#: jcparam.c's jpeg_simple_progression for one and for three components:
#: (components, Ss, Se, Ah, Al)
SIMPLE_PROGRESSION = {
    1: [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
        ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)],
    3: [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
        ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), ((0, 1, 2), 0, 0, 1, 0),
        ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)],
}


def arith_stream(geom: Geometry, coefs, qtables, *, progressive: bool = False, script=None,
                 ids=None, restart: int = 0, app: bytes = b"", conditioning=None,
                 tables=None, sequential_scans=None) -> bytes:
    """An arithmetic-coded stream (SOF9, or SOF10 with ``progressive``) of
    the blocks ``coefs``: sequential in one interleaved scan (or
    ``sequential_scans``, lists of components a scan), progressive by
    ``script`` (:data:`SIMPLE_PROGRESSION` by default).  ``conditioning``
    = ``{"L": [...], "U": [...], "K": [...]}`` writes a DAC segment;
    ``tables`` gives each component's ``(dc, ac)`` table slots."""
    n = len(coefs)
    ids = ids or list(range(1, n + 1))
    tables = tables or [(0, 0)] * n
    cond = conditioning or {}
    L, U, K = cond.get("L", [0] * 16), cond.get("U", [1] * 16), cond.get("K", [5] * 16)
    zz = [c[..., NATURAL] for c in coefs]
    out = bytearray()
    if progressive:
        scans = script or SIMPLE_PROGRESSION[n]
    else:
        scans = [(tuple(s), 0, 63, 0, 0) for s in (sequential_scans or [list(range(n))])]
    body = b""
    for comps, ss, se, ah, al in scans:
        data = bytearray()
        sc = ArithScan(data, n, L, U, K)

        def code_mcu(mcu, comps=comps, ss=ss, se=se, ah=ah, al=al, sc=sc):
            for c, by, bx in mcu:
                blk = zz[c][by, bx]
                dtab, atab = tables[c]
                if not progressive:
                    sc.dc_value(c, dtab, int(blk[0]))
                    sc.ac_values(atab, [0] + [int(v) for v in blk[1:]], 1, 63)
                elif ss == 0 and ah == 0:
                    sc.dc_value(c, dtab, int(blk[0]) >> al)
                elif ss == 0:
                    sc.e.encode(sc.fixed, 0, (int(blk[0]) >> al) & 1)
                elif ah == 0:
                    vals = [0] * 64
                    for k in range(ss, se + 1):
                        v = int(blk[k])
                        vals[k] = (abs(v) >> al) * (1 if v >= 0 else -1)
                    sc.ac_values(atab, vals, ss, se)
                else:
                    sc.ac_refine(atab, [int(v) for v in blk], ss, se, ah, al)

        def restart_(k, sc=sc, data=data):
            data.extend(bytes([0xFF, 0xD0 + k]))
            sc.reset_stats()
            sc.e.reset()

        with_restarts(geom.mcus(list(comps)), restart, code_mcu, sc.e.finish, restart_)
        body += sos([(ids[c], *tables[c]) for c in comps], ss, se, ah, al) + bytes(data)
    dac_entries = [(0, t, (U[t] << 4) | L[t]) for t in range(16)
                   if (L[t], U[t]) != (0, 1)] + [(1, t, K[t]) for t in range(16) if K[t] != 5]
    head = (app + dqt(dict(enumerate(qtables))) +
            sof(0xCA if progressive else 0xC9, geom.height, geom.width,
                [(ids[c], *geom.factors[c], c) for c in range(n)]) +
            (dac(dac_entries) if dac_entries else b"") + (dri(restart) if restart else b""))
    return b"\xff\xd8" + head + body + b"\xff\xd9"


# ------------------------------------------------------------ lossless
def optimal_table(freq) -> tuple:
    """``jchuff.c``'s ``jpeg_gen_optimal_table``: a Huffman table
    (BITS[1..16], HUFFVAL) for symbol counts ``freq`` (codes of at most 16
    bits, none all ones)."""
    freq = list(freq) + [0] * (257 - len(freq))
    freq[256] = 1  # the reserved code point
    codesize, others = [0] * 257, [-1] * 257
    while True:
        live = [i for i in range(257) if freq[i]]
        if len(live) < 2:
            break
        c1 = min(live, key=lambda i: (freq[i], -i))
        c2 = min((i for i in live if i != c1), key=lambda i: (freq[i], -i))
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for size in codesize:
        if size:
            bits[size] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    vals = [sym for size in range(1, 33) for sym in range(256) if codesize[sym] == size]
    return bits[1:17], vals


def _predict(psv: int, ra: int, rb: int, rc: int) -> int:
    return {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv]


def lossless_stream(planes, factors=None, *, precision: int = 8, psv: int = 1, pt: int = 0,
                    restart_rows: int = 0, ids=None, app: bytes = b"", marker: int = 0xC3,
                    table=LOSSLESS_DC, scans=None, diffs=None) -> bytes:
    """A lossless stream (SOF3) of ``planes`` (full-size arrays of samples
    below ``2 ** precision``; components subsampled by ``factors`` take
    each unit's top-left sample) with predictor ``psv`` and point
    transform ``pt``: the first row of a scan and of each restart interval
    predicted from the left (``2 ** (P - Pt - 1)`` at its first sample),
    each first column from above (``jclossls.c``), differences Huffman
    coded as ``jclhuff.c`` codes them (``table="optimal"``: a table made
    for them).  ``restart_rows`` is the restart interval in MCU rows;
    ``scans`` lists the components of each scan (one interleaved scan by
    default); ``diffs`` (each component's differences on its padded
    sample grid) are coded as given instead, to reach the decoder's
    modulo-2^16 arithmetic."""
    n = len(planes)
    factors = factors or [(1, 1)] * n
    ids = ids or list(range(1, n + 1))
    h, w = np.asarray(planes[0]).shape
    geom = Geometry(h, w, factors, unit=1)
    comp = []
    for c, p in enumerate(planes):
        p = np.asarray(p, np.int64)
        hf, vf = factors[c]
        fx, fy = geom.maxh // hf, geom.maxv // vf
        sub = p[::fy, ::fx] >> pt
        rows, cols = geom.bhp[c], geom.bwp[c]
        comp.append(np.pad(sub, ((0, rows - sub.shape[0]), (0, cols - sub.shape[1])),
                           mode="edge"))
    init = 1 << (precision - pt - 1)
    coded = []
    for sc in (scans or [list(range(n))]):
        d_sc = {}
        for c in sc:
            if diffs is not None:
                d_sc[c] = np.asarray(diffs[c], np.int64) & 0xFFFF
                continue
            p = comp[c]
            rows_per_mcu = 1 if len(sc) == 1 else factors[c][1]
            d = np.zeros_like(p)
            for y in range(p.shape[0]):
                mcu_row = y // rows_per_mcu
                first = y == 0 or (restart_rows and mcu_row % restart_rows == 0
                                   and y % rows_per_mcu == 0)
                for x in range(p.shape[1]):
                    if first:
                        pred = init if x == 0 else int(p[y, x - 1])
                    elif x == 0:
                        pred = int(p[y - 1, 0])
                    else:
                        pred = _predict(psv, int(p[y, x - 1]), int(p[y - 1, x]),
                                        int(p[y - 1, x - 1]))
                    d[y, x] = (int(p[y, x]) - pred) & 0xFFFF
            d_sc[c] = d
        coded.append((sc, d_sc))

    def category(v: int) -> int:
        v = v - 0x10000 if v >= 0x8000 else v
        return 16 if v == -0x8000 else _nbits(v)

    if table == "optimal":
        freq = [0] * 17
        for sc, d_sc in coded:
            for mcu in geom.mcus(sc):
                for c, by, bx in mcu:
                    freq[category(int(d_sc[c][by, bx]))] += 1
        table = optimal_table(freq)
    codes = huff_codes(table)
    body = b""
    for sc, d_sc in coded:
        data = bytearray()
        bw = BitWriter(data)

        def code_mcu(mcu, d_sc=d_sc):
            for c, by, bx in mcu:
                v = int(d_sc[c][by, bx])
                s = category(v)
                bw.put(*codes[s])
                if 0 < s < 16:
                    v = v - 0x10000 if v >= 0x8000 else v
                    bw.put(v if v > 0 else (v - 1) & ((1 << s) - 1), s)

        def restart_(k, data=data):
            data.extend(bytes([0xFF, 0xD0 + k]))

        interval = restart_rows * (geom.mcux if len(sc) > 1 else geom.bw[sc[0]])
        with_restarts(geom.mcus(sc), interval, code_mcu, bw.flush, restart_)
        body += (dri(interval) if restart_rows else b"") + \
            sos([(ids[c], 0, 0) for c in sc], psv, 0, 0, pt) + bytes(data)
    head = (app + sof(marker, h, w, [(ids[c], *factors[c], 0) for c in range(n)], precision)
            + dht(0, 0, table))
    return b"\xff\xd8" + head + body + b"\xff\xd9"


# ------------------------------------------------------------- surgery
def scan_starts(stream: bytes) -> list:
    """Offsets of each SOS marker of a stream (marker by marker)."""
    out, at = [], 2
    while at < len(stream) - 1:
        if stream[at] != 0xFF:
            at += 1
            continue
        m = stream[at + 1]
        if m in (0x00, 0xFF) or 0xD0 <= m <= 0xD7:
            at += 1 if m == 0xFF else 2
            continue
        if m in (0xD8, 0xD9, 0x01):
            at += 2
            continue
        (length,) = struct.unpack(">H", stream[at + 2:at + 4])
        if m == 0xDA:
            out.append(at)
            at += 2 + length
            continue  # entropy data: skipped byte by byte above
        at += 2 + length
    return out


def cut_after_scans(stream: bytes, n: int) -> bytes:
    """``stream`` ended after its first ``n`` scans, EOI appended."""
    starts = scan_starts(stream)
    assert len(starts) > n, (len(starts), n)
    return stream[:starts[n]] + b"\xff\xd9"
