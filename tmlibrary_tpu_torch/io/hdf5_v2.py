"""The version-2 metadata structures of HDF5 1.8 and later, read for
:mod:`tmlibrary_tpu_torch.io.hdf5`: fractal heaps (``FRHP``/``FHDB``/
``FHIB``, managed, tiny and huge objects), version-2 B-trees (``BTHD``/
``BTIN``/``BTLF``), the fixed arrays (``FAHD``/``FADB``) and extensible
arrays (``EAHD``/``EAIB``/``EASB``/``EADB``) of layout-4 chunk indexes,
and the dataspace selections of virtual-dataset mappings.

Every structure is read through a :class:`~tmlibrary_tpu_torch.io.hdf5.File`
(``f._bytes`` bounds each read by the file) and its lookup3 checksum is
verified (``f._checked``); a damaged one raises
:class:`~tmlibrary_tpu_torch.errors.MetadataError`.  The layouts follow
the HDF5 file format specification, version 3.
"""

from __future__ import annotations

import bisect
import math
import struct

from tmlibrary_tpu_torch.errors import MetadataError, NotSupportedError

UNDEF = 0xFFFFFFFFFFFFFFFF


def log2_gen(n: int) -> int:
    """``H5VM_log2_gen``: floor(log2(n)) for n > 0."""
    return max(int(n), 1).bit_length() - 1


def limit_enc_size(n: int) -> int:
    """``H5VM_limit_enc_size``: the bytes that encode values up to ``n``."""
    return log2_gen(n) // 8 + 1


def _le(b: bytes, at: int, n: int) -> int:
    return int.from_bytes(b[at:at + n], "little")


# ------------------------------------------------------------ v2 B-trees
class BTree2:
    """A version-2 B-tree: its header, and every record in key order."""

    def __init__(self, f, addr: int, kind: int):
        self.f = f
        head = f._checked(addr, 38, "v2 B-tree header", b"BTHD")
        self.type = head[5]
        if self.type != kind:
            raise MetadataError(f"{f.name}: v2 B-tree of type {self.type} where {kind} belongs")
        self.node_size, self.rsize, self.depth = struct.unpack_from("<IHH", head, 6)
        self.root, self.root_nrec, self.total = struct.unpack_from("<QHQ", head, 16)
        if self.rsize == 0 or self.node_size < 10 + self.rsize or self.depth > 64:
            raise MetadataError(f"{f.name}: bad v2 B-tree at {addr}")
        # H5B2__hdr_init: records a node holds and the sizes of the counts
        self.max_nrec = [(self.node_size - 10) // self.rsize]
        self.cum_max = [self.max_nrec[0]]
        self.cum_size = [0]
        self.nrec_size = limit_enc_size(self.max_nrec[0])
        for d in range(1, self.depth + 1):
            ptr = 8 + self.nrec_size + (self.cum_size[d - 1] if d > 1 else 0)
            n = (self.node_size - 10 - ptr) // (self.rsize + ptr)
            if n <= 0:
                raise MetadataError(f"{f.name}: bad v2 B-tree node size {self.node_size}")
            self.max_nrec.append(n)
            self.cum_max.append((n + 1) * self.cum_max[d - 1] + n)
            self.cum_size.append(limit_enc_size(self.cum_max[d]))

    def records(self) -> "list[bytes]":
        out: list = []
        if self.root != UNDEF and self.total:
            self._node(self.root, self.root_nrec, self.depth, out)
        if len(out) != self.total:
            raise MetadataError(f"{self.f.name}: v2 B-tree holds {len(out)} records, its "
                                f"header {self.total}")
        return out

    def _node(self, addr: int, nrec: int, depth: int, out: list) -> None:
        if nrec > self.max_nrec[depth]:
            raise MetadataError(f"{self.f.name}: v2 B-tree node with {nrec} records")
        if depth == 0:
            body = self.f._checked(addr, 10 + nrec * self.rsize, "v2 B-tree leaf", b"BTLF",
                                   self.type)
            out.extend(body[6 + i * self.rsize:6 + (i + 1) * self.rsize] for i in range(nrec))
            return
        csize = self.cum_size[depth - 1] if depth > 1 else 0
        ptr = 8 + self.nrec_size + csize
        body = self.f._checked(addr, 10 + nrec * self.rsize + (nrec + 1) * ptr,
                               "v2 B-tree internal node", b"BTIN", self.type)
        at = 6 + nrec * self.rsize
        for i in range(nrec + 1):
            child = _le(body, at, 8)
            n = _le(body, at + 8, self.nrec_size)
            first = len(out)
            self._node(child, n, depth - 1, out)
            if csize and len(out) - first != _le(body, at + 8 + self.nrec_size, csize):
                raise MetadataError(f"{self.f.name}: v2 B-tree node at {child} holds "
                                    f"{len(out) - first} records, its parent counts another number")
            if i < nrec:
                out.append(body[6 + i * self.rsize:6 + (i + 1) * self.rsize])
            at += ptr


# ---------------------------------------------------------- fractal heaps
class FractalHeap:
    """A fractal heap: objects by heap id (managed, tiny or huge)."""

    def __init__(self, f, addr: int):
        self.f = f
        head = f._bytes(addr, 146)
        if head[:4] != b"FRHP" or head[4] != 0:
            raise MetadataError(f"{f.name}: bad fractal heap at {addr}")
        self.id_len, self.filter_len = struct.unpack_from("<HH", head, 5)
        self.flags = head[9]
        self.max_man = struct.unpack_from("<I", head, 10)[0]
        self.huge_btree = struct.unpack_from("<Q", head, 22)[0]
        (self.width,) = struct.unpack_from("<H", head, 110)
        self.start, self.max_direct = struct.unpack_from("<QQ", head, 112)
        self.max_bits, _start_rows = struct.unpack_from("<HH", head, 128)
        self.root, self.root_rows = struct.unpack_from("<QH", head, 132)
        size = 142 + (12 + self.filter_len if self.filter_len else 0) + 4
        f._checked(addr, size, "fractal heap header", b"FRHP")
        if self.filter_len:
            raise NotSupportedError(f"{f.name}: filtered HDF5 fractal heaps are not read by "
                                    "the port")
        if (self.width == 0 or self.width & (self.width - 1) or self.start == 0
                or self.start & (self.start - 1) or self.max_direct & (self.max_direct - 1)
                or self.max_direct < self.start or not 0 < self.max_bits <= 64):
            raise MetadataError(f"{f.name}: bad fractal heap doubling table at {addr}")
        self.off_size = (self.max_bits + 7) // 8
        self.len_size = min((log2_gen(self.max_direct) + 7) // 8, limit_enc_size(self.max_man))
        self.max_direct_rows = log2_gen(self.max_direct) - log2_gen(self.start) + 2
        self._blocks: "list | None" = None  # (heap offset, size, address), sorted
        self._huge: "dict | None" = None

    def _row_size(self, r: int) -> int:
        return self.start if r == 0 else self.start << (r - 1)

    def _row_start(self, r: int) -> int:
        return sum(self.width * self._row_size(i) for i in range(r))

    def _walk(self, addr: int, nrows: int, base: int, out: list, depth: int) -> None:
        if depth > 64 or nrows > 64:
            raise MetadataError(f"{self.f.name}: fractal heap deeper than 64 levels")
        ndirect = min(nrows, self.max_direct_rows) * self.width
        nindirect = max(nrows - self.max_direct_rows, 0) * self.width
        size = 5 + 8 + self.off_size + 8 * (ndirect + nindirect) + 4
        block = self.f._checked(addr, size, "fractal heap indirect block", b"FHIB")
        if _le(block, 13, self.off_size) != base:
            raise MetadataError(f"{self.f.name}: fractal heap indirect block at {addr} has "
                                "the wrong offset")
        at = 13 + self.off_size
        for i in range(ndirect + nindirect):
            r, c = divmod(i, self.width)
            child = _le(block, at + 8 * i, 8)
            if child in (UNDEF, 0):
                continue
            off = base + self._row_start(r) + c * self._row_size(r)
            if i < ndirect:
                out.append((off, self._row_size(r), child))
            else:
                sub = log2_gen(self._row_size(r)) - log2_gen(self.start * self.width) + 1
                self._walk(child, sub, off, out, depth + 1)

    def blocks(self) -> list:
        if self._blocks is None:
            out: list = []
            if self.root != UNDEF:
                if self.root_rows == 0:
                    out.append((0, self.start, self.root))
                else:
                    self._walk(self.root, self.root_rows, 0, out, 0)
            out.sort()
            self._blocks = out
        return self._blocks

    def _direct(self, off: int, size: int, addr: int) -> bytes:
        block = self.f._bytes(addr, size)
        if block[:4] != b"FHDB" or block[4] != 0:
            raise MetadataError(f"{self.f.name}: bad fractal heap direct block at {addr}")
        if _le(block, 13, self.off_size) != off:
            raise MetadataError(f"{self.f.name}: fractal heap direct block at {addr} has the "
                                "wrong offset")
        if self.flags & 2:
            at = 13 + self.off_size
            stored = _le(block, at, 4)
            if self.f._lookup3(block[:at] + bytes(4) + block[at + 4:]) != stored:
                raise MetadataError(f"{self.f.name}: bad checksum of the fractal heap direct "
                                    f"block at {addr}")
        return block

    def get(self, hid: bytes) -> bytes:
        if len(hid) < 1 or hid[0] >> 6:
            raise MetadataError(f"{self.f.name}: bad fractal heap id")
        kind = (hid[0] >> 4) & 3
        if kind == 0:
            off = _le(hid, 1, self.off_size)
            length = _le(hid, 1 + self.off_size, self.len_size)
            blocks = self.blocks()
            i = bisect.bisect_right(blocks, (off, math.inf, math.inf)) - 1
            if i < 0 or length == 0:
                raise MetadataError(f"{self.f.name}: fractal heap object at {off} outside "
                                    "the heap")
            base, size, addr = blocks[i]
            if off + length > base + size or off - base < 13 + self.off_size:
                raise MetadataError(f"{self.f.name}: fractal heap object at {off} outside "
                                    "its block")
            return self._direct(base, size, addr)[off - base:off - base + length]
        if kind == 2:
            if self.id_len - 1 > 16:  # extended tiny length
                length = (((hid[0] & 0x0F) << 8) | hid[1]) + 1
                return bytes(hid[2:2 + length])
            length = (hid[0] & 0x0F) + 1
            if 1 + length > len(hid):
                raise MetadataError(f"{self.f.name}: bad tiny fractal heap object")
            return bytes(hid[1:1 + length])
        if kind == 1:
            if self.id_len >= 17:  # the address and length are in the id
                addr, length = struct.unpack_from("<QQ", hid, 1)
                return self.f._bytes(addr, length)
            if self._huge is None:
                recs = BTree2(self.f, self.huge_btree, 1).records() \
                    if self.huge_btree != UNDEF else []
                self._huge = {struct.unpack_from("<Q", r, 16)[0]: struct.unpack_from("<QQ", r, 0)
                              for r in recs}
            key = _le(hid, 1, min(self.id_len - 1, 8))
            if key not in self._huge:
                raise MetadataError(f"{self.f.name}: huge fractal heap object {key} missing")
            addr, length = self._huge[key]
            return self.f._bytes(addr, length)
        raise MetadataError(f"{self.f.name}: bad fractal heap id type {kind}")


# ------------------------------------------- fixed and extensible arrays
def _chunk_element(raw: bytes, filtered: bool, size_len: int):
    """(address, stored size, filter mask) of a chunk index element; the
    size and mask None for unfiltered chunks."""
    addr = _le(raw, 0, 8)
    if not filtered:
        return addr, None, 0
    return addr, _le(raw, 8, size_len), _le(raw, 8 + size_len, 4)


def _bit(bitmap: bytes, i: int) -> bool:
    """``H5VM_bit_get``: bit ``i``, most significant first."""
    return bool(bitmap[i // 8] & (0x80 >> (i % 8)))


def fixed_array(f, addr: int, filtered: bool, size_len: int) -> dict:
    """Chunk index -> (address, size, mask) of a fixed array's allocated
    elements."""
    head = f._checked(addr, 28, "fixed array header", b"FAHD")
    client, esize, page_bits = head[5], head[6], head[7]
    nelmts, dblk = struct.unpack_from("<QQ", head, 8)
    if client != int(filtered) or esize != (8 + size_len + 4 if filtered else 8):
        raise MetadataError(f"{f.name}: fixed array of client {client}, elements of {esize} "
                            "bytes")
    if nelmts > 1 << 32 or page_bits > 32:
        raise MetadataError(f"{f.name}: fixed array of {nelmts} elements")
    out: dict = {}
    if dblk == UNDEF:
        return out
    page_n = 1 << page_bits
    prefix = 4 + 2 + 8
    if nelmts > page_n:
        npages = -(-nelmts // page_n)
        init_size = (npages + 7) // 8
        block = f._checked(dblk, prefix + init_size + 4, "fixed array data block", b"FADB",
                           client)
        bitmap = block[prefix:prefix + init_size]
        at = dblk + prefix + init_size + 4
        for p in range(npages):
            n = min(page_n, nelmts - p * page_n)
            if _bit(bitmap, p):
                page = f._checked(at, n * esize + 4, "fixed array page")
                for i in range(n):
                    out[p * page_n + i] = _chunk_element(page[i * esize:], filtered,
                                                         size_len)
            at += page_n * esize + 4
    else:
        block = f._checked(dblk, prefix + nelmts * esize + 4, "fixed array data block",
                           b"FADB", client)
        for i in range(nelmts):
            out[i] = _chunk_element(block[prefix + i * esize:], filtered, size_len)
    return {k: v for k, v in out.items() if v[0] != UNDEF}


def extensible_array(f, addr: int, filtered: bool, size_len: int) -> dict:
    """Chunk index -> (address, size, mask) of an extensible array's
    allocated elements (``H5EA__lookup_elmt`` over every element)."""
    head = f._checked(addr, 72, "extensible array header", b"EAHD")
    client, esize, max_bits, idx_n, dblk_min, sblk_min, page_bits = head[5:12]
    iblk = struct.unpack_from("<Q", head, 60)[0]
    if client != int(filtered) or esize != (8 + size_len + 4 if filtered else 8):
        raise MetadataError(f"{f.name}: extensible array of client {client}, elements of "
                            f"{esize} bytes")
    if (dblk_min == 0 or dblk_min & (dblk_min - 1) or sblk_min == 0 or sblk_min & (sblk_min - 1)
            or not 0 < max_bits <= 64 or log2_gen(dblk_min) > max_bits):
        raise MetadataError(f"{f.name}: bad extensible array parameters")
    out: dict = {}
    if iblk == UNDEF:
        return out
    nsblks = 1 + max_bits - log2_gen(dblk_min)
    page_n = 1 << page_bits
    arr_off = (max_bits + 7) // 8
    sblk = []  # (ndblks, dblk_nelmts, start_idx, start_dblk)
    start_idx = start_dblk = 0
    for u in range(nsblks):
        nd, dn = 1 << (u // 2), (1 << ((u + 1) // 2)) * dblk_min
        sblk.append((nd, dn, start_idx, start_dblk))
        start_idx += nd * dn
        start_dblk += nd
    iblk_sblks = 2 * log2_gen(sblk_min)
    ndblk_addrs = 2 * (sblk_min - 1)
    nsblk_addrs = nsblks - iblk_sblks
    prefix = 4 + 2 + 8
    block = f._checked(iblk, prefix + idx_n * esize + 8 * (ndblk_addrs + nsblk_addrs) + 4,
                       "extensible array index block", b"EAIB", client)
    for i in range(idx_n):
        out[i] = _chunk_element(block[prefix + i * esize:], filtered, size_len)
    at = prefix + idx_n * esize
    dblk_addrs = [_le(block, at + 8 * i, 8) for i in range(ndblk_addrs)]
    sblk_addrs = [_le(block, at + 8 * (ndblk_addrs + i), 8) for i in range(nsblk_addrs)]

    def data_block(daddr: int, nelmts: int, first: int, stored: int,
                   bitmap: "bytes | None", bit0: int = 0) -> None:
        if daddr == UNDEF:
            return
        dprefix = prefix + arr_off
        if nelmts > page_n:
            head = f._checked(daddr, dprefix + 4, "extensible array data block", b"EADB",
                              client)
            if _le(head, prefix, arr_off) != stored:
                raise MetadataError(f"{f.name}: extensible array data block at {daddr} has "
                                    "the wrong offset")
            for p in range(nelmts // page_n):
                if bitmap is not None and not _bit(bitmap, bit0 + p):
                    continue
                page = f._checked(daddr + dprefix + 4 + p * (page_n * esize + 4),
                                  page_n * esize + 4, "extensible array page")
                for i in range(page_n):
                    out[first + p * page_n + i] = _chunk_element(page[i * esize:],
                                                                 filtered, size_len)
            return
        body = f._checked(daddr, dprefix + nelmts * esize + 4, "extensible array data block",
                          b"EADB", client)
        if _le(body, prefix, arr_off) != stored:
            raise MetadataError(f"{f.name}: extensible array data block at {daddr} has the "
                                "wrong offset")
        for i in range(nelmts):
            out[first + i] = _chunk_element(body[dprefix + i * esize:], filtered, size_len)

    for u in range(min(iblk_sblks, nsblks)):
        nd, dn, s_idx, s_dblk = sblk[u]
        for d in range(nd):
            if s_dblk + d < ndblk_addrs:
                # the offset HDF5 stores here counts the index block's data
                # blocks, not the super block's (H5EA__iblock's dblk_off)
                data_block(dblk_addrs[s_dblk + d], dn, idx_n + s_idx + d * dn,
                           s_idx + (s_dblk + d) * dn, None)
    for k, saddr in enumerate(sblk_addrs):
        u = iblk_sblks + k
        if saddr == UNDEF:
            continue
        nd, dn, s_idx, _ = sblk[u]
        npages = dn // page_n if dn > page_n else 0
        init = (npages + 7) // 8 if npages else 0
        sb = f._checked(saddr, prefix + arr_off + nd * init + 8 * nd + 4,
                        "extensible array super block", b"EASB", client)
        if _le(sb, prefix, arr_off) != s_idx:
            raise MetadataError(f"{f.name}: extensible array super block at {saddr} has the "
                                "wrong offset")
        at = prefix + arr_off
        # the data blocks' page bits run on from block to block (H5EA__set's
        # page_init_idx), in nd * init bytes
        bitmap = sb[at:at + nd * init] if npages else None
        for d in range(nd):
            daddr = _le(sb, at + nd * init + 8 * d, 8)
            data_block(daddr, dn, idx_n + s_idx + d * dn, s_idx + d * dn, bitmap, d * npages)
    return {k: v for k, v in out.items() if v[0] != UNDEF}


# ------------------------------------------------------------ selections
def selection(f, b: bytes, at: int):
    """``(kind, blocks, end)`` of an encoded dataspace selection at
    ``b[at:]``: ``kind`` 'all', 'none', 'regular' (``blocks`` the per-axis
    lists ``(start, stride, count, block)``) or 'blocks' (``blocks`` the
    ``(first corner, last corner)`` pairs of a block list); ``end`` where
    the encoding ends."""
    kind, version = struct.unpack_from("<II", b, at)
    at += 8
    if kind == 3:  # all
        if version not in (1, 2):
            raise MetadataError(f"{f.name}: bad 'all' selection version {version}")
        return "all", None, at + 8
    if kind == 0:
        return "none", None, at + 8
    if kind == 1:
        raise NotSupportedError(f"{f.name}: HDF5 point selections in virtual-dataset mappings "
                                "are not read by the port")
    if kind != 2:
        raise MetadataError(f"{f.name}: bad HDF5 selection type {kind}")
    if version == 1:
        _res, _length, rank, n = struct.unpack_from("<IIII", b, at)
        at += 16
        corners = []
        for _ in range(n):
            v = struct.unpack_from(f"<{2 * rank}I", b, at)
            at += 8 * rank
            corners.append((list(v[:rank]), list(v[rank:])))
        return "blocks", corners, at
    if version == 2:
        flags = b[at]
        _length, rank = struct.unpack_from("<II", b, at + 1)
        at += 9
        enc = 8
    elif version == 3:
        flags, enc = b[at], b[at + 1]
        (rank,) = struct.unpack_from("<I", b, at + 2)
        at += 6
        if enc not in (2, 4, 8):
            raise MetadataError(f"{f.name}: bad selection encoding size {enc}")
    else:
        raise MetadataError(f"{f.name}: bad hyperslab selection version {version}")
    unlim = (1 << (8 * enc)) - 1

    def num(i):
        return _le(b, at + enc * i, enc)

    if flags & 1:
        vals = [num(i) for i in range(4 * rank)]
        at += 4 * rank * enc
        start, stride, count, blk = (vals[k::4] for k in range(4))
        if unlim in count or unlim in blk:
            raise NotSupportedError(f"{f.name}: unlimited HDF5 virtual-dataset mappings are "
                                    "not read by the port")
        return "regular", (start, stride, count, blk), at
    n = num(0)
    at += enc
    corners = []
    for _ in range(n):
        v = [num(i) for i in range(2 * rank)]
        at += 2 * rank * enc
        corners.append((v[:rank], v[rank:]))
    return "blocks", corners, at


def selection_mask(f, kind: str, blocks, shape: tuple):
    """The boolean mask of a selection over ``shape``."""
    import numpy as np

    mask = np.zeros(shape, bool)
    if kind == "all":
        mask[...] = True
    elif kind == "regular":
        start, stride, count, blk = blocks
        if len(start) != len(shape):
            raise MetadataError(f"{f.name}: selection of rank {len(start)} on a dataspace of "
                                f"rank {len(shape)}")
        axes = []
        for s, st, c, bl, n in zip(start, stride, count, blk, shape):
            idx = np.unique((s + st * np.arange(c)[:, None] + np.arange(bl)[None, :]).ravel())
            if idx.size and idx[-1] >= n:
                raise MetadataError(f"{f.name}: selection past its dataspace")
            axes.append(idx)
        if all(a.size for a in axes):
            mask[np.ix_(*axes)] = True
    elif kind == "blocks":
        for lo, hi in blocks:
            if len(lo) != len(shape) or any(h >= n or l > h for l, h, n in zip(lo, hi, shape)):
                raise MetadataError(f"{f.name}: selection block past its dataspace")
            mask[tuple(slice(l, h + 1) for l, h in zip(lo, hi))] = True
    return mask
