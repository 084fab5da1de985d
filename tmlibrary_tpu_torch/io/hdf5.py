"""A subset of HDF5 without ``h5py``: the files h5py writes with its
default ``libver`` (``'earliest'``), read and written with numpy and
``zlib``.

The JAX package reads Imaris ``.ims`` files and writes and reads
``DatasetWriter``/``DatasetReader`` files and ``export --illumstats``
through ``h5py``, which the port's target machine does not have.  This
module reads what such files hold:

- superblock version 0 or 1 (after a user block of 0, 512, 1024, ...
  bytes);
- version-1 object headers with their continuation blocks;
- groups as symbol tables: version-1 B-trees of type 0 of any depth,
  symbol-table nodes (SNOD) and local heaps;
- scalar and simple dataspaces, with unlimited maximum dimensions;
- fixed-point and floating-point types of either byte order,
  fixed-length strings, and variable-length strings through the global
  heap (h5py writes ``str`` attributes so);
- layout version 3: compact, contiguous, and chunked with the type-1
  B-tree chunk index, partial edge chunks and unallocated chunks read as
  the fill value;
- the deflate (1), shuffle (2) and fletcher32 (3, verified) filters;
- the fill-value messages (old and new) and attribute messages 1-3.

Anything else raises :class:`~tmlibrary_tpu_torch.errors.NotSupportedError`
naming the structure (superblock 2/3, object header 2, link messages,
dense attributes, layout 4, szip, scale-offset, compound, enum,
reference and array types, ...); a damaged file raises
:class:`~tmlibrary_tpu_torch.errors.MetadataError`.  Every read is bounded
by the file and by its stored end-of-file address.

:func:`write` writes a tree of :class:`Group` and :class:`Dataset` in the
same subset -- superblock 0, contiguous datasets, chunked ones (B-trees
split at the default rank of 32) with the filters above, fixed-length
and variable-length string and numeric attributes -- which h5py reads
back.  :func:`load` reads a whole file into such a tree, so a file can be
changed and written again (:class:`tmlibrary_tpu_torch.writers.DatasetWriter`).
"""

from __future__ import annotations

import math
import mmap
import os
import struct
import zlib
from pathlib import Path

import numpy as np

from tmlibrary_tpu_torch.errors import MetadataError, NotSupportedError

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
#: a dataset declaring more bytes than this is taken for a damaged one
MAX_BYTES = 1 << 36
#: rank of the chunk B-tree of a version-0 superblock (HDF5's default)
CHUNK_K = 32
_CORRUPT = (struct.error, IndexError, ValueError, OverflowError, zlib.error, UnicodeDecodeError,
            KeyError, TypeError, RecursionError)


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# --------------------------------------------------------------- the tree
class Dataset:
    """A dataset: its array (read lazily from a file, or given), its
    chunk shape (None when contiguous), ``maxshape`` (None entries
    unlimited), filters as ``[(id, client_data)]``, fill value bytes
    (None when not defined) and attributes."""

    def __init__(self, data=None, *, shape=None, dtype=None, chunks=None, maxshape=None,
                 filters=(), fillvalue=None, attrs=None, _reader=None):
        self._data = None if data is None else np.asarray(data)
        self._reader = _reader
        self.shape = tuple(self._data.shape) if shape is None else tuple(shape)
        self.dtype = self._data.dtype if dtype is None else np.dtype(dtype)
        self.chunks = None if chunks is None else tuple(int(c) for c in chunks)
        self.maxshape = self.shape if maxshape is None else tuple(maxshape)
        self.filters = [(int(f), tuple(int(v) for v in cd)) for f, cd in filters]
        self.fillvalue = fillvalue
        self.attrs = dict(attrs or {})

    @property
    def compression(self) -> "str | None":
        """``'gzip'`` when deflate is in the pipeline (h5py's name)."""
        return "gzip" if any(f == 1 for f, _ in self.filters) else None

    def read(self, box=None) -> np.ndarray:
        """The array, or the ``[(start, stop), ...]`` box of it."""
        if self._data is None:
            return self._reader(box)
        if box is None:
            return self._data
        return self._data[tuple(slice(a, b) for a, b in box)]

    def __getitem__(self, key) -> np.ndarray:
        """Basic indexing (integers and slices); the chunks outside the
        selection are not read."""
        key = key if isinstance(key, tuple) else (key,)
        if any(k is Ellipsis for k in key):
            at = next(i for i, k in enumerate(key) if k is Ellipsis)
            fill = (slice(None),) * (len(self.shape) - len(key) + 1)
            key = key[:at] + fill + key[at + 1:]
        if key == ():
            return self.read()
        if len(key) > len(self.shape):
            raise IndexError(f"too many indices for a dataset of rank {len(self.shape)}")
        box, post = [], []
        for k, n in zip(key + (slice(None),) * (len(self.shape) - len(key)), self.shape):
            if isinstance(k, slice):
                a, b, step = k.indices(n)
                b = max(a, b)
                box.append((a, b) if step == 1 else (0, n))
                post.append(slice(None) if step == 1 else k)
            else:
                i = int(k) + (n if int(k) < 0 else 0)
                if not 0 <= i < n:
                    raise IndexError(f"index {k} out of range for axis of size {n}")
                box.append((i, i + 1))
                post.append(0)
        return self.read(box)[tuple(post)]


class Group:
    """A group: named children (groups and datasets) and attributes."""

    def __init__(self, attrs=None):
        self.children: "dict[str, Group | Dataset]" = {}
        self.attrs = dict(attrs or {})

    def get(self, path: str):
        """The node at a ``/``-separated path, or None."""
        node = self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(node, Group):
                return None
            node = node.children.get(part)
            if node is None:
                return None
        return node

    def __getitem__(self, path: str):
        node = self.get(path)
        if node is None:
            raise KeyError(path)
        return node

    def __contains__(self, path: str) -> bool:
        return self.get(path) is not None

    def require_group(self, path: str) -> "Group":
        node = self
        for part in [p for p in path.split("/") if p]:
            child = node.children.get(part)
            if child is None:
                child = node.children[part] = Group()
            elif not isinstance(child, Group):
                raise ValueError(f"'{part}' is a dataset, not a group")
            node = child
        return node

    def put(self, path: str, node) -> None:
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise ValueError("an empty path")
        self.require_group("/".join(parts[:-1])).children[parts[-1]] = node

    def delete(self, path: str) -> None:
        parts = [p for p in path.split("/") if p]
        parent = self.get("/".join(parts[:-1]))
        if isinstance(parent, Group):
            parent.children.pop(parts[-1], None)

    def visit_datasets(self, prefix: str = ""):
        """``(path, dataset)`` of every dataset below, depth first in name
        order (h5py's ``visititems`` order)."""
        for name in sorted(self.children, key=lambda s: s.encode()):
            node = self.children[name]
            path = f"{prefix}{name}"
            if isinstance(node, Dataset):
                yield path, node
            else:
                yield from node.visit_datasets(path + "/")


# ---------------------------------------------------------------- reading
class _Datatype:
    """A parsed datatype message: numpy dtype, or ``vlen`` for a
    variable-length string (``dtype`` then the element's heap id)."""

    def __init__(self, dtype, vlen=False, encoding="ascii"):
        self.dtype = np.dtype(dtype)
        self.vlen = vlen
        self.encoding = encoding


_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
                8: "enum", 10: "array"}


class File:
    """An HDF5 file of the subset, mapped and parsed lazily."""

    def __init__(self, path):
        self.name = str(path)
        try:
            with open(path, "rb") as f:  # mapped: a reader holds no copy of the file
                size = os.fstat(f.fileno()).st_size
                self.data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) if size else b""
        except OSError as exc:
            raise MetadataError(f"cannot read {path}: {exc}") from exc
        self._heaps: dict = {}
        self._groups: dict = {}
        try:
            self._superblock()
        except _CORRUPT as exc:
            raise MetadataError(f"corrupt HDF5 file {self.name}: {type(exc).__name__}: {exc}") \
                from exc

    # -- bounded access
    def _bytes(self, addr: int, n: int) -> bytes:
        if addr == UNDEF or n < 0 or addr + n > self.eoa:
            raise MetadataError(f"corrupt HDF5 file {self.name}: read of {n} bytes at {addr} "
                                f"past the end ({self.eoa})")
        addr += self.base
        return self.data[addr:addr + n]

    def _u(self, addr: int, n: int) -> int:
        return int.from_bytes(self._bytes(addr, n), "little")

    def _superblock(self) -> None:
        at = 0
        while at + 8 <= len(self.data):
            if self.data[at:at + 8] == SIGNATURE:
                break
            at = 512 if at == 0 else at * 2
        else:
            raise MetadataError(f"not an HDF5 file: {self.name}")
        d = self.data
        version = d[at + 8]
        if version in (2, 3):
            raise NotSupportedError(
                f"{self.name}: HDF5 superblock version {version} (libver 'latest' or 'v108' "
                "and later) is not read by the port")
        if version > 3:
            raise MetadataError(f"{self.name}: bad HDF5 superblock version {version}")
        if d[at + 13] != 8 or d[at + 14] != 8:
            raise NotSupportedError(f"{self.name}: HDF5 offsets/lengths of {d[at + 13]}/"
                                    f"{d[at + 14]} bytes (the port reads 8/8)")
        if d[at + 9] != 0 or d[at + 10] != 0 or d[at + 12] != 0:
            raise MetadataError(f"{self.name}: bad HDF5 superblock component versions")
        self.leaf_k = struct.unpack_from("<H", d, at + 16)[0]
        self.node_k = struct.unpack_from("<H", d, at + 18)[0]
        if self.leaf_k == 0 or self.node_k == 0:
            raise MetadataError(f"{self.name}: bad HDF5 B-tree ranks")
        p = at + 24
        self.chunk_k = CHUNK_K
        if version == 1:
            self.chunk_k = struct.unpack_from("<H", d, p)[0]
            if self.chunk_k == 0:
                raise MetadataError(f"{self.name}: bad HDF5 chunk B-tree rank")
            p += 4
        base, ext, eof, driver = struct.unpack_from("<QQQQ", d, p)
        if base != at and base != 0:
            raise MetadataError(f"{self.name}: bad HDF5 base address {base}")
        if ext != UNDEF:
            # the free-space address field holds a superblock extension
            # since HDF5 1.8; the library opens it as an object header
            raise (NotSupportedError if d[at + 8] == 0 and ext + 16 <= len(d) - base
                   and d[base + ext] == 1 else MetadataError)(
                f"{self.name}: an HDF5 superblock extension at {ext}")
        if driver != UNDEF:
            raise MetadataError(f"{self.name}: an HDF5 driver information block at {driver}")
        self.base = base
        if len(d) - base < eof:
            raise MetadataError(f"truncated HDF5 file {self.name}: {len(d) - base} bytes, "
                                f"stored end of file {eof}")
        self.eoa = eof
        root = p + 32
        self.root_addr, cache = struct.unpack_from("<QI", d, root + 8)
        if cache > 2:
            raise MetadataError(f"{self.name}: unknown HDF5 symbol table entry cache type "
                                f"{cache}")

    # -- object headers
    def _messages(self, addr: int) -> list:
        if self._bytes(addr, 4) == b"OHDR":
            raise NotSupportedError(f"{self.name}: HDF5 object header version 2 is not read "
                                    "by the port")
        version = self._u(addr, 1)
        if version != 1:
            raise MetadataError(f"{self.name}: bad HDF5 object header version {version}")
        size = self._u(addr + 8, 4)
        blocks, seen, out = [(addr + 16, size)], set(), []
        while blocks:
            start, length = blocks.pop(0)
            if (start, length) in seen or len(seen) > 4096:
                raise MetadataError(f"{self.name}: cyclic HDF5 object header continuation")
            seen.add((start, length))
            block = self._bytes(start, length)
            p = 0
            while p + 8 <= length:
                mtype, msize, flags = struct.unpack_from("<HHB", block, p)
                if msize % 8:
                    raise MetadataError(f"{self.name}: HDF5 object header message not aligned")
                if p + 8 + msize > length:
                    raise MetadataError(f"{self.name}: corrupt HDF5 object header")
                body = block[p + 8:p + 8 + msize]
                self._check_flags(mtype, flags)
                if mtype == 0x10:
                    blocks.append(struct.unpack_from("<QQ", body, 0))
                else:
                    out.append((mtype, flags, body))
                p += 8 + msize
        return out

    #: message types HDF5 can share (dataspace, datatype, fill value,
    #: filter pipeline, attribute)
    _SHAREABLE = {0x01, 0x03, 0x05, 0x0B, 0x0C}

    def _check_flags(self, mtype: int, flags: int) -> None:
        """The flag checks HDF5 makes on every message of a header; a
        shared message is outside the subset (h5py's default never
        writes one)."""
        was_unknown, fail_write, fail_always, shareable = 0x20, 0x08, 0x80, 0x40
        if flags & was_unknown and flags & (fail_write | fail_always):
            raise MetadataError(f"{self.name}: bad HDF5 message flag combination {flags:#x}")
        if flags & shareable and mtype <= 0x18 and mtype not in self._SHAREABLE:
            raise MetadataError(f"{self.name}: HDF5 message {mtype:#x} flagged shareable")
        if mtype > 0x18 and flags & fail_always:
            raise MetadataError(f"{self.name}: unknown HDF5 message {mtype:#x} that must be "
                                "understood")
        if flags & 0x02 and mtype in self._SHAREABLE:
            raise MetadataError(f"{self.name}: shared HDF5 message {mtype:#x}")

    # -- datatypes and dataspaces
    def _datatype(self, b: bytes, off: int = 0) -> "tuple[_Datatype, int]":
        cv = b[off]
        cls, version = cv & 0x0F, cv >> 4
        if version not in (1, 2, 3):
            raise MetadataError(f"{self.name}: bad HDF5 datatype version {version}")
        f0, f1 = b[off + 1], b[off + 2]
        size = struct.unpack_from("<I", b, off + 4)[0]
        order = ">" if f0 & 1 else "<"
        if cls == 0:
            bit_off, prec = struct.unpack_from("<HH", b, off + 8)
            if size not in (1, 2, 4, 8) or bit_off != 0 or prec != 8 * size:
                raise MetadataError(f"{self.name}: HDF5 integer of {size} bytes, precision "
                                    f"{prec} at bit {bit_off}")
            return _Datatype(f"{order}{'i' if f0 & 8 else 'u'}{size}"), 12
        if cls == 1:
            if f0 & 0x40:
                raise NotSupportedError(f"{self.name}: VAX-order HDF5 floats")
            layout = struct.unpack_from("<HHBBBBI", b, off + 8)
            want = {2: (0, 16, 10, 5, 0, 10, 15), 4: (0, 32, 23, 8, 0, 23, 127),
                    8: (0, 64, 52, 11, 0, 52, 1023)}.get(size)
            if want is None or layout != want or f1 != 8 * size - 1:
                raise MetadataError(f"{self.name}: HDF5 float of {size} bytes with layout "
                                    f"{layout}")
            return _Datatype(f"{order}f{size}"), 20
        if cls == 3:
            if size == 0:
                raise MetadataError(f"{self.name}: HDF5 string of 0 bytes")
            return _Datatype(f"S{size}"), 8
        if cls == 9:
            if f0 & 0x0F != 1:
                raise NotSupportedError(f"{self.name}: HDF5 variable-length sequences")
            base, used = self._datatype(b, off + 8)
            return _Datatype("V16", vlen=True,
                             encoding="utf-8" if f1 & 0x0F == 1 else "ascii"), 8 + used
        if cls in _CLASS_NAMES:
            raise NotSupportedError(f"{self.name}: HDF5 {_CLASS_NAMES[cls]} datatypes are not "
                                    "read by the port")
        raise MetadataError(f"{self.name}: bad HDF5 datatype class {cls}")

    def _dataspace(self, b: bytes) -> "tuple[tuple, tuple]":
        version, ndims, flags = b[0], b[1], b[2]
        if version == 1:
            p = 8
        elif version == 2:
            if b[3] == 2:
                raise NotSupportedError(f"{self.name}: HDF5 null dataspaces")
            p = 4
        else:
            raise MetadataError(f"{self.name}: bad HDF5 dataspace version {version}")
        if ndims > 32:
            raise MetadataError(f"{self.name}: HDF5 dataspace of rank {ndims}")
        dims = struct.unpack_from(f"<{ndims}Q", b, p)
        maxdims = dims
        if flags & 1:
            maxdims = struct.unpack_from(f"<{ndims}Q", b, p + 8 * ndims)
        maxshape = tuple(None if m == UNDEF else int(m) for m in maxdims)
        return tuple(int(d) for d in dims), maxshape

    # -- heaps
    def _local_heap(self, addr: int) -> "tuple[int, int]":
        """(data address, data size) of a local heap, its header and free
        list checked as HDF5 checks them when it loads the heap."""
        cached = self._heaps.get(("local", addr))
        if cached is not None:
            return cached
        head = self._bytes(addr, 32)
        if head[:4] != b"HEAP" or head[4] != 0:
            raise MetadataError(f"{self.name}: bad HDF5 local heap at {addr}")
        size, free, data = struct.unpack_from("<QQQ", head, 8)
        block = self._bytes(data, size)
        seen = set()
        while free != 1:  # 1: no free block
            if free >= size or free in seen or free + 16 > size:
                raise MetadataError(f"{self.name}: bad HDF5 local heap free list")
            seen.add(free)
            nxt, fsize = struct.unpack_from("<QQ", block, free)
            if nxt == 0 or free + fsize > size:
                raise MetadataError(f"{self.name}: bad HDF5 local heap free list")
            free = nxt
        self._heaps[("local", addr)] = (data, size)
        return data, size

    def _heap_bytes(self, heap: "tuple[int, int]", offset: int) -> bytes:
        data, size = heap
        if offset >= size:
            raise MetadataError(f"{self.name}: HDF5 name offset {offset} past its heap")
        raw = self._bytes(data + offset, size - offset)
        end = raw.find(b"\0")
        if end < 0:
            raise MetadataError(f"{self.name}: unterminated HDF5 name")
        return raw[:end]

    def _global_object(self, addr: int, index: int) -> bytes:
        objs = self._heaps.get(("global", addr))
        if objs is None:
            head = self._bytes(addr, 16)
            if head[:4] != b"GCOL" or head[4] != 1:
                raise MetadataError(f"{self.name}: bad HDF5 global heap at {addr}")
            size = struct.unpack_from("<Q", head, 8)[0]
            block = self._bytes(addr, size)
            objs, p = {}, 16
            while p + 16 <= size:
                idx, _refs, osize = struct.unpack_from("<HH4xQ", block, p)
                if idx == 0:
                    break
                if p + 16 + osize > size:
                    raise MetadataError(f"{self.name}: corrupt HDF5 global heap object")
                objs[idx] = block[p + 16:p + 16 + osize]
                p += 16 + _pad8(osize)
            self._heaps[("global", addr)] = objs
        if index not in objs:
            raise MetadataError(f"{self.name}: HDF5 global heap object {index} missing")
        return objs[index]

    # -- groups
    def _node(self, addr: int, kind: int, rank: int = 0):
        """A version-1 B-tree node: (level, keys, children)."""
        head = self._bytes(addr, 24)
        if head[:4] != b"TREE":
            raise MetadataError(f"{self.name}: bad HDF5 B-tree node at {addr}")
        if head[4] != kind:
            raise MetadataError(f"{self.name}: HDF5 B-tree of type {head[4]} where {kind} belongs")
        level, n = head[5], struct.unpack_from("<H", head, 6)[0]
        k = self.node_k if kind == 0 else self.chunk_k
        if n > 2 * k:
            raise MetadataError(f"{self.name}: HDF5 B-tree node with {n} entries")
        ksize = 8 if kind == 0 else 8 + 8 * (rank + 1)
        self._bytes(addr, 24 + 2 * k * 8 + (2 * k + 1) * ksize)  # HDF5 loads the whole node
        body = self._bytes(addr + 24, n * (8 + ksize) + ksize)
        keys = [body[i * (8 + ksize):i * (8 + ksize) + ksize] for i in range(n + 1)]
        children = [struct.unpack_from("<Q", body, i * (8 + ksize) + ksize)[0] for i in range(n)]
        return level, keys, children

    def _btree(self, addr: int, kind: int, rank: int = 0, depth: int = 0):
        """``(key, child, next key)`` of every leaf entry of a version-1
        B-tree of ``kind`` 0 (groups) or 1 (chunks), in order."""
        if depth > 64:
            raise MetadataError(f"{self.name}: HDF5 B-tree deeper than 64 levels")
        level, keys, children = self._node(addr, kind, rank)
        for i, child in enumerate(children):
            if level > 0:
                yield from self._btree(child, kind, rank, depth + 1)
            else:
                yield keys[i], child, keys[i + 1]

    def _stab(self, addr: int) -> "tuple[int, tuple[int, int]]":
        """(B-tree address, local heap) of the group at ``addr``."""
        msgs = self._messages(addr)
        stab = [b for t, _, b in msgs if t == 0x11]
        if not stab:
            if {t for t, _, _ in msgs} & {0x02, 0x06, 0x0A}:
                raise NotSupportedError(f"{self.name}: HDF5 link messages (new-style groups) "
                                        "are not read by the port")
            raise MetadataError(f"{self.name}: HDF5 object at {addr} is not a group")
        btree, heap = struct.unpack_from("<QQ", stab[0], 0)
        return btree, self._local_heap(heap)

    def _snod(self, addr: int) -> "list[tuple[int, int]]":
        """(name offset, object address) of a symbol-table node's entries,
        each entry checked as HDF5 decodes it."""
        head = self._bytes(addr, 8 + 2 * self.leaf_k * 40)  # HDF5 loads the whole node
        if head[:4] != b"SNOD" or head[4] != 1:
            raise MetadataError(f"{self.name}: bad HDF5 symbol table node at {addr}")
        n = struct.unpack_from("<H", head, 6)[0]
        if n > 2 * self.leaf_k:
            raise MetadataError(f"{self.name}: HDF5 symbol table node with {n} entries")
        entries = self._bytes(addr + 8, 40 * n)
        out = []
        for i in range(n):
            name_off, obj, cache = struct.unpack_from("<QQI", entries, 40 * i)
            if cache > 2:
                raise MetadataError(f"{self.name}: unknown HDF5 symbol table entry cache "
                                    f"type {cache}")
            out.append((name_off, obj))
        return out

    def _members(self, addr: int) -> "dict[str, int]":
        """Every member of a group, in B-tree order (HDF5's iteration:
        the B-tree's keys are not read)."""
        if addr in self._groups:
            return self._groups[addr]
        btree, heap = self._stab(addr)
        members: dict = {}
        for _key, snod, _next in self._btree(btree, 0):
            for name_off, obj in self._snod(snod):
                members[self._heap_bytes(heap, name_off).decode("utf-8")] = obj
        self._groups[addr] = members
        return members

    def _lookup(self, addr: int, name: str) -> "int | None":
        """One member by name as HDF5 finds it: a binary search down the
        B-tree by its keys' names, then through the symbol-table node."""
        btree, heap = self._stab(addr)
        want = name.encode("utf-8")
        node, depth = btree, 0
        while True:
            level, keys, children = self._node(node, 0)
            lt, rt, cmp, idx = 0, len(children), 1, 0
            while lt < rt and cmp:
                idx = (lt + rt) // 2
                left = self._heap_bytes(heap, struct.unpack("<Q", keys[idx])[0])
                if want <= left:
                    cmp = -1
                else:
                    right = self._heap_bytes(heap, struct.unpack("<Q", keys[idx + 1])[0])
                    cmp = 1 if want > right else 0
                if cmp < 0:
                    rt = idx
                else:
                    lt = idx + 1
            if cmp:
                return None
            if level == 0:
                break
            node, depth = children[idx], depth + 1
            if depth > 64:
                raise MetadataError(f"{self.name}: HDF5 B-tree deeper than 64 levels")
        entries = self._snod(children[idx])
        lt, rt, cmp = 0, len(entries), 1
        while lt < rt and cmp:
            idx = (lt + rt) // 2
            s = self._heap_bytes(heap, entries[idx][0])
            cmp = (want > s) - (want < s)
            if cmp < 0:
                rt = idx
            else:
                lt = idx + 1
        return None if cmp else entries[idx][1]

    def resolve(self, path: str) -> "int | None":
        """The object header address at ``path``, or None."""
        addr = self.root_addr
        try:
            for part in [p for p in path.split("/") if p]:
                addr = self._lookup(addr, part)
                if addr is None:
                    return None
        except _CORRUPT as exc:
            raise MetadataError(f"corrupt HDF5 file {self.name}: {type(exc).__name__}: {exc}") \
                from exc
        return addr

    def members(self, path: str) -> "list[str]":
        """The names in the group at ``path`` (KeyError when absent)."""
        addr = self.resolve(path)
        if addr is None:
            raise KeyError(path)
        try:
            return list(self._members(addr))
        except _CORRUPT as exc:
            raise MetadataError(f"corrupt HDF5 file {self.name}: {type(exc).__name__}: {exc}") \
                from exc

    # -- objects
    def node(self, path: str = "/"):
        """A :class:`Group` (children loaded on demand through
        :meth:`load`) or :class:`Dataset` at ``path``; KeyError when
        absent."""
        addr = self.resolve(path)
        if addr is None:
            raise KeyError(path)
        return self._object(addr)

    def _object(self, addr: int):
        try:
            msgs = self._messages(addr)
            attrs = self._attributes(msgs)
            kinds = {t for t, _, _ in msgs}
            if kinds & {0x02, 0x06, 0x0A}:
                raise NotSupportedError(f"{self.name}: HDF5 link messages (new-style groups) "
                                        "are not read by the port")
            if 0x11 in kinds:
                return Group(attrs)
            return self._dataset(msgs, attrs)
        except _CORRUPT as exc:
            raise MetadataError(f"corrupt HDF5 file {self.name}: {type(exc).__name__}: {exc}") \
                from exc

    def _attributes(self, msgs) -> dict:
        out = {}
        for t, _flags, b in msgs:
            if t == 0x15:
                raise NotSupportedError(f"{self.name}: HDF5 dense attribute storage is not read "
                                        "by the port")
            if t != 0x0C:
                continue
            version = b[0]
            if version == 1:
                nsize, tsize, ssize = struct.unpack_from("<HHH", b, 2)
                p, pad = 8, _pad8
            elif version in (2, 3):
                if b[1] & 3:
                    raise NotSupportedError(f"{self.name}: shared HDF5 attribute types")
                nsize, tsize, ssize = struct.unpack_from("<HHH", b, 2)
                p, pad = (8 if version == 2 else 9), (lambda n: n)
            else:
                raise MetadataError(f"{self.name}: bad HDF5 attribute version {version}")
            name = b[p:p + nsize].split(b"\0")[0].decode("utf-8")
            p += pad(nsize)
            dtype, _ = self._datatype(b[p:p + tsize])
            p += pad(tsize)
            shape, _ = self._dataspace(b[p:p + ssize])
            p += pad(ssize)
            out[name] = self._values(b[p:], dtype, shape)
        return out

    def _values(self, raw: bytes, dtype: _Datatype, shape: tuple):
        n = math.prod(shape)
        if n * dtype.dtype.itemsize > len(raw):
            raise MetadataError(f"{self.name}: HDF5 attribute data shorter than its shape")
        if dtype.vlen:
            vals = []
            for i in range(n):
                length, heap, index = struct.unpack_from("<IQI", raw, 16 * i)
                obj = self._global_object(heap, index) if length else b""
                if len(obj) < length:
                    raise MetadataError(f"{self.name}: short HDF5 variable-length string")
                vals.append(obj[:length].decode(dtype.encoding))
            if not shape:
                return vals[0]
            return np.array(vals, dtype=object).reshape(shape)
        arr = np.frombuffer(raw, dtype.dtype, count=n).reshape(shape).copy()
        return arr[()] if not shape else arr

    def _dataset(self, msgs, attrs) -> Dataset:
        by = {}
        for t, _, b in msgs:
            by.setdefault(t, b)
        if 0x01 not in by or 0x03 not in by or 0x08 not in by:
            raise MetadataError(f"{self.name}: HDF5 object without a dataspace, datatype or "
                                "layout")
        shape, maxshape = self._dataspace(by[0x01])
        dtype, _ = self._datatype(by[0x03])
        if dtype.vlen:
            raise NotSupportedError(f"{self.name}: HDF5 datasets of variable-length strings")
        itemsize = dtype.dtype.itemsize
        nbytes = math.prod(shape) * itemsize
        if nbytes > MAX_BYTES:
            raise MetadataError(f"{self.name}: HDF5 dataset of {nbytes} bytes")
        filters = self._filters(by[0x0B]) if 0x0B in by else []
        fill = self._fill(by, itemsize)
        lay = by[0x08]
        if lay[0] != 3:
            if lay[0] == 4:
                raise NotSupportedError(f"{self.name}: HDF5 data layout version 4 (fixed and "
                                        "extensible array chunk indexes) is not read by the port")
            raise NotSupportedError(f"{self.name}: HDF5 data layout version {lay[0]}")
        cls = lay[1]
        ds = Dataset(shape=shape, dtype=dtype.dtype, maxshape=maxshape, filters=filters,
                     fillvalue=fill, attrs=attrs)
        if cls == 0:
            size = struct.unpack_from("<H", lay, 2)[0]
            raw = lay[4:4 + size]
            if size < nbytes or len(raw) < size:
                raise MetadataError(f"{self.name}: HDF5 compact data shorter than its dataset")
            ds._reader = self._flat_reader(lambda: raw[:nbytes], shape, dtype.dtype)
        elif cls == 1:
            addr, _size = struct.unpack_from("<QQ", lay, 2)
            if addr == UNDEF:
                ds._reader = self._flat_reader(
                    lambda: self._filled(fill, itemsize, nbytes), shape, dtype.dtype)
            else:
                if addr + nbytes > self.eoa:
                    raise MetadataError(f"{self.name}: HDF5 dataset storage past the end of "
                                        "the file")
                ds._reader = self._flat_reader(lambda: self._bytes(addr, nbytes), shape,
                                               dtype.dtype)
        elif cls == 2:
            nd = lay[2]
            addr = struct.unpack_from("<Q", lay, 3)[0]
            dims = struct.unpack_from(f"<{nd}I", lay, 11)
            if nd != len(shape) + 1 or dims[-1] != itemsize or 0 in dims:
                raise MetadataError(f"{self.name}: HDF5 chunk dimensions {dims} for shape "
                                    f"{shape}")
            ds.chunks = tuple(int(c) for c in dims[:-1])
            ds._reader = self._chunk_reader(addr, ds, fill)
        elif cls == 3:
            raise NotSupportedError(f"{self.name}: HDF5 virtual datasets")
        else:
            raise MetadataError(f"{self.name}: bad HDF5 layout class {cls}")
        return ds

    def _filters(self, b: bytes) -> list:
        version, n = b[0], b[1]
        if version not in (1, 2):
            raise MetadataError(f"{self.name}: bad HDF5 filter pipeline version {version}")
        p, out = (8 if version == 1 else 2), []
        for _ in range(n):
            fid = struct.unpack_from("<H", b, p)[0]
            if version == 1 or fid >= 256:
                namelen = struct.unpack_from("<H", b, p + 2)[0]
                _flags, nvals = struct.unpack_from("<HH", b, p + 4)
                p += 8
            else:
                namelen = 0
                _flags, nvals = struct.unpack_from("<HH", b, p + 2)
                p += 6
            p += _pad8(namelen) if version == 1 else namelen
            vals = struct.unpack_from(f"<{nvals}I", b, p)
            p += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
            if fid not in (1, 2, 3):
                name = {4: "szip", 5: "nbit", 6: "scale-offset"}.get(fid, f"filter {fid}")
                raise NotSupportedError(f"{self.name}: the HDF5 {name} filter is not read by "
                                        "the port")
            out.append((fid, vals))
        return out

    def _fill(self, by: dict, itemsize: int) -> "bytes | None":
        def value(b: bytes, at: int) -> "bytes | None":
            size = struct.unpack_from("<I", b, at)[0]
            if at + 4 + size > len(b) or size not in (0, itemsize):
                raise MetadataError(f"{self.name}: HDF5 fill value of {size} bytes for "
                                    f"{itemsize}-byte elements")
            return bytes(b[at + 4:at + 4 + size]) if size else None

        b = by.get(0x05)
        if b is not None:
            version = b[0]
            if version in (1, 2):
                return value(b, 4) if version == 1 or b[3] else None
            if version == 3:
                return value(b, 2) if b[1] & 0x20 else None
            raise MetadataError(f"{self.name}: bad HDF5 fill value version {version}")
        b = by.get(0x04)
        return None if b is None else value(b, 0)

    @staticmethod
    def _filled(fill, itemsize: int, nbytes: int) -> bytes:
        if fill is None or len(fill) != itemsize:
            return bytes(nbytes)
        return fill * (nbytes // itemsize)

    def _flat_reader(self, get, shape, dtype):
        def read(box):
            try:
                arr = np.frombuffer(get(), dtype).reshape(shape)
            except _CORRUPT as exc:
                raise MetadataError(f"corrupt HDF5 file {self.name}: {type(exc).__name__}: "
                                    f"{exc}") from exc
            if box is not None:
                arr = arr[tuple(slice(a, b) for a, b in box)]
            return arr.copy()

        return read

    def _chunk_reader(self, btree: int, ds: Dataset, fill):
        shape, chunks, dtype = ds.shape, ds.chunks, ds.dtype
        itemsize = dtype.itemsize
        filters = ds.filters

        index: list = []  # (offsets, address, size, filter mask), read once

        def read(box):
            box = [(0, n) for n in shape] if box is None else list(box)
            out_shape = tuple(b - a for a, b in box)
            out = np.frombuffer(self._filled(fill, itemsize, math.prod(out_shape) * itemsize),
                                dtype).reshape(out_shape).copy()
            if btree == UNDEF or 0 in out_shape:
                return out
            try:
                if not index:
                    built = []
                    for key, addr, _next in self._btree(btree, 1, len(shape)):
                        size, mask = struct.unpack_from("<II", key, 0)
                        offs = struct.unpack_from(f"<{len(shape)}Q", key, 8)
                        if any(o % c for o, c in zip(offs, chunks)):
                            raise MetadataError(f"{self.name}: HDF5 chunk offset {offs} off "
                                                "its grid")
                        built.append((offs, addr, size, mask))
                    index[:] = built
                for offs, addr, size, mask in index:
                    if any(o >= n for o, n in zip(offs, shape)):
                        continue
                    lo = [max(a, o) for (a, _), o in zip(box, offs)]
                    hi = [min(b, o + c) for (_, b), o, c in zip(box, offs, chunks)]
                    if any(l >= h for l, h in zip(lo, hi)):
                        continue
                    chunk = self._chunk(addr, size, mask, filters, math.prod(chunks) * itemsize)
                    arr = np.frombuffer(chunk, dtype).reshape(chunks)
                    src = tuple(slice(l - o, h - o) for l, h, o in zip(lo, hi, offs))
                    dst = tuple(slice(l - a, h - a) for l, h, (a, _) in zip(lo, hi, box))
                    out[dst] = arr[src]
            except _CORRUPT as exc:
                raise MetadataError(f"corrupt HDF5 file {self.name}: {type(exc).__name__}: "
                                    f"{exc}") from exc
            return out

        return read

    def _chunk(self, addr: int, size: int, mask: int, filters, expect: int) -> bytes:
        data = self._bytes(addr, size)
        for i in range(len(filters) - 1, -1, -1):
            if mask & (1 << i):
                continue
            fid, cd = filters[i]
            if fid == 1:
                d = zlib.decompressobj()
                data = d.decompress(data, expect + 1)
                if len(data) > expect:
                    raise MetadataError(f"{self.name}: HDF5 chunk inflates past its size")
            elif fid == 2:
                elem = cd[0] if cd else 1
                n = len(data) // elem
                if elem > 1 and n:
                    head = np.frombuffer(data, np.uint8, count=n * elem)
                    data = head.reshape(elem, n).T.tobytes() + data[n * elem:]
            elif fid == 3:
                if len(data) < 4:
                    raise MetadataError(f"{self.name}: HDF5 chunk too short for fletcher32")
                body, stored = data[:-4], struct.unpack_from("<I", data, len(data) - 4)[0]
                want = fletcher32(body)
                swapped = ((want & 0x00FF00FF) << 8) | ((want >> 8) & 0x00FF00FF)
                if stored not in (want, swapped):
                    raise MetadataError(f"{self.name}: HDF5 data error detected by the "
                                        "fletcher32 checksum")
                data = body
        if len(data) != expect:
            raise MetadataError(f"{self.name}: HDF5 chunk of {len(data)} bytes, expected "
                                f"{expect}")
        return data

    # -- whole-file load
    def load(self, path: str = "/") -> Group:
        """The group at ``path`` with everything below it read into
        memory (datasets as arrays)."""
        addr = self.resolve(path)
        if addr is None:
            raise KeyError(path)
        try:
            return self._load(addr, set())
        except _CORRUPT as exc:
            raise MetadataError(f"corrupt HDF5 file {self.name}: {type(exc).__name__}: {exc}") \
                from exc

    def _load(self, addr: int, seen: set):
        if addr in seen:
            raise MetadataError(f"{self.name}: HDF5 group cycle at {addr}")
        node = self._object(addr)
        if isinstance(node, Dataset):
            node._data = node.read()
            node._reader = None
            return node
        for name, child in self._members(addr).items():
            node.children[name] = self._load(child, seen | {addr})
        return node


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 (``H5_checksum_fletcher32``): big-endian 16-bit
    words, sums folded every 360 words, an odd last byte as a high byte."""
    n = len(data)
    words = np.frombuffer(data, ">u2", count=n // 2).astype(np.uint64)
    s1 = s2 = 0
    for start in range(0, len(words), 360):
        w = words[start:start + 360]
        c = np.cumsum(w)
        s2 = (s2 + int(c.sum()) + len(w) * s1) & 0xFFFFFFFF  # uint32 sums, as in C
        s1 = (s1 + int(c[-1])) & 0xFFFFFFFF
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    if n % 2:
        s1 += data[-1] << 8
        s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    s1 = (s1 & 0xFFFF) + (s1 >> 16)
    s2 = (s2 & 0xFFFF) + (s2 >> 16)
    return ((s2 << 16) | s1) & 0xFFFFFFFF


def load(path) -> Group:
    """The whole file at ``path`` as a :class:`Group` tree in memory."""
    return File(path).load()


# ---------------------------------------------------------------- writing
def guess_chunk(shape, maxshape, typesize: int) -> tuple:
    """h5py's chunk shape for a dataset (``h5py/_hl/filters.py``
    ``guess_chunk``): unlimited or zero axes taken as 1024, then axes
    halved in turn until a chunk is near ``16 KiB * 2**log10(MiB)``
    within 8 KiB-1 MiB."""
    shape = tuple((x if x != 0 else 1024) for x in shape)
    ndims = len(shape)
    chunks = np.array(shape, dtype="=f8")
    dset_size = np.prod(chunks) * typesize
    target = 16 * 1024 * (2 ** np.log10(dset_size / (1024.0 * 1024)))
    target = min(max(target, 8 * 1024), 1024 * 1024)
    idx = 0
    while True:
        chunk_bytes = np.prod(chunks) * typesize
        if (chunk_bytes < target or abs(chunk_bytes - target) / target < 0.5) and \
                chunk_bytes < 1024 * 1024:
            break
        if np.prod(chunks) == 1:
            break
        chunks[idx % ndims] = np.ceil(chunks[idx % ndims] / 2.0)
        idx += 1
    return tuple(int(x) for x in chunks)


def _dtype_message(dt: np.dtype) -> bytes:
    dt = np.dtype(dt)
    order = 1 if dt.byteorder == ">" or (dt.byteorder == "=" and not _LITTLE) else 0
    if dt.kind in "iu" and dt.itemsize in (1, 2, 4, 8):
        return struct.pack("<BBBBIHH", 0x10, order | (8 if dt.kind == "i" else 0), 0, 0,
                           dt.itemsize, 0, 8 * dt.itemsize)
    if dt.kind == "f" and dt.itemsize in (2, 4, 8):
        layout = {2: (16, 10, 5, 0, 10, 15), 4: (32, 23, 8, 0, 23, 127),
                  8: (64, 52, 11, 0, 52, 1023)}[dt.itemsize]
        return struct.pack("<BBBBIHHBBBBI", 0x11, order | 0x20, 8 * dt.itemsize - 1, 0,
                           dt.itemsize, 0, *layout)
    if dt.kind == "S" and dt.itemsize > 0:
        return struct.pack("<BBBBI", 0x13, 1, 0, 0, dt.itemsize)  # null-padded ASCII
    raise NotSupportedError(f"the port's HDF5 writer takes integers, floats and fixed-length "
                            f"byte strings, not {dt}")


#: a variable-length UTF-8 string type (h5py's ``str`` attributes)
_VLEN_STR = struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0, 16) + struct.pack("<BBBBI", 0x13, 0, 1, 0, 1)
_LITTLE = np.little_endian


def _space_message(shape, maxshape=None) -> bytes:
    out = struct.pack("<BBBB4x", 1, len(shape), 1 if maxshape is not None else 0, 0)
    out += struct.pack(f"<{len(shape)}Q", *shape)
    if maxshape is not None:
        out += struct.pack(f"<{len(shape)}Q", *(UNDEF if m is None else m for m in maxshape))
    return out


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = body + b"\0" * (_pad8(len(body)) - len(body))
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


class _Writer:
    def __init__(self, root: Group):
        self.buf = bytearray(96)  # the superblock, filled in last
        self.leaf_k = 4
        self._max_members(root)

    def _max_members(self, g: Group) -> None:
        self.leaf_k = max(self.leaf_k, (len(g.children) + 1) // 2)
        for child in g.children.values():
            if isinstance(child, Group):
                self._max_members(child)

    def alloc(self, data: bytes) -> int:
        at = len(self.buf)
        self.buf += data
        self.buf += b"\0" * (_pad8(len(self.buf)) - len(self.buf))
        return at

    def attributes(self, attrs: dict) -> bytes:
        out = b""
        for name, value in attrs.items():
            nm = name.encode("utf-8") + b"\0"
            if isinstance(value, str) or (isinstance(value, np.ndarray) and value.dtype == object):
                strs = [value] if isinstance(value, str) else [str(v) for v in value.ravel()]
                shape = () if isinstance(value, str) else value.shape
                dtm, raw = _VLEN_STR, self.vlen_strings(strs)
            else:
                arr = np.asarray(value)
                if arr.dtype.kind == "U":
                    arr = np.char.encode(arr, "utf-8")
                dtm, shape, raw = _dtype_message(arr.dtype), arr.shape, arr.tobytes()
            space = _space_message(shape)
            body = struct.pack("<BBHHH", 1, 0, len(nm), len(dtm), len(space))
            for part in (nm, dtm, space):
                body += part + b"\0" * (_pad8(len(part)) - len(part))
            out += _message(0x0C, body + raw)
        return out

    def vlen_strings(self, strs) -> bytes:
        objs = [s.encode("utf-8") for s in strs]
        body = b""
        for i, o in enumerate(objs, 1):
            body += struct.pack("<HH4xQ", i, 1, len(o)) + o + b"\0" * (_pad8(len(o)) - len(o))
        size = max(4096, 16 + len(body) + 16)
        free = size - 16 - len(body)
        block = b"GCOL\x01\0\0\0" + struct.pack("<Q", size) + body + \
            struct.pack("<HH4xQ", 0, 0, free) + b"\0" * (free - 16)
        addr = self.alloc(block)
        return b"".join(struct.pack("<IQI", len(o), addr, i) for i, o in enumerate(objs, 1))

    def header(self, messages: bytes, count: int) -> int:
        if not messages:
            messages, count = _message(0, b""), 1
        return self.alloc(struct.pack("<BBHII4x", 1, 0, count, 1, len(messages)) + messages)

    def group(self, g: Group) -> "tuple[int, int, int]":
        names = sorted(g.children, key=lambda s: s.encode("utf-8"))
        addrs = {n: self.node(g.children[n]) for n in names}
        heap = bytearray(8)  # offset 0: the empty name
        offsets = {}
        for n in names:
            offsets[n] = len(heap)
            raw = n.encode("utf-8") + b"\0"
            heap += raw + b"\0" * (_pad8(len(raw)) - len(raw))
        heap_data = self.alloc(bytes(heap))
        heap_addr = self.alloc(b"HEAP\0\0\0\0" + struct.pack("<QQQ", len(heap), 1, heap_data))
        snod = b"SNOD\x01\0" + struct.pack("<H", len(names))
        for n in names:
            child = addrs[n]
            snod += struct.pack("<QQI4x", offsets[n], child[0], 1 if child[1] else 0)
            snod += struct.pack("<QQ", child[1], child[2]) if child[1] else bytes(16)
        snod += bytes(8 + 2 * self.leaf_k * 40 - len(snod))
        snod_addr = self.alloc(snod)
        node = b"TREE\0\0" + struct.pack("<HQQ", 1 if names else 0, UNDEF, UNDEF)
        if names:
            node += struct.pack("<QQQ", 0, snod_addr, offsets[names[-1]])
        node += bytes(24 + 2 * 16 * 8 + (2 * 16 + 1) * 8 - len(node))
        tree = self.alloc(node)
        msgs = _message(0x11, struct.pack("<QQ", tree, heap_addr)) + self.attributes(g.attrs)
        return self.header(msgs, 1 + len(g.attrs)), tree, heap_addr

    def node(self, n) -> "tuple[int, int, int]":
        """(object header, B-tree, heap) -- the last two 0 for a dataset."""
        if isinstance(n, Group):
            return self.group(n)
        return self.dataset(n), 0, 0

    def dataset(self, ds: Dataset) -> int:
        arr = np.asarray(ds.read(), order="C")  # keeps a scalar's shape ()
        dtm = _dtype_message(arr.dtype)
        shape = tuple(arr.shape)
        itemsize = arr.dtype.itemsize
        msgs = _message(0x01, _space_message(shape, ds.maxshape if ds.chunks else None))
        msgs += _message(0x03, dtm, flags=1)
        fill = ds.fillvalue if ds.fillvalue is not None else bytes(itemsize)
        alloc_time = 3 if ds.chunks else 2
        msgs += _message(0x05, struct.pack("<BBBBI", 2, alloc_time, 2, 1, itemsize) + fill)
        count = 3
        if ds.chunks:
            if ds.filters:
                body = struct.pack("<BB6x", 1, len(ds.filters))
                for fid, cd in ds.filters:
                    body += struct.pack("<HHHH", fid, 0, 1 if fid == 1 else 0, len(cd))
                    body += struct.pack(f"<{len(cd)}I", *cd) + (b"\0" * 4 if len(cd) % 2 else b"")
                msgs += _message(0x0B, body)
                count += 1
            tree = self.chunk_tree(arr, ds)
            lay = struct.pack("<BBBQ", 3, 2, len(shape) + 1, tree)
            lay += struct.pack(f"<{len(shape) + 1}I", *ds.chunks, itemsize)
        else:
            raw = arr.tobytes()
            addr = self.alloc(raw) if raw else UNDEF
            lay = struct.pack("<BBQQ", 3, 1, addr, len(raw))
        msgs += _message(0x08, lay)
        msgs += self.attributes(ds.attrs)
        return self.header(msgs, count + 1 + len(ds.attrs))

    def chunk_tree(self, arr: np.ndarray, ds: Dataset) -> int:
        chunks, rank = ds.chunks, arr.ndim
        grid = [range(0, n, c) for n, c in zip(arr.shape, chunks)]
        entries = []
        for offs in np.ndindex(*[len(g) for g in grid]):
            o = tuple(g[i] for g, i in zip(grid, offs))
            block = np.zeros(chunks, arr.dtype)
            sel = tuple(slice(a, min(a + c, n)) for a, c, n in zip(o, chunks, arr.shape))
            block[tuple(slice(0, s.stop - s.start) for s in sel)] = arr[sel]
            data = block.tobytes()
            for fid, cd in ds.filters:
                if fid == 2 and arr.dtype.itemsize > 1:
                    data = np.frombuffer(data, np.uint8).reshape(-1, arr.dtype.itemsize).T.tobytes()
                elif fid == 1:
                    data = zlib.compress(data, cd[0] if cd else 4)
                elif fid == 3:
                    data = data + struct.pack("<I", fletcher32(data))
            entries.append((o, self.alloc(data), len(data)))
        if not entries:
            return UNDEF

        def key(size, offs):
            return struct.pack("<II", size, 0) + struct.pack(f"<{rank + 1}Q", *offs, 0)

        last = entries[-1][0]
        end_key = key(0, tuple(a + c for a, c in zip(last, chunks)))
        level = [(e[0], e[1], e[2]) for e in entries]  # (first offset, address, size)
        depth = 0
        while True:
            groups = [level[i:i + 2 * CHUNK_K] for i in range(0, len(level), 2 * CHUNK_K)]
            ksize = 8 + 8 * (rank + 1)
            full = 24 + 2 * CHUNK_K * 8 + (2 * CHUNK_K + 1) * ksize
            addrs = [self.alloc(bytes(full)) for _ in groups]
            upper = []
            for gi, grp in enumerate(groups):
                left = addrs[gi - 1] if gi else UNDEF
                right = addrs[gi + 1] if gi + 1 < len(groups) else UNDEF
                body = b"TREE\x01" + struct.pack("<BHQQ", depth, len(grp), left, right)
                for off, child, size in grp:
                    body += key(size if depth == 0 else 0, off) + struct.pack("<Q", child)
                nxt = groups[gi + 1][0][0] if gi + 1 < len(groups) else None
                body += key(0, nxt) if nxt is not None else end_key
                self.buf[addrs[gi]:addrs[gi] + len(body)] = body
                upper.append((grp[0][0], addrs[gi], 0))
            if len(upper) == 1:
                return upper[0][1]
            level, depth = upper, depth + 1

    def finish(self, root: Group) -> bytes:
        header, tree, heap = self.group(root)
        sb = SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
        sb += struct.pack("<HHI", self.leaf_k, 16, 0)
        sb += struct.pack("<QQQQ", 0, UNDEF, len(self.buf), UNDEF)
        sb += struct.pack("<QQI4xQQ", 0, header, 1, tree, heap)
        self.buf[:96] = sb
        return bytes(self.buf)


def encode(root: Group) -> bytes:
    """The bytes of an HDF5 file holding ``root``'s tree."""
    return _Writer(root).finish(root)


def write(path, root: Group) -> None:
    """Write ``root``'s tree to ``path`` through a temporary file and
    ``os.replace``, so a failure leaves the old file as it was."""
    path = Path(path)
    data = encode(root)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    try:
        tmp.write_bytes(data)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
