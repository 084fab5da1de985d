"""HDF5 without ``h5py``: the files h5py writes, read with numpy,
``zlib`` and the port's host library, and a subset of them written.

The JAX package reads Imaris ``.ims`` files and writes and reads
``DatasetWriter``/``DatasetReader`` files and ``export --illumstats``
through ``h5py``, which the port's target machine does not have.  This
module reads what such files hold, with every ``libver`` h5py takes
(``earliest``, ``v108``, ``v110``, ``latest``) and ``track_order``:

- superblock versions 0 and 1 (after a user block of 0, 512, 1024, ...
  bytes), and 2 and 3 with their lookup3 checksums verified and their
  superblock extension (B-tree ranks; file-space messages ignored);
- object headers of version 1 (with continuation blocks) and version 2
  (``OHDR``/``OCHK``, times, attribute phase changes, creation order);
- groups as symbol tables (version-1 B-trees of type 0, ``SNOD``, local
  heaps) and as links: link info, group info and link messages,
  compact or dense (fractal heaps of managed, tiny and huge objects,
  version-2 B-trees of types 5 and 6); hard links, soft links resolved
  as HDF5 resolves them (absolute, or from the link's group; 16 at
  most), in name order, or creation order where it is indexed;
- attribute messages 1-3, compact or dense (attribute info, v2 B-trees
  of types 8 and 9), with committed (shared) datatypes;
- scalar and simple dataspaces, with unlimited maximum dimensions;
- fixed-point and floating-point types of either byte order,
  fixed-length strings, enums (h5py's ``FALSE``/``TRUE`` enum as
  ``bool``, any other as its base integer), compounds (numpy structured
  arrays with h5py's names and offsets; h5py's ``r``/``i`` pair as
  ``complex64``/``complex128``), arrays inside compounds, and
  variable-length strings through the global heap (attributes as
  ``str``, datasets as object arrays of ``bytes``, as h5py returns them);
- layout version 3 (compact, contiguous, chunked with the type-1 B-tree
  index) and version 4 with all five chunk indexes of HDF5 1.10+: single
  chunk (filtered or not), implicit, fixed array (paged or not),
  extensible array and v2 B-tree (types 10 and 11), and the "don't
  filter partial edge chunks" flag; partial edge chunks and unallocated
  chunks read as the fill value;
- virtual datasets whose sources are in the same file (``.``) or in
  files beside it (a relative name is taken from the virtual dataset's
  directory), mapped by ``all`` and hyperslab selections (regular or
  block lists); a missing source file or dataset reads as the fill value;
- the deflate (1), shuffle (2), fletcher32 (3, verified) and LZF (32000,
  h5py's; a chunk h5py stored unfiltered by its filter mask) filters.

Anything else raises :class:`~tmlibrary_tpu_torch.errors.NotSupportedError`
naming the structure: external links and user-defined links, the szip,
nbit and scale-offset filters, reference, opaque, bitfield and time
types, variable-length sequences, variable-length strings inside
compounds, shared object header messages (a superblock extension's
message table), filtered fractal heaps, point selections and unlimited
or printf-named mappings of virtual datasets, offsets or lengths of other
than 8 bytes.  A damaged file raises
:class:`~tmlibrary_tpu_torch.errors.MetadataError`.  Every read is bounded
by the file and by its stored end-of-file address.

:func:`write` writes a tree of :class:`Group`, :class:`Dataset`,
:class:`Datatype` and :class:`SoftLink` in the old format wherever the
old format holds it -- superblock 0, symbol-table groups, contiguous
datasets, chunked ones (B-trees split at the default rank of 32) with the
deflate, shuffle, fletcher32 and LZF filters, the types above (bool,
complex, structured and variable-length string datasets as h5py writes
them), virtual datasets with their mappings, committed datatypes (an
object header of their own, datasets pointing at it through a shared
datatype message), and fixed-length and variable-length string and
numeric attributes.  An object that keeps its creation order (h5py's
``track_order``) or holds an attribute no version-1 header message can
hold (over 65,528 bytes) gets a version-2 object header instead, as HDF5
gives it one: a group's links as link messages, and past 8 attributes or
links, or with such an attribute, dense storage -- a fractal heap laid
out with HDF5's parameters (checksummed direct blocks in the doubling
table's order under indirect blocks, an object over 4 KiB as a huge
object) and version-2 B-trees of the names and creation orders in
512-byte nodes, of any size.  h5py reads every such file back, and goes
on writing it in "a" mode.  :func:`load` reads a
whole file into such a tree, so a file can be changed and written again
(:class:`tmlibrary_tpu_torch.writers.DatasetWriter`); external links are
refused by name.
"""

from __future__ import annotations

import bisect
import math
import mmap
import os
import struct
import zlib
from pathlib import Path

import numpy as np

from tmlibrary_tpu_torch.errors import MetadataError, NotSupportedError
from tmlibrary_tpu_torch.io import hdf5_v2

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
#: a dataset declaring more bytes than this is taken for a damaged one
MAX_BYTES = 1 << 36
#: rank of the chunk B-tree of a version-0 superblock (HDF5's default)
CHUNK_K = 32
#: h5py's LZF filter id and its ``cd_values`` head (filter version 4,
#: liblzf 1.5)
LZF = 32000
_LZF_CD = (4, 0x0105)
#: soft links followed in one lookup (HDF5's ``H5L_NUM_LINKS``)
MAX_SOFT = 16
_CORRUPT = (struct.error, IndexError, ValueError, OverflowError, zlib.error, UnicodeDecodeError,
            KeyError, TypeError, RecursionError)


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# --------------------------------------------------------------- the tree
class Dataset:
    """A dataset: its array (read lazily from a file, or given), its
    chunk shape (None when contiguous), ``maxshape`` (None entries
    unlimited), filters as ``[(id, client_data)]``, fill value bytes
    (None when not defined) and attributes.  ``h5type`` keeps the
    datatype message of a dataset read from a file (so an enum or a
    variable-length string type is written back as it was) and
    ``virtual`` the mappings of a virtual dataset, ``committed`` the
    :class:`Datatype` it uses (h5py's ``dtype=f["t"]``), ``track_order``
    whether its attributes keep their creation order."""

    def __init__(self, data=None, *, shape=None, dtype=None, chunks=None, maxshape=None,
                 filters=(), fillvalue=None, attrs=None, _reader=None, h5type=None,
                 virtual=None, committed=None, track_order=False):
        self._data = None if data is None else np.asarray(data)
        self._reader = _reader
        self.shape = tuple(self._data.shape) if shape is None else tuple(shape)
        self.dtype = self._data.dtype if dtype is None else np.dtype(dtype)
        self.chunks = None if chunks is None else tuple(int(c) for c in chunks)
        self.maxshape = self.shape if maxshape is None else tuple(maxshape)
        self.filters = [(int(f), tuple(int(v) for v in cd)) for f, cd in filters]
        self.fillvalue = fillvalue
        self.attrs = dict(attrs or {})
        self.h5type = h5type
        self.virtual = virtual
        #: the :class:`Datatype` whose committed type the dataset uses
        self.committed = committed
        #: attributes kept in creation order (h5py's ``track_order``)
        self.track_order = track_order
        self._type_addr: "int | None" = None
        #: how a dataset read from a file is stored: 'compact',
        #: 'contiguous', 'virtual', or its chunk index ('btree1', 'single',
        #: 'implicit', 'fixed_array', 'extensible_array', 'btree2')
        self.storage: "str | None" = None

    @property
    def compression(self) -> "str | None":
        """h5py's name of the compression filter: ``'gzip'`` (deflate)
        or ``'lzf'``."""
        ids = {f for f, _ in self.filters}
        return "gzip" if 1 in ids else "lzf" if LZF in ids else None

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


class SoftLink:
    """A soft link: the path it names (absolute, or from its group)."""

    def __init__(self, path: str):
        self.path = path


class Datatype:
    """A committed (named) datatype: its datatype message and attributes;
    datasets that use it name it in their ``committed``."""

    def __init__(self, raw: bytes, attrs=None, track_order: bool = False):
        self.raw = bytes(raw)
        self.attrs = dict(attrs or {})
        self.track_order = track_order


class Group:
    """A group: named children (groups, datasets, committed datatypes,
    soft links) and attributes; with ``track_order`` (h5py's) children
    and attributes keep their creation order, the order of the dicts."""

    def __init__(self, attrs=None, track_order: bool = False):
        self.children: "dict[str, Group | Dataset | Datatype | SoftLink]" = {}
        self.attrs = dict(attrs or {})
        self.track_order = track_order

    def get(self, path: str, follow: bool = False):
        """The node at a ``/``-separated path, or None; with ``follow``
        soft links are followed as HDF5 follows them (from this group
        as the root)."""
        parts = [p for p in path.split("/") if p]
        node, trail, hops = self, [], 0
        while parts:
            part = parts.pop(0)
            if not isinstance(node, Group):
                return None
            trail.append(node)
            node = node.children.get(part)
            if node is None:
                return None
            if isinstance(node, SoftLink) and (follow or parts):
                hops += 1
                if hops > MAX_SOFT:
                    return None
                target = [p for p in node.path.split("/") if p]
                if node.path.startswith("/"):
                    node, trail = self, []
                else:
                    node = trail.pop()
                parts = target + parts
        return node

    def __getitem__(self, path: str):
        node = self.get(path)
        if node is None:
            raise KeyError(path)
        return node

    def __contains__(self, path: str) -> bool:
        return self.get(path, follow=True) is not None

    def require_group(self, path: str) -> "Group":
        """The group at ``path`` (soft links followed), made where
        missing."""
        node = self
        parts = [p for p in path.split("/") if p]
        for i, part in enumerate(parts):
            child = node.children.get(part)
            if isinstance(child, SoftLink):
                child = self.get("/".join(parts[:i + 1]), follow=True)
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
        parent = self.get("/".join(parts[:-1]), follow=True)
        if isinstance(parent, Group):
            parent.children.pop(parts[-1], None)


# ---------------------------------------------------------------- reading
class _Datatype:
    """A parsed datatype message: numpy dtype, ``vlen`` for a
    variable-length string (``dtype`` then the element's heap id),
    ``post`` a conversion of the stored array (h5py's bool of a wider
    enum), ``raw`` the message's bytes."""

    def __init__(self, dtype, vlen=False, encoding="ascii", raw=b"", post=None):
        self.dtype = np.dtype(dtype)
        self.vlen = vlen
        self.encoding = encoding
        self.raw = raw
        self.post = post


_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 7: "reference"}


def _group_kinds(kinds: set) -> bool:
    """Whether an object header's message types make it a group: a
    symbol table, link info, link or group info message."""
    return bool(kinds & {0x11, 0x02, 0x06, 0x0A})


class File:
    """An HDF5 file, mapped and parsed lazily."""

    def __init__(self, path):
        self.name = str(path)
        self.path = Path(path)
        try:
            with open(path, "rb") as f:  # mapped: a reader holds no copy of the file
                size = os.fstat(f.fileno()).st_size
                self.data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) if size else b""
        except OSError as exc:
            raise MetadataError(f"cannot read {path}: {exc}") from exc
        self._heaps: dict = {}
        self._links_cache: dict = {}
        self._sources: dict = {}
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

    @staticmethod
    def _lookup3(data: bytes) -> int:
        from tmlibrary_tpu_torch import native

        return native.lookup3(data)

    def _checked(self, addr: int, n: int, what: str, sig: "bytes | None" = None,
                 byte5: "int | None" = None) -> bytes:
        """``n`` bytes at ``addr`` whose last 4 are the lookup3 checksum of
        the rest, with their signature, version 0 and (``byte5``) their
        client or type byte checked."""
        block = self._bytes(addr, n)
        if sig is not None and (block[:4] != sig or block[4] != 0):
            raise MetadataError(f"{self.name}: bad HDF5 {what} at {addr}")
        if byte5 is not None and block[5] != byte5:
            raise MetadataError(f"{self.name}: HDF5 {what} at {addr} of type {block[5]} where "
                                f"{byte5} belongs")
        if self._lookup3(block[:n - 4]) != struct.unpack_from("<I", block, n - 4)[0]:
            raise MetadataError(f"{self.name}: bad checksum of the HDF5 {what} at {addr}")
        return block

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
        self.version = version
        if version > 3:
            raise MetadataError(f"{self.name}: bad HDF5 superblock version {version}")
        if version in (2, 3):
            self._superblock_v2(at)
            return
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

    def _superblock_v2(self, at: int) -> None:
        """Superblock version 2 or 3 (``libver`` 'v108' and later): sizes,
        base, extension, end of file and root, under a lookup3 checksum."""
        d = self.data
        if at + 48 > len(d):
            raise MetadataError(f"truncated HDF5 file {self.name}: no whole superblock")
        if self._lookup3(d[at:at + 44]) != struct.unpack_from("<I", d, at + 44)[0]:
            raise MetadataError(f"{self.name}: bad checksum of the HDF5 superblock")
        if d[at + 9] != 8 or d[at + 10] != 8:
            raise NotSupportedError(f"{self.name}: HDF5 offsets/lengths of {d[at + 9]}/"
                                    f"{d[at + 10]} bytes (the port reads 8/8)")
        base, ext, eof, self.root_addr = struct.unpack_from("<QQQQ", d, at + 12)
        if base != at and base != 0:
            raise MetadataError(f"{self.name}: bad HDF5 base address {base}")
        self.base = base
        if len(d) - base < eof:
            raise MetadataError(f"truncated HDF5 file {self.name}: {len(d) - base} bytes, "
                                f"stored end of file {eof}")
        self.eoa = eof
        self.leaf_k, self.node_k, self.chunk_k = 4, 16, CHUNK_K  # HDF5's defaults
        if ext == UNDEF:
            return
        for mtype, _flags, body in self._messages(ext):
            if mtype == 0x0F:
                raise NotSupportedError(f"{self.name}: HDF5 shared object header messages "
                                        "are not read by the port")
            if mtype == 0x14:
                raise MetadataError(f"{self.name}: an HDF5 driver information message")
            if mtype == 0x13:  # B-tree 'K' values
                if body[0] != 0:
                    raise MetadataError(f"{self.name}: bad HDF5 B-tree 'K' message")
                self.chunk_k, self.node_k, self.leaf_k = struct.unpack_from("<HHH", body, 1)
                if 0 in (self.chunk_k, self.node_k, self.leaf_k):
                    raise MetadataError(f"{self.name}: bad HDF5 B-tree ranks")

    # -- object headers
    def _messages(self, addr: int, corders: "list | None" = None) -> list:
        """The messages ``(type, flags, body)`` of the object header at
        ``addr``; ``corders`` gets each one's creation order (0 where the
        header keeps none)."""
        if self._bytes(addr, 4) == b"OHDR":
            return self._messages_v2(addr, corders)
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
        if corders is not None:
            corders.extend([0] * len(out))
        return out

    def _messages_v2(self, addr: int, corders: "list | None" = None) -> list:
        """The messages of a version-2 object header (``OHDR``) and its
        continuation blocks (``OCHK``), each checksummed."""
        head = self._bytes(addr, 6)
        if head[4] != 2:
            raise MetadataError(f"{self.name}: bad HDF5 object header version {head[4]}")
        flags = head[5]
        if flags & 0xC0:
            raise MetadataError(f"{self.name}: bad HDF5 object header flags {flags:#x}")
        p = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        size = self._u(addr + p, width)
        p += width
        corder = 2 if flags & 0x04 else 0
        blocks = [(addr, p, p + size + 4)]  # (address, first message, length with checksum)
        seen, out = set(), []
        while blocks:
            start, first, length = blocks.pop(0)
            if start in seen or len(seen) > 4096:
                raise MetadataError(f"{self.name}: cyclic HDF5 object header continuation")
            seen.add(start)
            block = self._checked(start, length, "object header")
            if first == 4 and block[:4] != b"OCHK":
                raise MetadataError(f"{self.name}: bad HDF5 object header continuation at "
                                    f"{start}")
            q, end = first, length - 4
            while q + 4 + corder <= end:
                mtype, msize, mflags = struct.unpack_from("<BHB", block, q)
                order = struct.unpack_from("<H", block, q + 4)[0] if corder else 0
                q += 4 + corder
                if q + msize > end:
                    raise MetadataError(f"{self.name}: corrupt HDF5 object header")
                body = block[q:q + msize]
                q += msize
                self._check_flags(mtype, mflags)
                if mtype == 0x10:
                    caddr, clen = struct.unpack_from("<QQ", body, 0)
                    blocks.append((caddr, 4, clen))
                elif mtype:
                    out.append((mtype, mflags, body))
                    if corders is not None:
                        corders.append(order)
        return out

    #: message types HDF5 can share (dataspace, datatype, fill value,
    #: filter pipeline, attribute)
    _SHAREABLE = {0x01, 0x03, 0x05, 0x0B, 0x0C}

    def _check_flags(self, mtype: int, flags: int) -> None:
        """The flag checks HDF5 makes on every message of a header; a
        shared message other than a committed datatype is outside what
        the port reads (h5py writes none without a message table)."""
        was_unknown, fail_write, fail_always, shareable = 0x20, 0x08, 0x80, 0x40
        if flags & was_unknown and flags & (fail_write | fail_always):
            raise MetadataError(f"{self.name}: bad HDF5 message flag combination {flags:#x}")
        if flags & shareable and mtype <= 0x18 and mtype not in self._SHAREABLE:
            raise MetadataError(f"{self.name}: HDF5 message {mtype:#x} flagged shareable")
        if mtype > 0x18 and flags & fail_always:
            raise MetadataError(f"{self.name}: unknown HDF5 message {mtype:#x} that must be "
                                "understood")
        if flags & 0x02 and mtype in self._SHAREABLE and mtype != 0x03:
            raise MetadataError(f"{self.name}: shared HDF5 message {mtype:#x}")

    def _shared_type(self, b: bytes) -> bytes:
        """The datatype message a shared-message record points to (a
        committed datatype's object header)."""
        addr = self._shared_addr(b)
        types = [body for t, _, body in self._messages(addr) if t == 0x03]
        if not types:
            raise MetadataError(f"{self.name}: HDF5 committed datatype at {addr} without a "
                                "datatype")
        return types[0]

    def _shared_addr(self, b: bytes) -> int:
        """The object header a shared-message record points to."""
        version, kind = b[0], b[1]
        if version == 1:
            addr = struct.unpack_from("<Q", b, 8)[0]
        elif version == 2 or (version == 3 and kind == 2):
            addr = struct.unpack_from("<Q", b, 2)[0]
        elif version == 3 and kind == 1:
            raise NotSupportedError(f"{self.name}: HDF5 shared object header messages are "
                                    "not read by the port")
        else:
            raise MetadataError(f"{self.name}: bad HDF5 shared message version {version}")
        return addr

    # -- datatypes and dataspaces
    def _datatype(self, b: bytes, off: int = 0) -> "tuple[_Datatype, int]":
        """The datatype message at ``b[off:]`` and its length."""
        cv = b[off]
        cls, version = cv & 0x0F, cv >> 4
        if version not in (1, 2, 3, 4):  # 4: 3's layout, written under libver 'v112'+
            raise MetadataError(f"{self.name}: bad HDF5 datatype version {version}")
        f0, f1 = b[off + 1], b[off + 2]
        size = struct.unpack_from("<I", b, off + 4)[0]
        order = ">" if f0 & 1 else "<"

        def done(dt, used, **kw):
            return _Datatype(dt, raw=bytes(b[off:off + used]), **kw), used

        if cls == 0:
            bit_off, prec = struct.unpack_from("<HH", b, off + 8)
            if size not in (1, 2, 4, 8) or bit_off != 0 or prec != 8 * size:
                raise MetadataError(f"{self.name}: HDF5 integer of {size} bytes, precision "
                                    f"{prec} at bit {bit_off}")
            return done(f"{order}{'i' if f0 & 8 else 'u'}{size}", 12)
        if cls == 1:
            if f0 & 0x40:
                raise NotSupportedError(f"{self.name}: VAX-order HDF5 floats")
            layout = struct.unpack_from("<HHBBBBI", b, off + 8)
            want = {2: (0, 16, 10, 5, 0, 10, 15), 4: (0, 32, 23, 8, 0, 23, 127),
                    8: (0, 64, 52, 11, 0, 52, 1023)}.get(size)
            if want is None or layout != want or f1 != 8 * size - 1:
                raise MetadataError(f"{self.name}: HDF5 float of {size} bytes with layout "
                                    f"{layout}")
            return done(f"{order}f{size}", 20)
        if cls == 3:
            if size == 0:
                raise MetadataError(f"{self.name}: HDF5 string of 0 bytes")
            return done(f"S{size}", 8)
        if cls == 9:
            if f0 & 0x0F != 1:
                raise NotSupportedError(f"{self.name}: HDF5 variable-length sequences")
            _base, used = self._datatype(b, off + 8)
            return done("V16", 8 + used, vlen=True,
                        encoding="utf-8" if f1 & 0x0F == 1 else "ascii")
        if cls == 8:
            return self._enum(b, off, version, f0 | (f1 << 8), size)
        if cls == 6:
            return self._compound(b, off, version, f0 | (f1 << 8), size)
        if cls == 10:
            if version == 1:
                raise MetadataError(f"{self.name}: bad HDF5 array datatype version 1")
            ndims = b[off + 8]
            p = off + 9 + (3 if version == 2 else 0)
            dims = struct.unpack_from(f"<{ndims}I", b, p)
            p += 4 * ndims * (2 if version == 2 else 1)
            base, used = self._datatype(b, p)
            if base.vlen or base.post is not None:
                raise NotSupportedError(f"{self.name}: HDF5 arrays of variable-length or "
                                        "wide boolean types")
            if base.dtype.itemsize * math.prod(dims) != size:
                raise MetadataError(f"{self.name}: HDF5 array of {size} bytes")
            return done(np.dtype((base.dtype, tuple(int(x) for x in dims))), p - off + used)
        if cls in _CLASS_NAMES:
            raise NotSupportedError(f"{self.name}: HDF5 {_CLASS_NAMES[cls]} datatypes are not "
                                    "read by the port")
        raise MetadataError(f"{self.name}: bad HDF5 datatype class {cls}")

    def _names(self, b: bytes, p: int, version: int) -> "tuple[str, int]":
        end = b.index(b"\0", p)
        name = bytes(b[p:end]).decode("utf-8")
        return name, (p + _pad8(end + 1 - p) if version < 3 else end + 1)

    def _enum(self, b, off, version, n, size):
        """h5py's reading of an enum: ``bool`` for the FALSE/TRUE pair,
        else the base integer."""
        base, used = self._datatype(b, off + 8)
        if base.dtype.kind not in "iu" or base.dtype.itemsize != size:
            raise MetadataError(f"{self.name}: HDF5 enum over {base.dtype}")
        p = off + 8 + used
        names = []
        for _ in range(n):
            name, p = self._names(b, p, version)
            names.append(name)
        values = np.frombuffer(bytes(b[p:p + n * size]), base.dtype, count=n)
        p += n * size
        raw = bytes(b[off:p])
        if dict(zip(names, values.tolist())) == {"FALSE": 0, "TRUE": 1}:
            if size == 1:
                return _Datatype(np.bool_, raw=raw), p - off
            return _Datatype(base.dtype, raw=raw, post=lambda a: a != 0), p - off
        return _Datatype(base.dtype, raw=raw), p - off

    def _compound(self, b, off, version, n, size):
        """A compound as h5py reads it: a structured dtype with the
        members' names and offsets, or complex for the ``r``/``i`` pair."""
        p = off + 8
        names, formats, offsets = [], [], []
        for _ in range(n):
            name, p = self._names(b, p, version)
            if version >= 3:
                width = hdf5_v2.limit_enc_size(size)
                moff = int.from_bytes(b[p:p + width], "little")
                p += width
                dims = ()
            else:
                moff = struct.unpack_from("<I", b, p)[0]
                p += 4
                dims = ()
                if version == 1:
                    ndims = b[p]
                    dims = struct.unpack_from(f"<{ndims}I", b, p + 12) if ndims else ()
                    p += 28
            mtype, used = self._datatype(b, p)
            p += used
            if mtype.vlen or mtype.post is not None:
                raise NotSupportedError(f"{self.name}: HDF5 compounds holding variable-length "
                                        "strings or wide boolean enums are not read by the "
                                        "port")
            names.append(name)
            formats.append(np.dtype((mtype.dtype, tuple(dims))) if dims else mtype.dtype)
            offsets.append(moff)
        raw = bytes(b[off:p])
        if (names == ["r", "i"] and formats[0] == formats[1] and formats[0].kind == "f"
                and formats[0].itemsize in (4, 8) and offsets == [0, formats[0].itemsize]
                and size == 2 * formats[0].itemsize):
            bo = formats[0].byteorder if formats[0].byteorder in "<>" else "="
            return _Datatype(np.dtype(f"{bo}c{size}"), raw=raw), p - off
        if any(o + f.itemsize > size for o, f in zip(offsets, formats)):
            raise MetadataError(f"{self.name}: HDF5 compound member past its {size} bytes")
        dt = np.dtype({"names": names, "formats": formats, "offsets": offsets,
                       "itemsize": size})
        return _Datatype(dt, raw=raw), p - off

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

    def _fractal_heap(self, addr: int) -> hdf5_v2.FractalHeap:
        heap = self._heaps.get(("fractal", addr))
        if heap is None:
            heap = self._heaps[("fractal", addr)] = hdf5_v2.FractalHeap(self, addr)
        return heap

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

    def _stab(self, addr: int) -> "tuple[int, tuple[int, int]] | None":
        """(B-tree address, local heap) of the symbol-table group at
        ``addr``; None for a group of links."""
        msgs = self._messages(addr)
        stab = [b for t, _, b in msgs if t == 0x11]
        if not stab:
            if _group_kinds({t for t, _, _ in msgs}):
                return None
            raise MetadataError(f"{self.name}: HDF5 object at {addr} is not a group")
        btree, heap = struct.unpack_from("<QQ", stab[0], 0)
        return btree, self._local_heap(heap)

    def _snod(self, addr: int) -> "list[tuple[int, int, int, int]]":
        """(name offset, object address, cache type, scratch word) of a
        symbol-table node's entries, each checked as HDF5 decodes it."""
        head = self._bytes(addr, 8 + 2 * self.leaf_k * 40)  # HDF5 loads the whole node
        if head[:4] != b"SNOD" or head[4] != 1:
            raise MetadataError(f"{self.name}: bad HDF5 symbol table node at {addr}")
        n = struct.unpack_from("<H", head, 6)[0]
        if n > 2 * self.leaf_k:
            raise MetadataError(f"{self.name}: HDF5 symbol table node with {n} entries")
        entries = self._bytes(addr + 8, 40 * n)
        out = []
        for i in range(n):
            name_off, obj, cache, scratch = struct.unpack_from("<QQI4xI", entries, 40 * i)
            if cache > 2:
                raise MetadataError(f"{self.name}: unknown HDF5 symbol table entry cache "
                                    f"type {cache}")
            out.append((name_off, obj, cache, scratch))
        return out

    def _entry_link(self, heap, entry) -> tuple:
        """A symbol-table entry as a link: hard, or soft (cache type 2,
        the value in the group's local heap)."""
        _name, obj, cache, scratch = entry
        if cache == 2:
            return ("soft", self._heap_bytes(heap, scratch).decode("utf-8"))
        return ("hard", obj)

    def _links(self, addr: int) -> "dict[str, tuple]":
        """Every link of the group at ``addr`` in h5py's iteration order
        (name order; creation order where the group indexes it):
        name -> ``("hard", address)``, ``("soft", path)`` or
        ``("external", (file, path))``."""
        cached = self._links_cache.get(addr)
        if cached is not None:
            return cached
        stab = self._stab(addr)
        links: dict = {}
        if stab is not None:
            btree, heap = stab
            for _key, snod, _next in self._btree(btree, 0):
                for entry in self._snod(snod):
                    links[self._heap_bytes(heap, entry[0]).decode("utf-8")] = \
                        self._entry_link(heap, entry)
        else:
            found, by_order = [], False
            for t, _, b in self._messages(addr):
                if t == 0x06:
                    found.append(self._link(b))
                elif t == 0x02:
                    by_order, heap, names = self._link_info(b)
                    if heap != UNDEF and names != UNDEF:
                        fh = self._fractal_heap(heap)
                        for rec in hdf5_v2.BTree2(self, names, 5).records():
                            found.append(self._link(fh.get(rec[4:4 + fh.id_len])))
            found.sort(key=(lambda x: x[1]) if by_order else (lambda x: x[0].encode("utf-8")))
            for name, _corder, link in found:
                if name in links:
                    raise MetadataError(f"{self.name}: two HDF5 links named {name!r}")
                links[name] = link
        self._links_cache[addr] = links
        return links

    def _link_info(self, b: bytes) -> "tuple[bool, int, int]":
        """(creation order indexed, fractal heap, name B-tree) of a link
        info message."""
        if b[0] != 0:
            raise MetadataError(f"{self.name}: bad HDF5 link info version {b[0]}")
        flags = b[1]
        p = 2 + (8 if flags & 1 else 0)
        heap, names = struct.unpack_from("<QQ", b, p)
        return bool(flags & 2), heap, names

    def _link(self, b: bytes) -> "tuple[str, int, tuple]":
        """(name, creation order, link) of an encoded link message."""
        if b[0] != 1:
            raise MetadataError(f"{self.name}: bad HDF5 link message version {b[0]}")
        flags, p = b[1], 2
        kind = 0
        if flags & 0x08:
            kind = b[p]
            p += 1
        corder = 0
        if flags & 0x04:
            corder = struct.unpack_from("<q", b, p)[0]
            p += 8
        if flags & 0x10:
            p += 1
        width = 1 << (flags & 3)
        n = int.from_bytes(b[p:p + width], "little")
        p += width
        if n == 0 or p + n > len(b):
            raise MetadataError(f"{self.name}: bad HDF5 link name")
        name = bytes(b[p:p + n]).decode("utf-8")
        p += n
        if kind == 0:
            return name, corder, ("hard", struct.unpack_from("<Q", b, p)[0])
        if kind in (1, 64):
            (length,) = struct.unpack_from("<H", b, p)
            value = bytes(b[p + 2:p + 2 + length])
            if kind == 1:
                return name, corder, ("soft", value.decode("utf-8"))
            parts = value[1:].split(b"\0")
            return name, corder, ("external", (parts[0].decode("utf-8", "replace"),
                                               parts[1].decode("utf-8", "replace")))
        raise NotSupportedError(f"{self.name}: HDF5 user-defined links (type {kind}) are not "
                                "read by the port")

    def _lookup(self, addr: int, name: str) -> "tuple | None":
        """One link by name as HDF5 finds it: in a symbol-table group a
        binary search down the B-tree by its keys' names, then through
        the symbol-table node; else among the group's links."""
        stab = self._stab(addr)
        if stab is None:
            return self._links(addr).get(name)
        btree, heap = stab
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
        return None if cmp else self._entry_link(heap, entries[idx])

    def _resolve(self, start: int, path: str, hops: int = 0) -> "int | None":
        addr = self.root_addr if path.startswith("/") else start
        for part in [p for p in path.split("/") if p and p != "."]:
            link = self._lookup(addr, part)
            if link is None:
                return None
            if link[0] == "soft":
                if hops >= MAX_SOFT:
                    return None
                link = ("hard", self._resolve(addr, link[1], hops + 1))
                if link[1] is None:
                    return None
            elif link[0] == "external":
                raise NotSupportedError(f"{self.name}: HDF5 external links ({part!r} to "
                                        f"{link[1][0]}:{link[1][1]}) are not read by the port")
            addr = link[1]
        return addr

    def resolve(self, path: str) -> "int | None":
        """The object header address at ``path`` (soft links followed),
        or None."""
        try:
            return self._resolve(self.root_addr, "/" + path)
        except _CORRUPT as exc:
            raise MetadataError(f"corrupt HDF5 file {self.name}: {type(exc).__name__}: {exc}") \
                from exc

    def exists(self, path: str) -> bool:
        """Whether a link names ``path`` (h5py's ``path in file``: the
        groups on the way must exist, the last link may dangle)."""
        parts = [p for p in path.split("/") if p and p != "."]
        if not parts:
            return True
        try:
            parent = self._resolve(self.root_addr, "/" + "/".join(parts[:-1]))
            return parent is not None and \
                _group_kinds({t for t, _, _ in self._messages(parent)}) and \
                self._lookup(parent, parts[-1]) is not None
        except _CORRUPT as exc:
            raise MetadataError(f"corrupt HDF5 file {self.name}: {type(exc).__name__}: {exc}") \
                from exc

    def members(self, path: str) -> "list[str]":
        """The names in the group at ``path`` (KeyError when absent), in
        h5py's iteration order."""
        addr = self.resolve(path)
        if addr is None:
            raise KeyError(path)
        try:
            return list(self._links(addr))
        except _CORRUPT as exc:
            raise MetadataError(f"corrupt HDF5 file {self.name}: {type(exc).__name__}: {exc}") \
                from exc

    def datasets(self, path: str = "/") -> "list[str]":
        """The dataset paths below the group at ``path``, relative to it,
        in h5py's ``visititems`` order: depth first, names in byte order,
        hard links only, each object once; no data is read."""
        addr = self.resolve(path)
        if addr is None:
            raise KeyError(path)
        out: list = []
        seen = {addr}
        try:
            self._visit(addr, "", seen, out)
        except _CORRUPT as exc:
            raise MetadataError(f"corrupt HDF5 file {self.name}: {type(exc).__name__}: {exc}") \
                from exc
        return out

    def _visit(self, addr: int, prefix: str, seen: set, out: list) -> None:
        links = self._links(addr)
        for name in sorted(links, key=lambda s: s.encode("utf-8")):
            kind, child = links[name]
            if kind != "hard" or child in seen:
                continue
            seen.add(child)
            kinds = {t for t, _, _ in self._messages(child)}
            if _group_kinds(kinds):
                self._visit(child, f"{prefix}{name}/", seen, out)
            elif 0x08 in kinds:
                out.append(f"{prefix}{name}")

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
            corders: list = []
            msgs = self._messages(addr, corders)
            # creation order kept: a version-2 header's attribute flag, or
            # a link info message's
            track = self._bytes(addr, 4) == b"OHDR" and bool(self._u(addr + 5, 1) & 0x04)
            track = track or any(t == 0x02 and b[1] & 1 for t, _, b in msgs)
            attrs = self._attributes(msgs, corders, track)
            kinds = {t for t, _, _ in msgs}
            if _group_kinds(kinds):
                return Group(attrs, track_order=track)
            if 0x03 in kinds and not kinds & {0x01, 0x08}:
                return Datatype(next(b for t, _, b in msgs if t == 0x03), attrs, track)
            ds = self._dataset(msgs, attrs)
            ds.track_order = track
            return ds
        except _CORRUPT as exc:
            raise MetadataError(f"corrupt HDF5 file {self.name}: {type(exc).__name__}: {exc}") \
                from exc

    def _attributes(self, msgs, corders=(), by_order: bool = False) -> dict:
        """The attributes of an object's messages: in creation order where
        the object keeps it, else as stored (dense ones in name order)."""
        found = []
        for i, (t, _flags, b) in enumerate(msgs):
            if t == 0x15:
                found.extend(self._dense_attributes(b))
            elif t == 0x0C:
                found.append((corders[i] if i < len(corders) else 0, *self._attribute(b)))
        if by_order:
            found.sort(key=lambda x: x[0])
        return {name: value for _, name, value in found}

    def _dense_attributes(self, b: bytes) -> list:
        """``(creation order, name, value)`` of the attributes of an
        attribute info message's dense storage, in name order."""
        if b[0] != 0:
            raise MetadataError(f"{self.name}: bad HDF5 attribute info version {b[0]}")
        flags = b[1]
        p = 2 + (2 if flags & 1 else 0)
        heap, names = struct.unpack_from("<QQ", b, p)
        if heap == UNDEF or names == UNDEF:
            return []
        fh = self._fractal_heap(heap)
        out = []
        for rec in hdf5_v2.BTree2(self, names, 8).records():
            if rec[8] & 0x02:
                raise NotSupportedError(f"{self.name}: HDF5 shared object header messages are "
                                        "not read by the port")
            out.append((struct.unpack_from("<I", rec, 9)[0], *self._attribute(fh.get(rec[:8]))))
        return sorted(out, key=lambda kv: kv[1].encode("utf-8"))

    def _attribute(self, b: bytes) -> tuple:
        version = b[0]
        if version == 1:
            nsize, tsize, ssize = struct.unpack_from("<HHH", b, 2)
            p, pad = 8, _pad8
        elif version in (2, 3):
            if b[1] & 2:
                raise NotSupportedError(f"{self.name}: shared HDF5 attribute dataspaces")
            nsize, tsize, ssize = struct.unpack_from("<HHH", b, 2)
            p, pad = (8 if version == 2 else 9), (lambda n: n)
        else:
            raise MetadataError(f"{self.name}: bad HDF5 attribute version {version}")
        name = bytes(b[p:p + nsize]).split(b"\0")[0].decode("utf-8")
        p += pad(nsize)
        traw = b[p:p + tsize]
        if version > 1 and b[1] & 1:
            traw = self._shared_type(traw)
        dtype, _ = self._datatype(traw)
        p += pad(tsize)
        shape, _ = self._dataspace(b[p:p + ssize])
        p += pad(ssize)
        return name, self._values(b[p:], dtype, shape)

    def _values(self, raw: bytes, dtype: _Datatype, shape: tuple):
        n = math.prod(shape)
        if n * dtype.dtype.itemsize > len(raw):
            raise MetadataError(f"{self.name}: HDF5 attribute data shorter than its shape")
        if dtype.vlen:
            vals = [s.decode(dtype.encoding) for s in self._vlen_items(raw, n)]
            if not shape:
                return vals[0]
            return np.array(vals, dtype=object).reshape(shape)
        arr = np.frombuffer(raw, dtype.dtype, count=n).reshape(shape).copy()
        if dtype.post is not None:
            arr = dtype.post(arr)
        return arr[()] if not shape else arr

    def _vlen_items(self, raw: bytes, n: int) -> list:
        """The ``bytes`` of ``n`` variable-length string elements (length,
        global heap collection, object index)."""
        vals = []
        for i in range(n):
            length, heap, index = struct.unpack_from("<IQI", raw, 16 * i)
            obj = self._global_object(heap, index) if length else b""
            if len(obj) < length:
                raise MetadataError(f"{self.name}: short HDF5 variable-length string")
            vals.append(bytes(obj[:length]))
        return vals

    def _dataset(self, msgs, attrs) -> Dataset:
        by = {}
        type_addr = None
        for t, flags, b in msgs:
            if t == 0x03 and flags & 0x02 and t not in by:
                type_addr = self._shared_addr(b)
                b = self._shared_type(b)
            by.setdefault(t, b)
        if 0x01 not in by or 0x03 not in by or 0x08 not in by:
            raise MetadataError(f"{self.name}: HDF5 object without a dataspace, datatype or "
                                "layout")
        shape, maxshape = self._dataspace(by[0x01])
        dtype, _ = self._datatype(by[0x03])
        itemsize = dtype.dtype.itemsize
        nbytes = math.prod(shape) * itemsize
        if nbytes > MAX_BYTES:
            raise MetadataError(f"{self.name}: HDF5 dataset of {nbytes} bytes")
        filters = self._filters(by[0x0B]) if 0x0B in by else []
        fill = self._fill(by, itemsize)
        lay = by[0x08]
        if lay[0] not in (3, 4):
            raise NotSupportedError(f"{self.name}: HDF5 data layout version {lay[0]}")
        cls = lay[1]
        out_dtype = np.dtype(object) if dtype.vlen else \
            np.dtype(bool) if dtype.post is not None else dtype.dtype
        ds = Dataset(shape=shape, dtype=out_dtype, maxshape=maxshape, filters=filters,
                     fillvalue=fill, attrs=attrs, h5type=dtype.raw)
        ds._type_addr = type_addr
        if cls == 0:
            size = struct.unpack_from("<H", lay, 2)[0]
            raw = lay[4:4 + size]
            if size < nbytes or len(raw) < size:
                raise MetadataError(f"{self.name}: HDF5 compact data shorter than its dataset")
            reader = self._flat_reader(lambda: raw[:nbytes], shape, dtype.dtype)
            ds.storage = "compact"
        elif cls == 1:
            ds.storage = "contiguous"
            addr, _size = struct.unpack_from("<QQ", lay, 2)
            if addr == UNDEF:
                reader = self._flat_reader(
                    lambda: self._filled(fill, itemsize, nbytes), shape, dtype.dtype)
            else:
                if addr + nbytes > self.eoa:
                    raise MetadataError(f"{self.name}: HDF5 dataset storage past the end of "
                                        "the file")
                reader = self._flat_reader(lambda: self._bytes(addr, nbytes), shape,
                                           dtype.dtype)
        elif cls == 2:
            reader = self._chunked(lay, ds, dtype.dtype, fill, maxshape)
        elif cls == 3:
            if lay[0] != 4:
                raise MetadataError(f"{self.name}: an HDF5 virtual layout of version {lay[0]}")
            ds.virtual = self._virtual_mappings(*struct.unpack_from("<QI", lay, 2))
            ds.storage = "virtual"
            ds._reader = self._virtual_reader(ds, dtype, fill)
            return ds
        else:
            raise MetadataError(f"{self.name}: bad HDF5 layout class {cls}")
        ds._reader = self._converter(reader, dtype)
        return ds

    def _converter(self, reader, dtype: _Datatype):
        """``reader`` with the stored elements turned into what h5py
        returns (variable-length strings as ``bytes``, a wide boolean
        enum as ``bool``)."""
        if not dtype.vlen and dtype.post is None:
            return reader

        def read(box):
            arr = reader(box)
            if dtype.post is not None:
                return dtype.post(arr)
            try:
                items = self._vlen_items(arr.tobytes(), arr.size)
            except _CORRUPT as exc:
                raise MetadataError(f"corrupt HDF5 file {self.name}: {type(exc).__name__}: "
                                    f"{exc}") from exc
            out = np.empty(arr.size, object)
            out[:] = items
            return out.reshape(arr.shape)

        return read

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
            if fid not in (1, 2, 3, LZF):
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

    # -- chunked layouts
    def _chunked(self, lay: bytes, ds: Dataset, dtype, fill, maxshape):
        """The reader of a chunked layout: version 3 (type-1 B-tree) or
        version 4 (single chunk, implicit, fixed array, extensible array
        or v2 B-tree index)."""
        shape, itemsize = ds.shape, dtype.itemsize
        rank = len(shape)
        edge_raw = False
        if lay[0] == 3:
            nd = lay[2]
            addr = struct.unpack_from("<Q", lay, 3)[0]
            dims = struct.unpack_from(f"<{nd}I", lay, 11)
        else:
            flags, nd, width = lay[2], lay[3], lay[4]
            if flags & ~3 or width not in range(1, 9):
                raise MetadataError(f"{self.name}: bad HDF5 layout-4 flags {flags:#x} or "
                                    f"width {width}")
            dims = tuple(int.from_bytes(lay[5 + width * i:5 + width * (i + 1)], "little")
                         for i in range(nd))
            p = 5 + width * nd
            index = lay[p]
            edge_raw = bool(flags & 1)
        if nd != rank + 1 or dims[-1] != itemsize or 0 in dims:
            raise MetadataError(f"{self.name}: HDF5 chunk dimensions {dims} for shape "
                                f"{shape}")
        chunks = tuple(int(c) for c in dims[:-1])
        ds.chunks = chunks
        chunk_bytes = math.prod(chunks) * itemsize
        ds.storage = "btree1" if lay[0] == 3 else \
            {1: "single", 2: "implicit", 3: "fixed_array", 4: "extensible_array",
             5: "btree2"}.get(index)
        if lay[0] == 3:
            def build():
                out = []
                if addr == UNDEF:
                    return out
                for key, caddr, _next in self._btree(addr, 1, rank):
                    size, mask = struct.unpack_from("<II", key, 0)
                    offs = struct.unpack_from(f"<{rank}Q", key, 8)
                    if any(o % c for o, c in zip(offs, chunks)):
                        raise MetadataError(f"{self.name}: HDF5 chunk offset {offs} off its "
                                            "grid")
                    out.append((offs, caddr, size, mask))
                return out
        else:
            build = self._chunk_index(lay, p, index, chunks, shape, maxshape, ds.filters,
                                      chunk_bytes)
        return self._chunk_reader(build, ds, dtype, fill, edge_raw)

    def _chunk_index(self, lay, p, index, chunks, shape, maxshape, filters, chunk_bytes):
        """A function building ``[(offsets, address, size, mask)]`` from a
        layout-4 chunk index."""
        rank = len(chunks)
        filtered = bool(filters)
        size_len = min(1 + (hdf5_v2.log2_gen(chunk_bytes) + 8) // 8, 8)
        grid = [-(-(m if m is not None else n) // c) for m, n, c in zip(maxshape, shape, chunks)]

        def offsets(scaled):
            return tuple(s * c for s, c in zip(scaled, chunks))

        def by_index(elements, order):
            """Elements by linear chunk index, row-major over the chunk
            grid with the axes in ``order`` (slowest first)."""
            out = []
            for idx, (caddr, size, mask) in elements.items():
                scaled = [0] * rank
                for a in reversed(order[1:]):
                    idx, scaled[a] = divmod(idx, grid[a])
                scaled[order[0]] = idx
                out.append((offsets(scaled), caddr, chunk_bytes if size is None else size,
                            mask))
            return out

        if index == 1:  # single chunk
            single_size, mask = chunk_bytes, 0
            if lay[2] & 2:
                single_size, mask = struct.unpack_from("<QI", lay, p + 1)
                p += 12
            caddr = struct.unpack_from("<Q", lay, p + 1)[0]
            if tuple(chunks) != tuple(shape if None in maxshape else maxshape) and \
                    tuple(chunks) != tuple(shape):
                raise MetadataError(f"{self.name}: HDF5 single chunk {chunks} for {shape}")
            return lambda: [] if caddr == UNDEF else [((0,) * rank, caddr, single_size, mask)]
        if index == 2:  # implicit: every chunk in place, in order
            caddr = struct.unpack_from("<Q", lay, p + 1)[0]
            if filtered or None in maxshape:
                raise MetadataError(f"{self.name}: an HDF5 implicit chunk index with filters "
                                    "or unlimited axes")

            def implicit():
                if caddr == UNDEF:
                    return []
                n = math.prod(grid)
                self._bytes(caddr, n * chunk_bytes)
                return by_index({i: (caddr + i * chunk_bytes, None, 0) for i in range(n)},
                                list(range(rank)))
            return implicit
        if index == 3:  # fixed array
            caddr = struct.unpack_from("<Q", lay, p + 2)[0]
            if None in maxshape:
                raise MetadataError(f"{self.name}: an HDF5 fixed-array index with unlimited "
                                    "axes")
            return lambda: [] if caddr == UNDEF else by_index(
                hdf5_v2.fixed_array(self, caddr, filtered, size_len), list(range(rank)))
        if index == 4:  # extensible array: the unlimited axis is the slowest
            caddr = struct.unpack_from("<Q", lay, p + 6)[0]
            unlim = [a for a, m in enumerate(maxshape) if m is None]
            if len(unlim) != 1:
                raise MetadataError(f"{self.name}: an HDF5 extensible-array index over "
                                    f"{len(unlim)} unlimited axes")
            order = unlim + [a for a in range(rank) if a != unlim[0]]
            return lambda: [] if caddr == UNDEF else by_index(
                hdf5_v2.extensible_array(self, caddr, filtered, size_len), order)
        if index == 5:  # v2 B-tree of chunk records
            caddr = struct.unpack_from("<Q", lay, p + 7)[0]

            def btree():
                if caddr == UNDEF:
                    return []
                out = []
                for rec in hdf5_v2.BTree2(self, caddr, 11 if filtered else 10).records():
                    a = struct.unpack_from("<Q", rec, 0)[0]
                    if filtered:
                        size = int.from_bytes(rec[8:8 + size_len], "little")
                        mask = struct.unpack_from("<I", rec, 8 + size_len)[0]
                        q = 12 + size_len
                    else:
                        size, mask, q = chunk_bytes, 0, 8
                    scaled = struct.unpack_from(f"<{rank}Q", rec, q)
                    out.append((offsets(scaled), a, size, mask))
                return out
            return btree
        raise MetadataError(f"{self.name}: bad HDF5 chunk index type {index}")

    def _chunk_reader(self, build, ds: Dataset, dtype, fill, edge_raw: bool = False):
        shape, chunks = ds.shape, ds.chunks
        itemsize = dtype.itemsize
        filters = ds.filters

        index: list = []  # (offsets, address, size, filter mask), read once

        def read(box):
            box = [(0, n) for n in shape] if box is None else list(box)
            out_shape = tuple(b - a for a, b in box)
            out = np.frombuffer(self._filled(fill, itemsize, math.prod(out_shape) * itemsize),
                                dtype).reshape(out_shape).copy()
            if 0 in out_shape:
                return out
            try:
                if not index:
                    index[:] = build() or [None]
                for entry in index:
                    if entry is None:
                        continue
                    offs, addr, size, mask = entry
                    if any(o >= n for o, n in zip(offs, shape)):
                        continue
                    lo = [max(a, o) for (a, _), o in zip(box, offs)]
                    hi = [min(b, o + c) for (_, b), o, c in zip(box, offs, chunks)]
                    if any(l >= h for l, h in zip(lo, hi)):
                        continue
                    edge = edge_raw and any(o + c > n for o, c, n in zip(offs, chunks, shape))
                    chunk = self._chunk(addr, size, mask, [] if edge else filters,
                                        math.prod(chunks) * itemsize)
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
            elif fid == LZF:
                from tmlibrary_tpu_torch import native

                try:
                    data = native.lzf_decompress(data, expect)
                except MetadataError as exc:
                    raise MetadataError(f"{self.name}: HDF5 chunk at {addr}: {exc}") from exc
        if len(data) != expect:
            raise MetadataError(f"{self.name}: HDF5 chunk of {len(data)} bytes, expected "
                                f"{expect}")
        return data

    # -- virtual datasets
    def _virtual_mappings(self, heap: int, index: int) -> list:
        """``[(source file, source dataset, source selection bytes,
        virtual selection bytes)]`` of a virtual layout's global heap
        object, its checksum verified."""
        blob = bytes(self._global_object(heap, index))
        if len(blob) < 13 or blob[0] != 0:
            raise NotSupportedError(f"{self.name}: HDF5 virtual-dataset mappings of version "
                                    f"{blob[0] if blob else None}")
        if self._lookup3(blob[:-4]) != struct.unpack_from("<I", blob, len(blob) - 4)[0]:
            raise MetadataError(f"{self.name}: bad checksum of the HDF5 virtual-dataset "
                                "mappings")
        n = struct.unpack_from("<Q", blob, 1)[0]
        p, out = 9, []
        for _ in range(n):
            end = blob.index(b"\0", p)
            src_file = blob[p:end].decode("utf-8")
            p = end + 1
            end = blob.index(b"\0", p)
            src_dset = blob[p:end].decode("utf-8")
            p = end + 1
            sels = []
            for _ in range(2):
                start = p
                _kind, _blocks, p = hdf5_v2.selection(self, blob, p)
                sels.append(blob[start:p])
            if "%" in src_file or "%" in src_dset:
                raise NotSupportedError(f"{self.name}: printf-named HDF5 virtual-dataset "
                                        "sources are not read by the port")
            out.append((src_file, src_dset, sels[0], sels[1]))
        if p != len(blob) - 4:
            raise MetadataError(f"{self.name}: bad HDF5 virtual-dataset mappings")
        return out

    def _source(self, src_file: str, src_dset: str):
        """The source dataset of a mapping, or None when its file or
        dataset is missing (HDF5 then reads the fill value)."""
        key = (src_file, src_dset)
        if key not in self._sources:
            node = None
            if src_file == ".":
                f = self
            else:
                path = Path(src_file)
                path = path if path.is_absolute() else self.path.parent / path
                try:
                    f = File(path) if path.is_file() else None
                except MetadataError:
                    f = None
            if f is not None:
                try:
                    node = f.node(src_dset)
                except KeyError:
                    node = None
                if not isinstance(node, Dataset):
                    node = None
            self._sources[key] = node
        return self._sources[key]

    def _virtual_reader(self, ds: Dataset, dtype: _Datatype, fill):
        """The reader of a virtual dataset: the fill value, then each
        mapping's source selection into its virtual selection, element
        for element in row-major order (what it reads is already as h5py
        returns it)."""
        def read(box):
            try:
                n = math.prod(ds.shape)
                if dtype.vlen:
                    out = np.empty(n, object)
                    out[:] = [b""] * n
                    out = out.reshape(ds.shape)
                else:
                    out = np.frombuffer(self._filled(fill, dtype.dtype.itemsize,
                                                     n * dtype.dtype.itemsize),
                                        dtype.dtype).reshape(ds.shape).copy()
                    if dtype.post is not None:
                        out = dtype.post(out)
                for src_file, src_dset, ssel, vsel in ds.virtual:
                    src = self._source(src_file, src_dset)
                    if src is None:
                        continue
                    if src.dtype != ds.dtype:
                        raise NotSupportedError(f"{self.name}: an HDF5 virtual-dataset source "
                                                f"of {src.dtype} for {ds.dtype} is not read by "
                                                "the port")
                    vmask = hdf5_v2.selection_mask(
                        self, *hdf5_v2.selection(self, vsel, 0)[:2], ds.shape)
                    smask = hdf5_v2.selection_mask(
                        self, *hdf5_v2.selection(self, ssel, 0)[:2], src.shape)
                    if int(smask.sum()) != int(vmask.sum()):
                        raise MetadataError(f"{self.name}: HDF5 virtual mapping of "
                                            f"{int(vmask.sum())} elements from "
                                            f"{int(smask.sum())}")
                    out[vmask] = np.asarray(src.read())[smask]
            except _CORRUPT as exc:
                raise MetadataError(f"corrupt HDF5 file {self.name}: {type(exc).__name__}: "
                                    f"{exc}") from exc
            if box is not None:
                out = out[tuple(slice(a, b) for a, b in box)]
            return out

        return read

    # -- whole-file load
    def load(self, path: str = "/") -> Group:
        """The group at ``path`` with everything below it read into
        memory (datasets as arrays, soft links as :class:`SoftLink`)."""
        addr = self.resolve(path)
        if addr is None:
            raise KeyError(path)
        try:
            return self._load(addr, set(), {})
        except _CORRUPT as exc:
            raise MetadataError(f"corrupt HDF5 file {self.name}: {type(exc).__name__}: {exc}") \
                from exc

    def _load(self, addr: int, seen: set, memo: dict):
        """The object at ``addr``; an object under several hard links is
        loaded once (``memo``), so it is written once."""
        if addr in seen:
            raise MetadataError(f"{self.name}: HDF5 group cycle at {addr}")
        if addr in memo:
            return memo[addr]
        node = memo[addr] = self._object(addr)
        if isinstance(node, Datatype):
            return node
        if isinstance(node, Dataset):
            node._data = node.read()
            node._reader = None
            if node._type_addr is not None:
                node.committed = self._load(node._type_addr, seen, memo)
            return node
        for name, (kind, value) in self._links(addr).items():
            if kind == "hard":
                node.children[name] = self._load(value, seen | {addr}, memo)
            elif kind == "soft":
                node.children[name] = SoftLink(value)
            else:
                raise NotSupportedError(f"{self.name}: HDF5 external links ({name!r} to "
                                        f"{value[0]}:{value[1]}) are not kept by the port")
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


_LITTLE = np.little_endian


def _order(dt: np.dtype) -> int:
    return 1 if dt.byteorder == ">" or (dt.byteorder == "=" and not _LITTLE) else 0


def _dtype_message(dt: np.dtype) -> bytes:
    """The datatype message h5py writes for ``dt``: integers, floats,
    fixed-length byte strings, ``bool`` (an int8 enum of FALSE and TRUE),
    complex (a compound of ``r`` and ``i``), structured dtypes (compounds
    with their names and offsets; subarray fields as arrays)."""
    dt = np.dtype(dt)
    order = _order(dt)
    if dt.kind == "b":
        base = _dtype_message(np.dtype("i1"))
        names = b"".join(n + b"\0" * (_pad8(len(n) + 1) - len(n)) for n in (b"FALSE", b"TRUE"))
        return struct.pack("<BBBBI", 0x18, 2, 0, 0, 1) + base + names + b"\x00\x01"
    if dt.kind in "iu" and dt.itemsize in (1, 2, 4, 8):
        return struct.pack("<BBBBIHH", 0x10, order | (8 if dt.kind == "i" else 0), 0, 0,
                           dt.itemsize, 0, 8 * dt.itemsize)
    if dt.kind == "f" and dt.itemsize in (2, 4, 8):
        layout = {2: (16, 10, 5, 0, 10, 15), 4: (32, 23, 8, 0, 23, 127),
                  8: (64, 52, 11, 0, 52, 1023)}[dt.itemsize]
        return struct.pack("<BBBBIHHBBBBI", 0x11, order | 0x20, 8 * dt.itemsize - 1, 0,
                           dt.itemsize, 0, *layout)
    if dt.kind == "c" and dt.itemsize in (8, 16):
        half = np.dtype(f"{'>' if order else '<'}f{dt.itemsize // 2}")
        return _compound([("r", half, 0), ("i", half, dt.itemsize // 2)], dt.itemsize)
    if dt.kind == "S" and dt.itemsize > 0:
        return struct.pack("<BBBBI", 0x13, 1, 0, 0, dt.itemsize)  # null-padded ASCII
    if dt.kind == "V" and dt.names:
        return _compound([(n, dt.fields[n][0], dt.fields[n][1]) for n in dt.names], dt.itemsize)
    if dt.subdtype is not None:
        base, dims = dt.subdtype
        body = struct.pack("<B3x", len(dims)) + struct.pack(f"<{len(dims)}I", *dims)
        body += struct.pack(f"<{len(dims)}I", *range(len(dims)))
        return struct.pack("<BBBBI", 0x2A, 0, 0, 0, dt.itemsize) + body + _dtype_message(base)
    raise NotSupportedError(f"the port's HDF5 writer takes integers, floats, bool, complex, "
                            f"fixed-length byte strings and structured types, not {dt}")


def _compound(members, size: int) -> bytes:
    """A compound datatype message (version 1, or 2 with array members)."""
    version = 2 if any(np.dtype(t).subdtype is not None for _, t, _ in members) else 1
    body = b""
    for name, mdt, off in members:
        raw = name.encode("utf-8") + b"\0"
        body += raw + b"\0" * (_pad8(len(raw)) - len(raw)) + struct.pack("<I", off)
        if version == 1:
            body += bytes(28)  # dimensionality, permutation and sizes of no array
        body += _dtype_message(mdt)
    n = len(members)
    return struct.pack("<BBBBI", 0x06 | (version << 4), n & 0xFF, n >> 8, 0, size) + body


#: a variable-length UTF-8 string type (h5py's ``str`` attributes)
_VLEN_STR = struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0, 16) + struct.pack("<BBBBI", 0x13, 0, 1, 0, 1)


def _space_message(shape, maxshape=None) -> bytes:
    out = struct.pack("<BBBB4x", 1, len(shape), 1 if maxshape is not None else 0, 0)
    out += struct.pack(f"<{len(shape)}Q", *shape)
    if maxshape is not None:
        out += struct.pack(f"<{len(shape)}Q", *(UNDEF if m is None else m for m in maxshape))
    return out


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = body + b"\0" * (_pad8(len(body)) - len(body))
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _filter_message(filters, chunk_bytes: int) -> bytes:
    """A version-1 filter pipeline: deflate, shuffle and LZF optional,
    fletcher32 mandatory, LZF named with h5py's client data."""
    body = struct.pack("<BB6x", 1, len(filters))
    for fid, cd in filters:
        if fid == LZF:
            cd = (*_LZF_CD, chunk_bytes)
            name = b"lzf\0\0\0\0\0"
        else:
            name = b""
        body += struct.pack("<HHHH", fid, len(name), 0 if fid == 3 else 1, len(cd)) + name
        body += struct.pack(f"<{len(cd)}I", *cd) + (b"\0" * 4 if len(cd) % 2 else b"")
    return body


#: the largest body a version-1 object header message holds (a 16-bit
#: size, 8-byte aligned)
_V1_MESSAGE_MAX = 0xFFF8
#: attributes and links kept in a version-2 header before HDF5 moves them
#: to dense storage (``H5O_CRT_ATTR_MAX_COMPACT_DEF``, ``H5G_CRT_GINFO_MAX_COMPACT``)
_MAX_COMPACT = 8
#: fractal heaps the writer makes, with HDF5's parameters for dense
#: attributes (``H5O_FHEAP_*``) and dense links (``H5G_FHEAP_*``): (heap id
#: length, heap address bits, first direct block size)
_ATTR_HEAP = (8, 40, 1024)
_LINK_HEAP = (7, 32, 512)
#: the same in both: the doubling table's width, its largest direct
#: block, and the largest object kept in a block (a larger one is a
#: huge object); every version-2 B-tree has nodes of 512 bytes
_HEAP_WIDTH = 4
_HEAP_MAX_DIRECT = 1 << 16
_HEAP_MAX_MANAGED = 4096
_BTREE2_NODE = 512


def _link_message(name: str, target, corder: "int | None") -> bytes:
    """A link message (version 1): to an object header address, or a
    :class:`SoftLink`; ``corder`` its creation order where kept."""
    raw = name.encode("utf-8")
    width = 0 if len(raw) < 1 << 8 else 1 if len(raw) < 1 << 16 else 2
    soft = isinstance(target, SoftLink)
    utf8 = not raw.isascii()
    flags = width | (0x04 if corder is not None else 0) | (0x08 if soft else 0) \
        | (0x10 if utf8 else 0)
    body = bytes([1, flags]) + (b"\x01" if soft else b"")
    body += struct.pack("<q", corder) if corder is not None else b""
    body += (b"\x01" if utf8 else b"") + len(raw).to_bytes(1 << width, "little") + raw
    if soft:
        path = target.path.encode("utf-8")
        return body + struct.pack("<H", len(path)) + path
    return body + struct.pack("<Q", target)


class _Writer:
    """The file in memory: objects appended as they are written, the
    superblock filled in last.  Every object is written with a version-1
    header, except one that keeps its creation order (``track_order``) or
    holds an attribute no version-1 message can hold: that one gets a
    version-2 header (``OHDR``), a group then its links as link messages,
    and past 8 attributes or links, or with such an attribute, dense
    storage -- a fractal heap (:meth:`fractal_heap`) and version-2
    B-trees of the names (and of the creation orders)."""

    def __init__(self, root: Group):
        self.buf = bytearray(96)  # the superblock, filled in last
        self.leaf_k = 4
        self._written: dict = {}  # id(node) -> its addresses, one object under many links
        self._refs: dict = {}  # id(node) -> its hard links and users (the reference count)
        self._attrs: dict = {}  # id(node) -> its attribute message bodies
        self._max_members(root)

    def _max_members(self, g: Group) -> None:
        self.leaf_k = max(self.leaf_k, (len(g.children) + 1) // 2)
        for child in g.children.values():
            if isinstance(child, SoftLink):
                continue
            first = id(child) not in self._refs
            self._refs[id(child)] = self._refs.get(id(child), 0) + 1
            if isinstance(child, Group) and first:
                self._max_members(child)
            if isinstance(child, Dataset) and first and child.committed is not None:
                # a dataset of a committed type counts in the type's references
                key = id(child.committed)
                self._refs[key] = self._refs.get(key, 0) + 1

    def alloc(self, data: bytes) -> int:
        at = len(self.buf)
        self.buf += data
        self.buf += b"\0" * (_pad8(len(self.buf)) - len(self.buf))
        return at

    _lookup3 = staticmethod(File._lookup3)

    # -- attributes
    def attribute(self, name: str, value) -> bytes:
        """The body of an attribute message (version 1) for ``value``."""
        nm = name.encode("utf-8") + b"\0"
        if isinstance(value, str) or (isinstance(value, np.ndarray) and value.dtype == object):
            strs = [value] if isinstance(value, str) else [str(v) for v in value.ravel()]
            shape = () if isinstance(value, str) else value.shape
            dtm, raw = _VLEN_STR, self.vlen_strings([s.encode("utf-8") for s in strs])
        else:
            arr = np.asarray(value)
            if arr.dtype.kind == "U":
                arr = np.char.encode(arr, "utf-8")
            dtm, shape, raw = _dtype_message(arr.dtype), arr.shape, arr.tobytes()
        space = _space_message(shape)
        body = struct.pack("<BBHHH", 1, 0, len(nm), len(dtm), len(space))
        for part in (nm, dtm, space):
            body += part + b"\0" * (_pad8(len(part)) - len(part))
        return body + raw

    def vlen_strings(self, objs) -> bytes:
        """The 16-byte elements (length, collection, index) of ``objs``
        stored in global heap collections of at most 65,535 objects."""
        out = b""
        for first in range(0, len(objs), 0xFFFF):
            part = objs[first:first + 0xFFFF]
            body = b""
            for i, o in enumerate(part, 1):
                body += struct.pack("<HH4xQ", i, 1, len(o)) + o + b"\0" * (_pad8(len(o)) - len(o))
            size = max(4096, 16 + len(body) + 16)
            free = size - 16 - len(body)
            block = b"GCOL\x01\0\0\0" + struct.pack("<Q", size) + body + \
                struct.pack("<HH4xQ", 0, 0, free) + b"\0" * (free - 16)
            addr = self.alloc(block)
            out += b"".join(struct.pack("<IQI", len(o), addr, i) for i, o in enumerate(part, 1))
        return out

    # -- object headers
    def header(self, node, msgs: list, links: "list | None" = None) -> int:
        """Write ``node``'s object header from its messages ``[(type, flags,
        body)]``, its attributes and, for a group in a version-2 header,
        its ``links`` ``[(name, address or SoftLink)]``."""
        attrs = self.attributes(node)
        refs = self._refs.get(id(node), 1)
        if links is None and not self._v2(node, attrs):
            body = b"".join(_message(t, b, f) for t, f, b in msgs)
            body += b"".join(_message(0x0C, a) for a in attrs)
            count = len(msgs) + len(attrs)
            if not body:
                body, count = _message(0, b""), 1
            return self.alloc(struct.pack("<BBHII4x", 1, 0, count, refs, len(body)) + body)
        track = bool(getattr(node, "track_order", False))
        out = [(t, f, b, 0) for t, f, b in msgs]
        if links is not None:
            out += self.links(links, track)
        if len(attrs) > _MAX_COMPACT or any(len(a) > _V1_MESSAGE_MAX for a in attrs):
            out.append((0x15, 0x04, self.dense_attributes(node.attrs, attrs, track), 0))
        else:
            if track:  # h5py writes the attribute info of a tracked header
                out.append((0x15, 0x04, struct.pack("<BBH", 0, 3, len(attrs))
                            + struct.pack("<QQQ", UNDEF, UNDEF, UNDEF), 0))
            out += [(0x0C, 0, a, i) for i, a in enumerate(attrs)]
        if refs > 1:
            out.append((0x16, 0, struct.pack("<BI", 0, refs), 0))
        chunk = b"".join(struct.pack("<BHB", t, len(b), f)
                         + (struct.pack("<H", c) if track else b"") + b for t, f, b, c in out)
        block = b"OHDR" + bytes([2, 0x02 | (0x0C if track else 0)]) \
            + struct.pack("<I", len(chunk)) + chunk
        return self.alloc(block + struct.pack("<I", self._lookup3(block)))

    def attributes(self, node) -> list:
        """The attribute message bodies of ``node``, made once."""
        if id(node) not in self._attrs:
            self._attrs[id(node)] = [self.attribute(n, v) for n, v in node.attrs.items()]
        return self._attrs[id(node)]

    @staticmethod
    def _v2(node, attrs: list) -> bool:
        return bool(getattr(node, "track_order", False)) or \
            any(len(a) > _V1_MESSAGE_MAX for a in attrs)

    def links(self, links: list, track: bool) -> list:
        """A version-2 group's link info and group info messages, and its
        links: as link messages, or past 8 in dense storage."""
        ginfo = (0x0A, 0x01, b"\0\0", 0)
        bodies = [_link_message(n, t, i if track else None) for i, (n, t) in enumerate(links)]
        head = struct.pack("<BB", 0, 3 if track else 0)
        head += struct.pack("<Q", len(links)) if track else b""
        if len(links) <= _MAX_COMPACT:
            linfo = head + struct.pack("<QQ", UNDEF, UNDEF) + (struct.pack("<Q", UNDEF)
                                                               if track else b"")
            return [(0x02, 0, linfo, 0), ginfo] + [(0x06, 0, b, 0) for b in bodies]
        heap, ids = self.fractal_heap(bodies, *_LINK_HEAP)
        names = sorted(((self._lookup3(n.encode("utf-8")), n.encode("utf-8"), hid)
                        for (n, _), hid in zip(links, ids)))
        linfo = head + struct.pack("<QQ", heap, self.btree2(
            5, [struct.pack("<I", h) + hid for h, _, hid in names], 11))
        if track:
            linfo += struct.pack("<Q", self.btree2(
                6, [struct.pack("<q", i) + hid for i, hid in enumerate(ids)], 15))
        return [(0x02, 0, linfo, 0), ginfo]

    def dense_attributes(self, values: dict, bodies: list, track: bool) -> bytes:
        """An attribute info message over dense storage of ``bodies``."""
        heap, ids = self.fractal_heap(bodies, *_ATTR_HEAP)
        recs = sorted((self._lookup3(n.encode("utf-8")), n.encode("utf-8"), i, hid)
                      for i, (n, hid) in enumerate(zip(values, ids)))
        by_name = self.btree2(8, [hid + struct.pack("<BII", 0, i, h) for h, _, i, hid in recs],
                              17)
        body = struct.pack("<BB", 0, 3 if track else 0)
        body += struct.pack("<H", len(bodies)) if track else b""
        body += struct.pack("<QQ", heap, by_name)
        if track:
            body += struct.pack("<Q", self.btree2(
                9, [hid + struct.pack("<BI", 0, i) for i, hid in enumerate(ids)], 13))
        return body

    def fractal_heap(self, objects: list, id_len: int, bits: int, start: int):
        """(header address, heap ids) of a fractal heap holding
        ``objects`` as HDF5 lays one out: an object over 4 KiB as a huge
        object (its bytes on their own, found through a version-2 B-tree
        of type 1), the others in checksummed direct blocks filled in the
        doubling table's order -- the first block as the root while it
        holds them all, else a root indirect block of a power of two rows,
        with indirect blocks below it past the 64 KiB rows.  No
        free-space manager: HDF5 adds blocks after the last one (the
        iterator offset) and leaves the blocks' unused tails alone."""
        width, off_size = _HEAP_WIDTH, (bits + 7) // 8
        len_size = min((hdf5_v2.log2_gen(_HEAP_MAX_DIRECT) + 7) // 8,
                       hdf5_v2.limit_enc_size(_HEAP_MAX_MANAGED))
        direct_rows = hdf5_v2.log2_gen(_HEAP_MAX_DIRECT) - hdf5_v2.log2_gen(start) + 2
        max_rows = bits - hdf5_v2.log2_gen(start * width) + 1

        def row_size(r: int) -> int:
            return start if r == 0 else start << (r - 1)

        def row_start(r: int) -> int:
            return 0 if r == 0 else width * start << (r - 1)

        def sub_rows(r: int) -> int:  # rows of an indirect block in row r
            return hdf5_v2.log2_gen(row_size(r)) - hdf5_v2.log2_gen(start * width) + 1

        def direct_blocks(base: int, nrows: int):  # (offset, size) in heap order
            for r in range(nrows):
                for c in range(width):
                    off = base + row_start(r) + c * row_size(r)
                    if r < direct_rows:
                        yield off, row_size(r)
                    else:
                        yield from direct_blocks(off, sub_rows(r))

        head = 5 + 8 + off_size + 4
        at = self.alloc(bytes(146))
        ids: list = [b""] * len(objects)
        blocks: dict = {}  # heap offset -> the block's bytes
        order = direct_blocks(0, max_rows)
        cur, fill, huge = None, 0, []
        for i, o in enumerate(objects):
            if len(o) > _HEAP_MAX_MANAGED:
                huge.append(i)
                continue
            if cur is None or fill + len(o) > len(blocks[cur]):
                cur, size = next(order)
                while size < head + len(o):  # a block too small for it stays unallocated
                    cur, size = next(order)
                blocks[cur], fill = bytearray(size), head
            blocks[cur][fill:fill + len(o)] = o
            hid = b"\0" + (cur + fill).to_bytes(off_size, "little") \
                + len(o).to_bytes(len_size, "little")
            ids[i] = hid + bytes(id_len - len(hid))
            fill += len(o)
        addrs = {}
        for off, block in blocks.items():
            block[:head] = b"FHDB\0" + struct.pack("<Q", at) + off.to_bytes(off_size, "little") \
                + bytes(4)
            block[head - 4:head] = struct.pack("<I", self._lookup3(bytes(block)))
            addrs[off] = self.alloc(bytes(block))
        offs = sorted(addrs)

        def indirect(base: int, nrows: int) -> int:
            ents = []
            for r in range(nrows):
                for c in range(width):
                    off = base + row_start(r) + c * row_size(r)
                    if r < direct_rows:
                        ents.append(addrs.get(off, UNDEF))
                        continue
                    i = bisect.bisect_left(offs, off)
                    used = i < len(offs) and offs[i] < off + row_size(r)
                    ents.append(indirect(off, sub_rows(r)) if used else UNDEF)
            body = b"FHIB\0" + struct.pack("<Q", at) + base.to_bytes(off_size, "little") \
                + struct.pack(f"<{len(ents)}Q", *ents)
            return self.alloc(body + struct.pack("<I", self._lookup3(body)))

        man_alloc = sum(len(b) for b in blocks.values())
        row_free: list = []  # free bytes of a row's blocks, allocated or not (HDF5's count)
        for r in range(max_rows):
            row_free.append(width * (row_size(r) - head) if r < direct_rows
                            else width * sum(row_free[:sub_rows(r)]))
        if not blocks:
            root, rows, man_size, iter_off = UNDEF, 0, 0, 0
        elif offs == [0]:  # the first block alone: the root
            root, rows, man_size, iter_off = addrs[0], 0, start, 0
        else:
            last = offs[-1]
            need = next(r for r in range(max_rows) if last < row_start(r + 1))
            rows = min(1 << need.bit_length(), max_rows)  # HDF5 doubles the root's rows
            root, man_size, iter_off = indirect(0, rows), row_start(rows), last + len(blocks[last])
        recs = []
        for key, i in enumerate(huge, 1):
            recs.append(struct.pack("<QQQ", self.alloc(objects[i]), len(objects[i]), key))
            ids[i] = b"\x10" + key.to_bytes(id_len - 1, "little")
        huge_tree = self.btree2(1, recs, 24) if recs else UNDEF
        free = (start - head if rows == 0 and blocks else sum(row_free[:rows])) \
            - sum(len(o) for o in objects if len(o) <= _HEAP_MAX_MANAGED)
        hdr = b"FRHP\0" + struct.pack("<HHBI", id_len, 0, 2, _HEAP_MAX_MANAGED)
        hdr += struct.pack("<12Q", len(huge), huge_tree, free, UNDEF, man_size, man_alloc, iter_off,
                           len(objects) - len(huge), sum(len(objects[i]) for i in huge),
                           len(huge), 0, 0)
        hdr += struct.pack("<HQQHHQH", width, start, _HEAP_MAX_DIRECT, bits, 1, root, rows)
        self.buf[at:at + 146] = hdr + struct.pack("<I", self._lookup3(hdr))
        return at, ids

    def btree2(self, kind: int, records: list, rsize: int) -> int:
        """A version-2 B-tree of ``records`` (in key order) in HDF5's
        512-byte nodes, built from the leaves up: every leaf at one depth,
        each node's records split evenly among its children."""
        size, n = _BTREE2_NODE, len(records)
        max_nrec = [(size - 10) // rsize]
        cum_max, cum_size = [max_nrec[0]], [0]
        nrec_size = hdf5_v2.limit_enc_size(max_nrec[0])
        while cum_max[-1] < n:  # H5B2__hdr_init's sizes, a depth at a time
            d = len(max_nrec)
            ptr = 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
            max_nrec.append((size - 10 - ptr) // (rsize + ptr))
            cum_max.append((max_nrec[d] + 1) * cum_max[d - 1] + max_nrec[d])
            cum_size.append(hdf5_v2.limit_enc_size(cum_max[d]))
        depth = len(max_nrec) - 1

        def node(recs: list, d: int) -> "tuple[int, int]":  # (address, its own records)
            if d == 0:
                body = b"BTLF\0" + bytes([kind]) + b"".join(recs)
                body += struct.pack("<I", self._lookup3(body))
                return self.alloc(body + bytes(size - len(body))), len(recs)
            parts = -(-(len(recs) + 1) // (cum_max[d - 1] + 1))
            share, at, seps, ptrs = len(recs) - parts + 1, 0, [], b""
            for i in range(parts):
                k = share // parts + (i < share % parts)
                child, own = node(recs[at:at + k], d - 1)
                ptrs += struct.pack("<Q", child) + own.to_bytes(nrec_size, "little")
                ptrs += k.to_bytes(cum_size[d - 1], "little") if d > 1 else b""
                at += k
                if i < parts - 1:
                    seps.append(recs[at])
                    at += 1
            body = b"BTIN\0" + bytes([kind]) + b"".join(seps) + ptrs
            body += struct.pack("<I", self._lookup3(body))
            return self.alloc(body + bytes(size - len(body))), len(seps)

        root, own = node(records, depth) if records else (UNDEF, 0)
        head = b"BTHD\0" + bytes([kind]) + struct.pack("<IHHBBQHQ", size, rsize, depth, 100, 40,
                                                       root, own, n)
        return self.alloc(head + struct.pack("<I", self._lookup3(head)))

    # -- objects
    def group(self, g: Group) -> "tuple[int, int, int]":
        if self._v2(g, self.attributes(g)):
            links = [(n, c if isinstance(c, SoftLink) else self.node(c)[0])
                     for n, c in g.children.items()]
            return self.header(g, [], links), 0, 0
        names = sorted(g.children, key=lambda s: s.encode("utf-8"))
        addrs = {n: self.node(g.children[n]) for n in names
                 if not isinstance(g.children[n], SoftLink)}
        heap = bytearray(8)  # offset 0: the empty name
        offsets, values = {}, {}
        for n in names:
            offsets[n] = len(heap)
            raw = n.encode("utf-8") + b"\0"
            heap += raw + b"\0" * (_pad8(len(raw)) - len(raw))
        for n in names:
            if isinstance(g.children[n], SoftLink):
                values[n] = len(heap)
                raw = g.children[n].path.encode("utf-8") + b"\0"
                heap += raw + b"\0" * (_pad8(len(raw)) - len(raw))
        heap_data = self.alloc(bytes(heap))
        heap_addr = self.alloc(b"HEAP\0\0\0\0" + struct.pack("<QQQ", len(heap), 1, heap_data))
        snod = b"SNOD\x01\0" + struct.pack("<H", len(names))
        for n in names:
            if n in values:  # a soft link: cache type 2, its value's heap offset
                snod += struct.pack("<QQI4xI12x", offsets[n], UNDEF, 2, values[n])
                continue
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
        return self.header(g, [(0x11, 0, struct.pack("<QQ", tree, heap_addr))]), tree, heap_addr

    def node(self, n) -> "tuple[int, int, int]":
        """(object header, B-tree, heap) -- the last two 0 unless a
        symbol-table group."""
        if id(n) not in self._written:
            if isinstance(n, Group):
                addrs = self.group(n)
            elif isinstance(n, Datatype):
                addrs = (self.header(n, [(0x03, 0x05, n.raw)]), 0, 0)
            else:
                addrs = (self.dataset(n), 0, 0)
            self._written[id(n)] = (n, addrs)
        return self._written[id(n)][1]

    def dataset(self, ds: Dataset) -> int:
        arr = np.asarray(ds.read(), order="C")  # keeps a scalar's shape ()
        shape = tuple(arr.shape)
        if arr.dtype == object:
            if ds.h5type is None or ds.h5type[0] & 0x0F != 9:
                raise NotSupportedError("the port's HDF5 writer takes object arrays only as "
                                        "the variable-length strings of a dataset it read")
            dtm = ds.h5type
            raw = self.vlen_strings([v.encode("utf-8") if isinstance(v, str) else bytes(v)
                                     for v in arr.ravel()])
            arr = np.frombuffer(raw, "V16").reshape(shape)
        elif ds.h5type is not None and ds.h5type[0] & 0x0F == 8 and arr.dtype != bool:
            dtm = ds.h5type  # an enum read as its base integer: written back as the enum
        else:
            dtm = _dtype_message(arr.dtype)
        itemsize = arr.dtype.itemsize
        msgs = [(0x01, 0, _space_message(shape, ds.maxshape if ds.chunks or ds.virtual
                                         else None))]
        if ds.committed is not None:  # a shared message naming the committed type
            msgs.append((0x03, 0x03, struct.pack("<BBQ", 2, 2, self.node(ds.committed)[0])))
        else:
            msgs.append((0x03, 0x01, dtm))
        fill = ds.fillvalue if ds.fillvalue is not None else bytes(itemsize)
        alloc_time = 3 if ds.chunks else 2
        msgs.append((0x05, 0, struct.pack("<BBBBI", 2, alloc_time, 2, 1, itemsize) + fill))
        if ds.virtual is not None:
            lay = struct.pack("<BBQI", 4, 3, *self.virtual_mappings(ds.virtual))
        elif ds.chunks:
            if ds.filters:
                msgs.append((0x0B, 0, _filter_message(ds.filters,
                                                      math.prod(ds.chunks) * itemsize)))
            tree = self.chunk_tree(arr, ds)
            lay = struct.pack("<BBBQ", 3, 2, len(shape) + 1, tree)
            lay += struct.pack(f"<{len(shape) + 1}I", *ds.chunks, itemsize)
        else:
            raw = arr.tobytes()
            addr = self.alloc(raw) if raw else UNDEF
            lay = struct.pack("<BBQQ", 3, 1, addr, len(raw))
        msgs.append((0x08, 0, lay))
        return self.header(ds, msgs)

    def virtual_mappings(self, mappings) -> "tuple[int, int]":
        """(global heap collection, index) of a virtual layout's mappings,
        encoded as HDF5 1.10+ encodes them, with their checksum."""
        blob = struct.pack("<BQ", 0, len(mappings))
        for src_file, src_dset, ssel, vsel in mappings:
            blob += src_file.encode("utf-8") + b"\0" + src_dset.encode("utf-8") + b"\0"
            blob += bytes(ssel) + bytes(vsel)
        from tmlibrary_tpu_torch import native

        blob += struct.pack("<I", native.lookup3(blob))
        elem = self.vlen_strings([blob])
        _length, heap, index = struct.unpack("<IQI", elem)
        return heap, index

    def chunk_tree(self, arr: np.ndarray, ds: Dataset) -> int:
        chunks, rank = ds.chunks, arr.ndim
        grid = [range(0, n, c) for n, c in zip(arr.shape, chunks)]
        entries = []
        for offs in np.ndindex(*[len(g) for g in grid]):
            o = tuple(g[i] for g, i in zip(grid, offs))
            block = np.zeros(chunks, arr.dtype)
            sel = tuple(slice(a, min(a + c, n)) for a, c, n in zip(o, chunks, arr.shape))
            block[tuple(slice(0, s.stop - s.start) for s in sel)] = arr[sel]
            data, mask = block.tobytes(), 0
            for i, (fid, cd) in enumerate(ds.filters):
                if fid == 2 and arr.dtype.itemsize > 1:
                    data = np.frombuffer(data, np.uint8).reshape(-1, arr.dtype.itemsize).T.tobytes()
                elif fid == 1:
                    data = zlib.compress(data, cd[0] if cd else 4)
                elif fid == 3:
                    data = data + struct.pack("<I", fletcher32(data))
                elif fid == LZF:
                    from tmlibrary_tpu_torch import native

                    packed = native.lzf_compress(data)
                    if packed is None:  # not shorter: stored as it is, as h5py's filter does
                        mask |= 1 << i
                    else:
                        data = packed
            entries.append((o, self.alloc(data), len(data), mask))
        if not entries:
            return UNDEF

        def key(size, mask, offs):
            return struct.pack("<II", size, mask) + struct.pack(f"<{rank + 1}Q", *offs, 0)

        last = entries[-1][0]
        end_key = key(0, 0, tuple(a + c for a, c in zip(last, chunks)))
        level = entries  # (first offset, address, size, mask)
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
                for off, child, size, mask in grp:
                    body += key(size if depth == 0 else 0, mask if depth == 0 else 0, off)
                    body += struct.pack("<Q", child)
                nxt = groups[gi + 1][0][0] if gi + 1 < len(groups) else None
                body += key(0, 0, nxt) if nxt is not None else end_key
                self.buf[addrs[gi]:addrs[gi] + len(body)] = body
                upper.append((grp[0][0], addrs[gi], 0, 0))
            if len(upper) == 1:
                return upper[0][1]
            level, depth = upper, depth + 1

    def finish(self, root: Group) -> bytes:
        header, tree, heap = self.group(root)
        sb = SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
        sb += struct.pack("<HHI", self.leaf_k, 16, 0)
        sb += struct.pack("<QQQQ", 0, UNDEF, len(self.buf), UNDEF)
        sb += struct.pack("<QQI4xQQ", 0, header, 1 if tree else 0, tree, heap)
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
