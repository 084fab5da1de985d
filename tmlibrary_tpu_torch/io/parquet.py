"""Parquet feature shards without ``pandas`` or ``pyarrow``.

The JAX package writes each feature shard with ``DataFrame.to_parquet``
and reads shards with ``pd.read_parquet``.  The port's target machine has
neither package, so this module reads and writes the format itself: the
file is ``PAR1``, the column chunks, a ``FileMetaData`` struct in the
Thrift compact protocol, its length and ``PAR1`` again.

:func:`write_table` writes one row group, each column an uncompressed
v1 ``PLAIN`` data page: ``INT64`` for integer arrays, ``DOUBLE`` for
floats, ``BYTE_ARRAY`` with the UTF8/STRING logical type for strings,
and a LIST of ``INT64`` or ``DOUBLE`` for an object array of sequences
(:func:`list_column`; pyarrow's three levels, ``<name>.list.element``,
with repetition and definition levels).  Every column is ``OPTIONAL``
with definition levels, as pyarrow writes a DataFrame's columns, and a
NaN float is written as a null, as pandas does.  The ``pandas``
key-value entry that pyarrow adds is written too (no index columns,
each column's pandas and numpy type), so ``pd.read_parquet`` gives back
the writer's dtypes and column order.

:func:`read_table` reads what ``to_parquet`` writes with its defaults
and with small page limits: ``SNAPPY`` or uncompressed pages, a
dictionary page with ``RLE_DICTIONARY`` data pages, the ``PLAIN`` pages
that follow it in the same chunk once the dictionary passes its page
limit, several data pages a chunk, several row groups, and definition
levels in the RLE/bit-packed hybrid, flat ``INT32``, ``INT64``,
``FLOAT``, ``DOUBLE`` and ``BYTE_ARRAY`` columns (the 32-bit ones as
pyarrow writes a DataFrame's int32 and float32 columns), and three-level
LIST columns of ``INT64`` or ``DOUBLE`` with either element name pyarrow
has used (``element``, ``item``).  Nulls come back as NaN (an integer
column with nulls becomes float64, as in pandas); a LIST column comes back as an
object array of 1-D arrays (None for a null row).  Statistics and other
optional metadata are skipped; anything else (another nested or repeated
shape, another physical type, codec or page kind) raises
:class:`ParquetError` naming what it met.
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Mapping, NamedTuple, Sequence

import numpy as np

from tmlibrary_tpu_torch.io import snappy

MAGIC = b"PAR1"

# ------------------------------------------------------------ enumerations
#: physical types (``Type``)
INT32, INT64, FLOAT, DOUBLE, BYTE_ARRAY = 1, 2, 4, 5, 6
TYPE_NAMES = {0: "BOOLEAN", 1: "INT32", 2: "INT64", 3: "INT96", 4: "FLOAT", 5: "DOUBLE",
              6: "BYTE_ARRAY", 7: "FIXED_LEN_BYTE_ARRAY"}
#: ``FieldRepetitionType``
REQUIRED, OPTIONAL, REPEATED = 0, 1, 2
#: ``Encoding``
PLAIN, PLAIN_DICTIONARY, RLE, BIT_PACKED, RLE_DICTIONARY = 0, 2, 3, 4, 8
ENCODING_NAMES = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
                  5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY",
                  7: "DELTA_BYTE_ARRAY", 8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}
#: ``CompressionCodec``
UNCOMPRESSED, SNAPPY = 0, 1
CODEC_NAMES = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO", 4: "BROTLI", 5: "LZ4",
               6: "ZSTD", 7: "LZ4_RAW"}
#: ``PageType``
DATA_PAGE, INDEX_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = 0, 1, 2, 3
PAGE_NAMES = {0: "DATA_PAGE", 1: "INDEX_PAGE", 2: "DICTIONARY_PAGE", 3: "DATA_PAGE_V2"}
#: ``ConvertedType.UTF8`` and ``ConvertedType.LIST``
UTF8, LIST = 0, 3
#: the element names of pyarrow's LIST columns (``item`` before 13.0)
LIST_ELEMENT_NAMES = ("element", "item")


class ParquetError(ValueError):
    """A file this codec cannot read, or a table it cannot write."""


# ------------------------------------------------ Thrift compact protocol
T_STOP, T_TRUE, T_FALSE, T_BYTE, T_I16, T_I32, T_I64, T_DOUBLE, T_BINARY, T_LIST, T_SET, \
    T_MAP, T_STRUCT = range(13)
#: the writer's name for a boolean field (written as T_TRUE or T_FALSE)
T_BOOL = -1


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _put_varint(out: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _put_value(out: bytearray, ttype: int, value) -> None:
    if ttype in (T_BYTE,):
        out += struct.pack("<b", value)
    elif ttype in (T_I16, T_I32, T_I64):
        _put_varint(out, _zigzag(int(value)))
    elif ttype == T_DOUBLE:
        out += struct.pack("<d", value)
    elif ttype == T_BINARY:
        raw = value.encode() if isinstance(value, str) else bytes(value)
        _put_varint(out, len(raw))
        out += raw
    elif ttype == T_STRUCT:
        out += encode_struct(value)
    elif ttype == T_LIST:
        elem, items = value
        if len(items) < 15:
            out.append(len(items) << 4 | elem)
        else:
            out.append(0xF0 | elem)
            _put_varint(out, len(items))
        for item in items:
            _put_value(out, elem, item)
    else:
        raise ParquetError(f"thrift: cannot write type {ttype}")


def encode_struct(fields: Sequence[tuple[int, int, object]]) -> bytes:
    """A struct in the compact protocol from ``(field id, type, value)``
    triples in increasing field-id order; a None value is left out.  A
    list's value is ``(element type, items)``, a struct's its own
    triples."""
    out = bytearray()
    last = 0
    for fid, ttype, value in fields:
        if value is None:
            continue
        wire = (T_TRUE if value else T_FALSE) if ttype == T_BOOL else ttype
        delta = fid - last
        if 0 < delta <= 15:
            out.append(delta << 4 | wire)
        else:
            out.append(wire)
            _put_varint(out, _zigzag(fid))
        if ttype != T_BOOL:
            _put_value(out, ttype, value)
        last = fid
    out.append(T_STOP)
    return bytes(out)


class _ThriftReader:
    """Decodes compact-protocol structs into ``{field id: value}`` dicts
    (lists as Python lists, binaries as bytes); unknown fields decode
    like known ones, so a reader keeps only what it asks for."""

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def _byte(self) -> int:
        if self.pos >= len(self.buf):
            raise ParquetError("thrift: truncated metadata")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def _varint(self) -> int:
        shift = result = 0
        while True:
            b = self._byte()
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result
            shift += 7

    def _int(self) -> int:
        n = self._varint()
        return (n >> 1) ^ -(n & 1)

    def value(self, ttype: int):
        if ttype == T_TRUE:
            return True
        if ttype == T_FALSE:
            return False
        if ttype == T_BYTE:
            return struct.unpack("<b", bytes([self._byte()]))[0]
        if ttype in (T_I16, T_I32, T_I64):
            return self._int()
        if ttype == T_DOUBLE:
            raw = bytes(self.buf[self.pos:self.pos + 8])
            self.pos += 8
            return struct.unpack("<d", raw)[0]
        if ttype == T_BINARY:
            n = self._varint()
            raw = bytes(self.buf[self.pos:self.pos + n])
            self.pos += n
            return raw
        if ttype in (T_LIST, T_SET):
            head = self._byte()
            n = head >> 4
            if n == 15:
                n = self._varint()
            elem = head & 0x0F
            if elem in (T_TRUE, T_FALSE):  # a list's booleans are one byte each
                return [self._byte() == T_TRUE for _ in range(n)]
            return [self.value(elem) for _ in range(n)]
        if ttype == T_MAP:
            n = self._varint()
            if not n:
                return {}
            kinds = self._byte()
            return {self.value(kinds >> 4): self.value(kinds & 0x0F) for _ in range(n)}
        if ttype == T_STRUCT:
            return self.struct()
        raise ParquetError(f"thrift: unknown type {ttype}")

    def struct(self) -> dict:
        fields = {}
        last = 0
        while True:
            head = self._byte()
            if head == T_STOP:
                return fields
            ttype = head & 0x0F
            delta = head >> 4
            fid = last + delta if delta else self._int()
            fields[fid] = self.value(ttype)
            last = fid


# ------------------------------------------------------ RLE/bit-packed hybrid
def _rle_encode_levels(levels: np.ndarray, bit_width: int = 1) -> bytes:
    """Levels of ``bit_width`` bits in the hybrid: one RLE run when every
    level is the same, else bit-packed groups of eight."""
    levels = np.asarray(levels, np.int64)
    n = len(levels)
    out = bytearray()
    if n == 0:
        return bytes(out)
    if (levels == levels[0]).all():
        _put_varint(out, n << 1)
        out += int(levels[0]).to_bytes((bit_width + 7) // 8, "little")
        return bytes(out)
    groups = -(-n // 8)
    _put_varint(out, groups << 1 | 1)
    padded = np.zeros(groups * 8, np.int64)
    padded[:n] = levels
    bits = (padded[:, None] >> np.arange(bit_width)) & 1
    out += np.packbits(bits.astype(np.uint8).reshape(-1), bitorder="little").tobytes()
    return bytes(out)


def _rle_decode(buf, pos: int, end: int, bit_width: int, count: int) -> np.ndarray:
    """``count`` values of the RLE/bit-packed hybrid in ``buf[pos:end]``."""
    out = np.zeros(count, np.int64)
    k = 0
    byte_w = (bit_width + 7) // 8
    weights = (1 << np.arange(bit_width, dtype=np.int64)) if bit_width else None
    rd = _ThriftReader(buf, pos)
    while k < count:
        if rd.pos >= end:
            raise ParquetError(f"RLE/bit-packed run ends after {k} of {count} values")
        header = rd._varint()
        if header & 1:
            n = (header >> 1) * 8
            nbytes = (header >> 1) * bit_width
            take = min(n, count - k)
            if bit_width:
                chunk = np.frombuffer(bytes(buf[rd.pos:min(rd.pos + nbytes, end)]), np.uint8)
                if len(chunk) < nbytes:
                    chunk = np.concatenate([chunk, np.zeros(nbytes - len(chunk), np.uint8)])
                bits = np.unpackbits(chunk, bitorder="little").reshape(n, bit_width)
                out[k:k + take] = (bits[:take].astype(np.int64) * weights).sum(axis=1)
            rd.pos += nbytes
        else:
            n = header >> 1
            take = min(n, count - k)
            out[k:k + take] = int.from_bytes(bytes(buf[rd.pos:rd.pos + byte_w]), "little")
            rd.pos += byte_w
        k += take
    return out


# ------------------------------------------------------------------ PLAIN
#: the flat numeric physical types and their little-endian numpy dtypes
_NUMERIC = {INT32: np.dtype("<i4"), INT64: np.dtype("<i8"), FLOAT: np.dtype("<f4"),
            DOUBLE: np.dtype("<f8")}


def _plain_decode(physical: int, buf, pos: int, end: int, count: int) -> np.ndarray:
    """``count`` PLAIN values of ``buf[pos:end]``."""
    if physical in _NUMERIC:
        dtype = _NUMERIC[physical]
        if pos + count * dtype.itemsize > end:
            raise ParquetError("PLAIN values run past their page")
        return np.frombuffer(buf, dtype, count, pos)
    values = []
    for _ in range(count):
        (n,) = struct.unpack_from("<I", buf, pos)
        values.append(bytes(buf[pos + 4:pos + 4 + n]).decode("utf-8"))
        pos += 4 + n
    if pos > end:
        raise ParquetError("PLAIN values run past their page")
    return np.asarray(values, dtype=str) if values else np.zeros(0, "<U1")


def _plain_encode(physical: int, values: np.ndarray) -> bytes:
    if physical == INT64:
        return np.ascontiguousarray(values, "<i8").tobytes()
    if physical == DOUBLE:
        return np.ascontiguousarray(values, "<f8").tobytes()
    parts = []
    for s in values.tolist():
        raw = str(s).encode("utf-8")
        parts.append(struct.pack("<I", len(raw)))
        parts.append(raw)
    return b"".join(parts)


# ------------------------------------------------------------------ writer
def list_column(rows: Sequence) -> np.ndarray:
    """An object array holding one sequence per row (None for a null
    row): what :func:`write_table` writes as a LIST column."""
    out = np.empty(len(rows), object)
    for i, row in enumerate(rows):
        out[i] = row
    return out


def _is_list_column(values: np.ndarray) -> bool:
    if values.dtype != object:
        return False
    first = next((v for v in values.tolist() if v is not None), None)
    return isinstance(first, (list, tuple, np.ndarray))


def _list_element_type(name: str, values: np.ndarray) -> int:
    """``INT64`` when every element is an integer, ``DOUBLE`` when any is
    a float (and for a column of empty lists); a cell that is not a flat
    sequence raises."""
    cells = [np.asarray(v) for v in values.tolist() if v is not None]
    if any(c.ndim != 1 for c in cells):
        raise ParquetError(f"column '{name}': a list cell that is not one flat sequence")
    kinds = {c.dtype.kind for c in cells if len(c)}
    if not kinds - set("iub"):
        return INT64 if kinds else DOUBLE
    if not kinds - set("iubf"):
        return DOUBLE
    raise ParquetError(f"column '{name}': list elements of kind {sorted(kinds)} have no "
                       "Parquet mapping here")


def _physical(name: str, values: np.ndarray) -> int:
    kind = values.dtype.kind
    if kind in "iu":
        return INT64
    if kind == "f":
        return DOUBLE
    if kind in "UO":
        return BYTE_ARRAY
    raise ParquetError(f"column '{name}': dtype {values.dtype} has no Parquet mapping here")


def _pandas_metadata(names: list[str], physical: list[int], lists: list[bool]) -> str:
    """The ``pandas`` key-value entry pyarrow writes for a DataFrame
    without an index: each column's pandas and numpy type."""
    types = {INT64: ("int64", "int64"), DOUBLE: ("float64", "float64"),
             BYTE_ARRAY: ("object", "str")}
    columns = [
        {"name": n, "field_name": n,
         "pandas_type": f"list[{types[p][0]}]" if is_list else types[p][0],
         "numpy_type": "object" if is_list else types[p][1], "metadata": None}
        for n, p, is_list in zip(names, physical, lists)
    ]
    return json.dumps({"index_columns": [], "column_indexes": [], "columns": columns,
                       "attributes": {}, "creator": {"library": "tmlibrary_tpu_torch"},
                       "pandas_version": "3.0.3"})


def _flat_page(ptype: int, values: np.ndarray, n_rows: int) -> tuple[bytes, int]:
    """A flat OPTIONAL column's page body (definition levels, values) and
    its level count."""
    if ptype == DOUBLE:
        values = values.astype(np.float64)
        present = ~np.isnan(values)
        values = values[present]
    else:
        if ptype == INT64:
            values = values.astype(np.int64)
        present = np.ones(n_rows, bool)
    levels = _rle_encode_levels(present.astype(np.uint8))
    return struct.pack("<I", len(levels)) + levels + _plain_encode(ptype, values), n_rows


def _list_page(ptype: int, rows: np.ndarray) -> tuple[bytes, int]:
    """A LIST column's page body: repetition levels (width 1), definition
    levels (width 2: 0 a null row, 1 an empty list, 2 a null element, 3 a
    value) and the values; returns it and its level count."""
    rep, dfn, vals = [], [], []
    for row in rows.tolist():
        if row is None:
            rep.append(0)
            dfn.append(0)
            continue
        items = np.asarray(row).reshape(-1)
        if not len(items):
            rep.append(0)
            dfn.append(1)
            continue
        rep.extend([0] + [1] * (len(items) - 1))
        if ptype == DOUBLE:
            items = items.astype(np.float64)
            present = ~np.isnan(items)
            dfn.extend(np.where(present, 3, 2).tolist())
            vals.append(items[present])
        else:
            dfn.extend([3] * len(items))
            vals.append(items.astype(np.int64))
    values = np.concatenate(vals) if vals else np.zeros(0, np.float64 if ptype == DOUBLE
                                                           else np.int64)
    r = _rle_encode_levels(np.asarray(rep), 1)
    d = _rle_encode_levels(np.asarray(dfn), 2)
    body = (struct.pack("<I", len(r)) + r + struct.pack("<I", len(d)) + d
            + _plain_encode(ptype, values))
    return body, len(rep)


def write_table(path, columns: Mapping[str, np.ndarray]) -> Path:
    """Write ``columns`` (name -> 1-D array, all one length) as a Parquet
    file of one row group, in the mapping's column order; an object array
    of sequences (:func:`list_column`) becomes a LIST column.  The file is
    written beside ``path`` and renamed over it."""
    path = Path(path)
    names = list(columns)
    arrays = [np.asarray(columns[n]) for n in names]
    lengths = {len(a) for a in arrays}
    if len(lengths) > 1 or any(a.ndim != 1 for a in arrays):
        raise ParquetError(f"{path.name}: columns of unequal length or rank")
    n_rows = lengths.pop() if lengths else 0
    lists = [_is_list_column(a) for a in arrays]
    physical = [_list_element_type(n, a) if is_list else _physical(n, a)
                for n, a, is_list in zip(names, arrays, lists)]

    body = bytearray(MAGIC)
    chunks = []
    for name, values, ptype, is_list in zip(names, arrays, physical, lists):
        page, n_levels = (_list_page(ptype, values) if is_list
                          else _flat_page(ptype, values, n_rows))
        header = encode_struct([
            (1, T_I32, DATA_PAGE),
            (2, T_I32, len(page)),
            (3, T_I32, len(page)),
            (5, T_STRUCT, [(1, T_I32, n_levels), (2, T_I32, PLAIN), (3, T_I32, RLE),
                           (4, T_I32, RLE)]),
        ])
        offset = len(body)
        body += header
        body += page
        size = len(header) + len(page)
        meta = [
            (1, T_I32, ptype),
            (2, T_LIST, (T_I32, [PLAIN, RLE])),
            (3, T_LIST, (T_BINARY, [name, "list", "element"] if is_list else [name])),
            (4, T_I32, UNCOMPRESSED),
            (5, T_I64, n_levels),
            (6, T_I64, size),
            (7, T_I64, size),
            (9, T_I64, offset),
        ]
        chunks.append((offset, size, [(2, T_I64, offset), (3, T_STRUCT, meta)]))

    schema = [[(4, T_BINARY, "schema"), (5, T_I32, len(names))]]
    for name, ptype, is_list in zip(names, physical, lists):
        if is_list:
            schema += [
                [(3, T_I32, OPTIONAL), (4, T_BINARY, name), (5, T_I32, 1), (6, T_I32, LIST),
                 (10, T_STRUCT, [(3, T_STRUCT, [])])],
                [(3, T_I32, REPEATED), (4, T_BINARY, "list"), (5, T_I32, 1)],
                [(1, T_I32, ptype), (3, T_I32, OPTIONAL), (4, T_BINARY, "element")],
            ]
            continue
        element = [(1, T_I32, ptype), (3, T_I32, OPTIONAL), (4, T_BINARY, name)]
        if ptype == BYTE_ARRAY:
            element += [(6, T_I32, UTF8), (10, T_STRUCT, [(1, T_STRUCT, [])])]
        schema.append(element)
    total = sum(size for _, size, _ in chunks)
    row_group = [
        (1, T_LIST, (T_STRUCT, [c for _, _, c in chunks])),
        (2, T_I64, total),
        (3, T_I64, n_rows),
        (5, T_I64, chunks[0][0] if chunks else len(MAGIC)),
        (6, T_I64, total),
        (7, T_I16, 0),
    ]
    footer = encode_struct([
        (1, T_I32, 2),
        (2, T_LIST, (T_STRUCT, schema)),
        (3, T_I64, n_rows),
        (4, T_LIST, (T_STRUCT, [row_group])),
        (5, T_LIST, (T_STRUCT, [[(1, T_BINARY, "pandas"),
                                 (2, T_BINARY, _pandas_metadata(names, physical, lists))]])),
        (6, T_BINARY, "tmlibrary_tpu_torch parquet writer"),
    ])
    body += footer
    body += struct.pack("<I", len(footer))
    body += MAGIC
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_bytes(bytes(body))
    os.replace(tmp, path)
    return path


# ------------------------------------------------------------------ reader
def read_metadata(data: bytes) -> dict:
    """The decoded ``FileMetaData`` of a whole file's bytes."""
    if len(data) < 12 or data[:4] != MAGIC or data[-4:] != MAGIC:
        raise ParquetError("not a Parquet file (no PAR1 magic at both ends)")
    (n,) = struct.unpack("<I", data[-8:-4])
    start = len(data) - 8 - n
    if start < 4:
        raise ParquetError("footer length runs past the file")
    return _ThriftReader(data, start).struct()


class _Leaf(NamedTuple):
    """One column of the schema: its name, physical type, and levels.
    ``max_rep`` is 1 for a LIST column; ``empty_def`` is the definition
    level of an empty list (a lower one is a null row), ``max_def`` that
    of a present value."""

    name: str
    ptype: int
    max_rep: int
    max_def: int
    empty_def: int = 0


def _check_physical(name: str, ptype: int, allowed) -> None:
    if ptype not in allowed:
        raise ParquetError(f"column '{name}' has physical type "
                           f"{TYPE_NAMES.get(ptype, ptype)}; not supported")


def _list_leaf(outer: dict, schema: list, at: int) -> tuple[_Leaf, int]:
    """The three-level LIST group at ``schema[at]`` (``outer``); refuses
    any other nested shape by name."""
    name = outer[4].decode()
    shape = f"column '{name}' is a nested group"
    is_list = outer.get(6) == LIST or 3 in (outer.get(10) or {})
    if not is_list or outer.get(5) != 1 or at + 2 >= len(schema):
        raise ParquetError(f"{shape} other than a LIST; only flat and LIST columns are "
                           "supported")
    middle, leaf = schema[at + 1], schema[at + 2]
    if middle.get(3) != REPEATED or middle.get(5) != 1 or leaf.get(5):
        raise ParquetError(f"{shape}: only a three-level LIST of one primitive element is "
                           "supported")
    element = leaf[4].decode()
    if element not in LIST_ELEMENT_NAMES:
        raise ParquetError(f"column '{name}': LIST element '{element}' is not one of "
                           f"{LIST_ELEMENT_NAMES}")
    if leaf.get(3, REQUIRED) == REPEATED:
        raise ParquetError(f"column '{name}': a REPEATED LIST element is not supported")
    _check_physical(name, leaf.get(1), (INT64, DOUBLE))
    empty_def = 1 if outer.get(3, REQUIRED) == OPTIONAL else 0
    max_def = empty_def + 1 + (1 if leaf.get(3, REQUIRED) == OPTIONAL else 0)
    return _Leaf(name, leaf[1], 1, max_def, empty_def), at + 3


def _leaves(meta: dict) -> list[_Leaf]:
    """The columns of a schema of flat columns and three-level LISTs; any
    other nested or repeated shape raises."""
    schema = meta.get(2) or []
    if not schema:
        raise ParquetError("file has no schema")
    root = schema[0]
    out = []
    at = 1
    while at < len(schema):
        el = schema[at]
        name = el[4].decode()
        if el.get(5):
            leaf, at = _list_leaf(el, schema, at)
            out.append(leaf)
            continue
        rep = el.get(3, REQUIRED)
        if rep == REPEATED:
            raise ParquetError(f"column '{name}' is REPEATED; not supported")
        _check_physical(name, el.get(1), (INT32, INT64, FLOAT, DOUBLE, BYTE_ARRAY))
        out.append(_Leaf(name, el[1], 0, 1 if rep == OPTIONAL else 0))
        at += 1
    if root.get(5, 0) != len(out):
        raise ParquetError("nested schema: the root's children are not flat or LIST columns")
    return out


def _levels(page, at: int, max_level: int, count: int) -> tuple[np.ndarray, int]:
    """``count`` levels of width ``max_level.bit_length()`` at ``page[at:]``
    (a 4-byte length, then the hybrid) and the offset after them."""
    (n,) = struct.unpack_from("<I", page, at)
    return _rle_decode(page, at + 4, at + 4 + n, max_level.bit_length(), count), at + 4 + n


def _assemble_lists(leaf: _Leaf, rep: np.ndarray, dfn: np.ndarray,
                    values: np.ndarray) -> np.ndarray:
    """Rows of a LIST column from its levels: an array per row (null
    elements NaN), None for a null row."""
    n_rows = int((rep == 0).sum())
    out = np.empty(n_rows, object)
    starts = np.flatnonzero(rep == 0)
    ends = np.append(starts[1:], len(rep))
    has_value = dfn == leaf.max_def
    value_at = np.cumsum(has_value) - 1
    dtype = np.float64 if leaf.ptype == DOUBLE else np.int64
    for i, (s, e) in enumerate(zip(starts.tolist(), ends.tolist())):
        d = dfn[s:e]
        if d[0] < leaf.empty_def:
            out[i] = None
        elif d[0] == leaf.empty_def:
            out[i] = np.zeros(0, dtype)
        else:
            present = has_value[s:e]
            if present.all():
                out[i] = values[value_at[s]:value_at[e - 1] + 1].astype(dtype)
            else:
                row = np.full(e - s, np.nan)
                row[present] = values[value_at[s:e][present]]
                out[i] = row
    return out


def _read_chunk(data: bytes, leaf: _Leaf, chunk: dict) -> np.ndarray:
    """One column chunk's values, nulls as NaN (or None for strings and
    null LIST rows)."""
    name, ptype = leaf.name, leaf.ptype
    if chunk.get(1):
        raise ParquetError(f"column '{name}' lives in another file ({chunk[1]!r})")
    cm = chunk[3]
    codec = cm.get(4, UNCOMPRESSED)
    if codec not in (UNCOMPRESSED, SNAPPY):
        raise ParquetError(f"column '{name}': codec {CODEC_NAMES.get(codec, codec)} "
                           "is not supported")
    n_total = cm[5]
    pos = cm[11] if cm.get(11) is not None else cm[9]
    dictionary = None
    values_parts, levels_parts, rep_parts = [], [], []
    seen = 0
    while seen < n_total:
        rd = _ThriftReader(data, pos)
        header = rd.struct()
        pos = rd.pos
        kind, raw_size, size = header[1], header[2], header[3]
        page = data[pos:pos + size]
        pos += size
        if kind not in (DATA_PAGE, DICTIONARY_PAGE):
            raise ParquetError(f"column '{name}': page type {PAGE_NAMES.get(kind, kind)} "
                               "is not supported")
        if codec == SNAPPY:
            page = snappy.decompress(page)
        if len(page) != raw_size:
            raise ParquetError(f"column '{name}': page is {len(page)} bytes, "
                               f"header says {raw_size}")
        if kind == DICTIONARY_PAGE:
            dh = header[7]
            if dh.get(2, PLAIN) not in (PLAIN, PLAIN_DICTIONARY):
                raise ParquetError(f"column '{name}': dictionary encoding "
                                   f"{ENCODING_NAMES.get(dh[2], dh[2])} is not supported")
            dictionary = _plain_decode(ptype, page, 0, len(page), dh[1])
            continue
        dph = header[5]
        count, encoding = dph[1], dph[2]
        at = 0
        for field, used, what in ((4, leaf.max_rep, "repetition"),
                                  (3, leaf.max_def, "definition")):
            if used and dph.get(field, RLE) != RLE:
                raise ParquetError(f"column '{name}': {what} levels in "
                                   f"{ENCODING_NAMES.get(dph[field], dph[field])} are not "
                                   "supported")
        if leaf.max_rep:
            rep, at = _levels(page, at, leaf.max_rep, count)
            rep_parts.append(rep)
        if leaf.max_def:
            dfn, at = _levels(page, at, leaf.max_def, count)
        else:
            dfn = np.zeros(count, np.int64)
        n_present = int((dfn == leaf.max_def).sum())
        if encoding == PLAIN:
            vals = _plain_decode(ptype, page, at, len(page), n_present)
        elif encoding in (RLE_DICTIONARY, PLAIN_DICTIONARY):
            if dictionary is None:
                raise ParquetError(f"column '{name}': dictionary-encoded page without "
                                   "a dictionary page")
            width = page[at] if n_present else 0
            idx = _rle_decode(page, at + 1, len(page), width, n_present)
            if n_present and (idx.max() >= len(dictionary)):
                raise ParquetError(f"column '{name}': dictionary index out of range")
            vals = dictionary[idx]
        else:
            raise ParquetError(f"column '{name}': encoding "
                               f"{ENCODING_NAMES.get(encoding, encoding)} is not supported")
        values_parts.append(vals)
        levels_parts.append(dfn)
        seen += count
    dfn = np.concatenate(levels_parts) if levels_parts else np.zeros(0, np.int64)
    if leaf.max_rep:
        values = (np.concatenate(values_parts) if values_parts else np.zeros(0))
        return _assemble_lists(leaf, np.concatenate(rep_parts) if rep_parts
                               else np.zeros(0, np.int64), dfn, values)
    levels = dfn == leaf.max_def
    if ptype == BYTE_ARRAY:
        values = (np.concatenate(values_parts) if values_parts
                  else np.zeros(0, "<U1"))
        if not levels.all():
            full = np.full(len(levels), None, object)
            full[levels] = values
            return full
        return values
    dtype = _NUMERIC[ptype].newbyteorder("=")
    values = np.concatenate(values_parts).astype(dtype) if values_parts else np.zeros(0, dtype)
    if levels.all():
        return values
    full = np.full(len(levels), np.nan, np.float32 if ptype == FLOAT else np.float64)
    full[levels] = values
    return full


def read_table(path, columns: Sequence[str] | None = None) -> dict[str, np.ndarray]:
    """The file's columns (``columns``: a subset, in file order) as 1-D
    numpy arrays: int32, int64, float32, float64, str, or (LIST columns) object arrays of
    arrays; every row group concatenated."""
    path = Path(path)
    data = path.read_bytes()
    try:
        meta = read_metadata(data)
        leaves = _leaves(meta)
    except ParquetError as e:
        raise ParquetError(f"{path.name}: {e}") from None
    wanted = None if columns is None else set(columns)
    if wanted is not None:
        missing = wanted - {leaf.name for leaf in leaves}
        if missing:
            raise ParquetError(f"{path.name}: no column(s) {sorted(missing)}")
    parts: dict[str, list[np.ndarray]] = {leaf.name: [] for leaf in leaves
                                          if wanted is None or leaf.name in wanted}
    for rg in meta.get(4) or []:
        chunks = rg[1]
        if len(chunks) != len(leaves):
            raise ParquetError(f"{path.name}: row group has {len(chunks)} columns, "
                               f"schema {len(leaves)}")
        for leaf, chunk in zip(leaves, chunks):
            if leaf.name in parts:
                try:
                    parts[leaf.name].append(_read_chunk(data, leaf, chunk))
                except ParquetError as e:
                    raise ParquetError(f"{path.name}: {e}") from None
    empty = {INT32: np.int32, INT64: np.int64, FLOAT: np.float32, DOUBLE: np.float64,
             BYTE_ARRAY: "<U1"}
    # chunks with nulls come back float64 (integers) or object (strings)
    return {leaf.name: np.concatenate(parts[leaf.name]) if parts[leaf.name]
            else np.zeros(0, object if leaf.max_rep else empty[leaf.ptype])
            for leaf in leaves if leaf.name in parts}
