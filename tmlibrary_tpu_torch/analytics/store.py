"""Columnar feature store: one memory-mapped matrix per object type.

Counterpart: ``tmlibrary_tpu/analytics/store.py``.  A jterator run
persists per-object features as per-site Parquet shards
(``<experiment>/features/<objects_name>/*.parquet``); the store ingests
them once into ``<experiment>/analytics/<objects_name>/``::

    matrix.npy      (N objects, F features) float32, memory-mapped
    index.parquet   object identity: site_index, label, plate,
                    well_row, well_col (+ site_y/site_x and the
                    Morphology centroids, renamed centroid_y/x)
    meta.json       feature names, shapes, the content digest, the
                    source-shard digest and the per-shard ingest ledger

The layout, the digests and the ``ensure`` classification (unchanged /
grown / rewritten) are the reference's, so the two packages key their
query caches and indexes alike: ``digest`` is a chain over the sorted
shards (``sha256(state | shard name | sha256(float32 rows + identity
rows))``, seeded with the feature names) and ``source_digest`` the same
chain over the shard files' sha256; both equal the reference's byte for
byte on the same shards.

pandas is not used.  A table is a dict of 1-D numpy arrays in column
order (:func:`concat_tables` is pandas' ``concat``: the union of the
shards' columns in order of appearance, a column missing from a shard
filled with NaN, integers then promoted to float64 and strings held as
objects), read with :func:`~tmlibrary_tpu_torch.io.parquet.read_table`;
the identity is written with
:func:`~tmlibrary_tpu_torch.io.parquet.write_table`.
"""

from __future__ import annotations

import hashlib
import json
import struct
import time
from pathlib import Path
from typing import TYPE_CHECKING, Mapping

import numpy as np

from tmlibrary_tpu_torch.atomicio import atomic_write_text
from tmlibrary_tpu_torch.errors import RegistryError, StoreError
from tmlibrary_tpu_torch.io import parquet

if TYPE_CHECKING:  # pragma: no cover
    from tmlibrary_tpu_torch.models.store import ExperimentStore

#: identity columns copied into index.parquet when present (in order)
ID_COLUMNS = ("site_index", "label", "plate", "well_row", "well_col",
              "site_y", "site_x",
              "Morphology_centroid_y", "Morphology_centroid_x")

#: columns never ingested into the feature matrix
NON_FEATURE_COLUMNS = ("site_index", "label", "plate", "well_row",
                       "well_col", "site_y", "site_x")

#: the identity every ``ToolResult.values`` is built on
IDENTITY = ("site_index", "label", "plate", "well_row", "well_col")

SCHEMA_VERSION = 2

_RENAME = {
    "Morphology_centroid_y": "centroid_y",
    "Morphology_centroid_x": "centroid_x",
}


# ------------------------------------------------------------------ tables
def _as_column(values) -> np.ndarray:
    """A table column: numeric arrays as they are, strings as objects
    (what pandas holds them as)."""
    arr = np.asarray(values)
    if arr.dtype.kind in "US":
        return arr.astype(object)
    return arr


def concat_tables(tables: list[Mapping[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """``pd.concat(tables, ignore_index=True)`` on dicts of columns: the
    union of the columns in order of first appearance; where a table
    lacks a column its rows are NaN, which turns integers and booleans
    into float64 and leaves strings objects."""
    names: list[str] = []
    for t in tables:
        names.extend(c for c in t if c not in names)
    lengths = [len(next(iter(t.values()))) if t else 0 for t in tables]
    out = {}
    for name in names:
        parts = [_as_column(t[name]) if name in t else None for t in tables]
        present = [p for p in parts if p is not None]
        if any(p.dtype == object for p in present):
            kind = object
        else:
            kind = np.result_type(*present)
        if len(present) < len(parts) and np.dtype(kind).kind in "iub":
            kind = np.float64
        filled = [p.astype(kind) if p is not None else np.full(n, np.nan, kind)
                  for p, n in zip(parts, lengths)]
        out[name] = np.concatenate(filled) if filled else np.zeros(0, kind)
    return out


def take_rows(table: Mapping[str, np.ndarray], rows) -> dict[str, np.ndarray]:
    """The table's rows ``rows`` (a slice, index array or mask)."""
    return {k: v[rows] for k, v in table.items()}


def n_rows(table: Mapping[str, np.ndarray]) -> int:
    return len(next(iter(table.values()))) if table else 0


# ------------------------------------------------------------------ digests
def analytics_dir(store: "ExperimentStore", objects_name: str) -> Path:
    """Where one object type's feature-store artifacts live."""
    return Path(store.root) / "analytics" / objects_name


def _shard_paths(store: "ExperimentStore", objects_name: str) -> list[Path]:
    shards = sorted(store.features_dir(objects_name).glob("*.parquet"))
    if not shards:
        raise StoreError(f"no feature shards for '{objects_name}'")
    return shards


def _chain(state: str, shard_name: str, chunk_hex: str) -> str:
    """One link of a shard digest chain (content or source)."""
    return hashlib.sha256(f"{state}|{shard_name}|{chunk_hex}".encode()).hexdigest()


def _content_seed(features: list[str]) -> str:
    """Chain seed: the feature names in matrix column order."""
    return hashlib.sha256(json.dumps(features).encode()).hexdigest()


def _source_seed() -> str:
    return hashlib.sha256(b"tmx-feature-source-v2").hexdigest()


def _rows_digest(matrix_rows: np.ndarray, index_rows: Mapping[str, np.ndarray]) -> str:
    """sha256 over one shard's observable content: its float32 matrix
    rows plus its identity rows (column name + raw values, object
    columns via a stable JSON string form)."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(matrix_rows, np.float32).tobytes())
    for col, vals in index_rows.items():
        h.update(col.encode())
        if vals.dtype == object:
            h.update(json.dumps([str(v) for v in vals.tolist()]).encode())
        else:
            h.update(np.ascontiguousarray(vals).tobytes())
    return h.hexdigest()


def _file_sha(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def _shard_record(path: Path, rows: int, sha: str) -> dict:
    st = path.stat()
    return {"name": path.name, "rows": int(rows), "sha": sha, "size": int(st.st_size),
            "mtime_ns": int(st.st_mtime_ns)}


def _shard_unchanged(path: Path, rec: dict) -> bool:
    """The (size, mtime) stat fast path, else the recorded file sha."""
    try:
        st = path.stat()
    except OSError:
        return False
    if (int(st.st_size) == int(rec.get("size", -1))
            and int(st.st_mtime_ns) == int(rec.get("mtime_ns", -1))):
        return True
    return _file_sha(path) == rec.get("sha")


# ------------------------------------------------------- npy row append
def _npy_header_bytes(shape: tuple, dtype: np.dtype, version: tuple,
                      total_len: int) -> bytes | None:
    """A v1/v2 .npy header for ``shape`` padded to exactly ``total_len``
    bytes, or None when it cannot fit."""
    descr = np.lib.format.dtype_to_descr(np.dtype(dtype))
    body = ("{'descr': %r, 'fortran_order': False, 'shape': %r, }"
            % (descr, tuple(int(s) for s in shape))).encode("latin1")
    magic = b"\x93NUMPY" + bytes(bytearray(version))
    size_len = 2 if version == (1, 0) else 4
    payload_len = total_len - len(magic) - size_len
    if len(body) + 1 > payload_len or payload_len < 0:
        return None
    body = body + b" " * (payload_len - len(body) - 1) + b"\n"
    size = (struct.pack("<H", payload_len) if size_len == 2
            else struct.pack("<I", payload_len))
    return magic + size + body


def _append_npy_rows(path: Path, rows: np.ndarray) -> None:
    """Append C-order rows to an existing ``.npy`` in place (new bytes at
    the end, the header patched for the new shape); when the header
    cannot hold the longer shape string the matrix is rewritten from its
    own memmap."""
    rows = np.ascontiguousarray(rows)
    with open(path, "r+b") as f:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        else:
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        if fortran:
            raise StoreError("matrix.npy is Fortran-ordered; cannot append")
        if np.dtype(dtype) != rows.dtype or shape[1:] != rows.shape[1:]:
            raise StoreError(f"matrix layout mismatch on append: have {shape} "
                             f"{np.dtype(dtype)}, appending {rows.shape} {rows.dtype}")
        data_start = f.tell()
        new_shape = (int(shape[0]) + int(rows.shape[0]),) + tuple(shape[1:])
        header = _npy_header_bytes(new_shape, dtype, version, data_start)
        if header is not None:
            f.seek(0, 2)
            f.write(rows.tobytes())
            f.seek(0)
            f.write(header)
            return
    old = np.load(path, mmap_mode="r")
    merged = np.concatenate([np.asarray(old), rows], axis=0)
    del old
    np.save(path, merged)


def _feature_columns(table: Mapping[str, np.ndarray]) -> list[str]:
    return [c for c, v in table.items()
            if c not in NON_FEATURE_COLUMNS and np.issubdtype(v.dtype, np.number)]


def _extract(table: Mapping[str, np.ndarray], feat_cols: list[str]
             ) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """(float32 C-order matrix, renamed identity table) of one table: the
    one definition the full build and the append path share."""
    n = n_rows(table)
    matrix = np.empty((n, len(feat_cols)), np.float32)
    for j, c in enumerate(feat_cols):
        matrix[:, j] = table[c]
    index = {_RENAME.get(c, c): table[c].copy() for c in ID_COLUMNS if c in table}
    return matrix, index


def _read_shard(path: Path) -> dict[str, np.ndarray]:
    return {k: _as_column(v) for k, v in parquet.read_table(path).items()}


def _write_meta(root: Path, meta: dict) -> None:
    atomic_write_text(root / "meta.json", json.dumps(meta, indent=2, sort_keys=True,
                                                     default=str))


class FeatureStore:
    """The built artifact: open with :meth:`ensure` (builds, appends or
    reuses)."""

    def __init__(self, root: Path, meta: dict):
        self.root = Path(root)
        self.meta = meta
        self._matrix: np.ndarray | None = None
        self._index: dict[str, np.ndarray] | None = None

    # ------------------------------------------------------------ build
    @classmethod
    def build(cls, store: "ExperimentStore", objects_name: str,
              source_digest: str | None = None) -> "FeatureStore":
        """Full ingest of every shard (``source_digest`` is accepted for
        the reference's signature and ignored)."""
        shard_paths = _shard_paths(store, objects_name)
        tables = [_read_shard(p) for p in shard_paths]
        table = concat_tables(tables)
        feat_cols = _feature_columns(table)
        matrix, index = _extract(table, feat_cols)
        state = _content_seed(feat_cols)
        src = _source_seed()
        shards = []
        lo = 0
        for p, t in zip(shard_paths, tables):
            hi = lo + n_rows(t)
            state = _chain(state, p.name,
                           _rows_digest(matrix[lo:hi], take_rows(index, slice(lo, hi))))
            sha = _file_sha(p)
            src = _chain(src, p.name, sha)
            shards.append(_shard_record(p, hi - lo, sha))
            lo = hi
        root = analytics_dir(store, objects_name)
        root.mkdir(parents=True, exist_ok=True)
        np.save(root / "matrix.npy", matrix)
        parquet.write_table(root / "index.parquet", index)
        meta = {
            "schema_version": SCHEMA_VERSION,
            "objects_name": objects_name,
            "features": feat_cols,
            "columns": list(table),
            "n_objects": int(matrix.shape[0]),
            "n_features": int(matrix.shape[1]),
            "digest": state,
            "source_digest": src,
            "shards": shards,
            "build_kind": "full",
            "built_at": time.time(),
        }
        _write_meta(root, meta)
        return cls(root, meta)

    # ----------------------------------------------------------- append
    @classmethod
    def append(cls, store: "ExperimentStore", objects_name: str,
               meta: dict, new_paths: list[Path]) -> "FeatureStore":
        """Fold ``new_paths`` (sorted, all after the last ingested shard)
        into the existing artifacts, reading only them; both digest chains
        roll forward to exactly the rebuild's values.  A new shard whose
        schema differs raises :class:`StoreError` (the caller rebuilds)."""
        feat_cols = list(meta["features"])
        root = analytics_dir(store, objects_name)
        state, src = meta["digest"], meta["source_digest"]
        shards = list(meta["shards"])
        mats, frames = [], []
        for p in new_paths:
            t = _read_shard(p)
            if _feature_columns(t) != feat_cols or list(t) != meta["columns"]:
                raise StoreError(f"shard {p.name} schema differs from store "
                                 "(append needs identical columns)")
            m, idx = _extract(t, feat_cols)
            state = _chain(state, p.name, _rows_digest(m, idx))
            sha = _file_sha(p)
            src = _chain(src, p.name, sha)
            shards.append(_shard_record(p, n_rows(t), sha))
            mats.append(m)
            frames.append(idx)
        new_matrix = (np.concatenate(mats, axis=0) if mats
                      else np.zeros((0, len(feat_cols)), np.float32))
        _append_npy_rows(root / "matrix.npy", new_matrix)
        old = {k: _as_column(v) for k, v in parquet.read_table(root / "index.parquet").items()}
        parquet.write_table(root / "index.parquet", concat_tables([old, *frames]))
        meta = dict(meta)
        meta.update({
            "n_objects": int(meta["n_objects"]) + int(new_matrix.shape[0]),
            "digest": state,
            "source_digest": src,
            "shards": shards,
            "build_kind": "append",
            "appended_rows": int(new_matrix.shape[0]),
            "appended_shards": [p.name for p in new_paths],
            "built_at": time.time(),
        })
        _write_meta(root, meta)
        return cls(root, meta)

    @classmethod
    def ensure(cls, store: "ExperimentStore", objects_name: str,
               rebuild: bool = False) -> "FeatureStore":
        """Open the store, appending or rebuilding when stale: unchanged
        shards reuse it, a grown tail is appended, anything else (removed,
        rewritten or out-of-order shards, another schema version, corrupt
        artifacts) rebuilds."""
        root = analytics_dir(store, objects_name)
        meta_path = root / "meta.json"
        shard_paths = _shard_paths(store, objects_name)
        if not rebuild and meta_path.exists():
            try:
                meta = json.loads(meta_path.read_text())
                if (meta.get("schema_version") == SCHEMA_VERSION
                        and isinstance(meta.get("shards"), list)
                        and (root / "matrix.npy").exists()
                        and (root / "index.parquet").exists()):
                    recorded = meta["shards"]
                    by_name = {p.name: p for p in shard_paths}
                    names = [p.name for p in shard_paths]
                    rec_names = [r["name"] for r in recorded]
                    if (names[: len(rec_names)] == rec_names
                            and all(_shard_unchanged(by_name[r["name"]], r)
                                    for r in recorded)):
                        new_paths = shard_paths[len(rec_names):]
                        if not new_paths:
                            return cls(root, meta)
                        try:
                            return cls.append(store, objects_name, meta, new_paths)
                        except StoreError:
                            pass  # schema drift: rebuild
            except (OSError, ValueError, KeyError, TypeError):
                pass  # corrupt meta or artifacts: rebuild
        return cls.build(store, objects_name)

    @classmethod
    def open(cls, root: Path) -> "FeatureStore":
        root = Path(root)
        meta_path = root / "meta.json"
        if not meta_path.exists():
            raise StoreError(f"no feature store at {root}")
        return cls(root, json.loads(meta_path.read_text()))

    # ------------------------------------------------------------- views
    @property
    def digest(self) -> str:
        return self.meta["digest"]

    @property
    def features(self) -> list[str]:
        return list(self.meta["features"])

    @property
    def n_objects(self) -> int:
        return int(self.meta["n_objects"])

    def matrix(self) -> np.ndarray:
        """The raw (N, F) float32 matrix, memory-mapped read-only."""
        if self._matrix is None:
            self._matrix = np.load(self.root / "matrix.npy", mmap_mode="r")
        return self._matrix

    def index(self) -> dict[str, np.ndarray]:
        if self._index is None:
            self._index = {k: _as_column(v) for k, v in
                           parquet.read_table(self.root / "index.parquet").items()}
        return self._index

    def identity(self) -> dict[str, np.ndarray]:
        """A copy of the (site_index, label, plate, well_row, well_col)
        columns every ``ToolResult.values`` is built on."""
        idx = self.index()
        return {c: idx[c].copy() for c in IDENTITY}

    def column(self, feature: str) -> np.ndarray:
        """One raw feature column (float32 copy)."""
        try:
            j = self.features.index(feature)
        except ValueError:
            raise RegistryError(f"feature '{feature}' not in store "
                                f"(have: {sorted(self.features)})") from None
        return np.asarray(self.matrix()[:, j])

    def select(self, features: list[str] | None = None) -> tuple[np.ndarray, list[str]]:
        """(raw float32 matrix restricted to ``features``, names); the
        whole memmap when ``features`` is None."""
        if not features:
            return self.matrix(), self.features
        pos = {f: j for j, f in enumerate(self.features)}
        missing = [f for f in features if f not in pos]
        if missing:
            have = sorted(c for c in self.meta["columns"] if c not in ("site_index", "label"))
            raise RegistryError(f"features not found for '{self.meta['objects_name']}': "
                                f"{missing} (have: {have})")
        return (np.ascontiguousarray(self.matrix()[:, [pos[f] for f in features]]),
                list(features))

    def standardized(self, features: list[str] | None = None
                     ) -> tuple[dict[str, np.ndarray], np.ndarray, list[str]]:
        """(identity, z-scored (N, F) float32 matrix, names): NaN and inf
        cells take the column's finite mean before the mean and standard
        deviation, as the reference's ``Tool.load_feature_matrix``."""
        x, feat_cols = self.select(features)
        x = np.array(x, np.float32, copy=True)
        finite = np.isfinite(x)
        if not finite.all():
            with np.errstate(invalid="ignore"):
                fill = np.nanmean(np.where(finite, x, np.nan), axis=0)
            fill = np.nan_to_num(fill, nan=0.0, posinf=0.0, neginf=0.0)
            x = np.where(finite, x, fill[None, :]).astype(np.float32)
        mu = x.mean(axis=0, keepdims=True)
        sd = x.std(axis=0, keepdims=True)
        x = (x - mu) / np.where(sd > 1e-9, sd, 1.0)
        return self.identity(), x, feat_cols

    def centroids(self) -> np.ndarray:
        """(N, 2) float32 object positions: the Morphology centroids when
        measured, else the site grid position (site_y, site_x)."""
        idx = self.index()
        for y, x in (("centroid_y", "centroid_x"), ("site_y", "site_x")):
            if y in idx and x in idx:
                return np.stack([idx[y], idx[x]], axis=1).astype(np.float32)
        raise StoreError("feature store has neither Morphology centroids nor a "
                         "site_y/site_x layout — spatial queries need object positions")
