"""OME-NGFF (OME-Zarr v0.4) plate export and import.

Counterpart: ``tmlibrary_tpu/ngff.py``, with the same files byte for
byte: the subset of Zarr v2 the NGFF layout needs (C-order chunked
arrays with ``.zarray`` JSON headers, zlib or raw chunks, dot-separated
chunk keys) and the NGFF 0.4 HCS metadata, on numpy, ``zlib`` and
``json`` alone.  :func:`write_ngff_plate` is the road out of a store
(``tmx-torch export --ngff``), :class:`NGFFReader` and the ``ngff``
metaconfig handler the road back in.

Layout written (one plate)::

    plate.zarr/
      .zgroup                      {"zarr_format": 2}
      .zattrs                      {"plate": {rows, columns, wells, ...}}
      A/1/.zgroup  .zattrs         {"well": {"images": [{"path": "0"}, ...]}}
      A/1/0/.zgroup .zattrs        {"multiscales": [...], "omero": {...}}
      A/1/0/0/.zarray  0.0.0.0.0   level-0 (t, c, z, y, x) chunks
      A/1/0/1/...                  2x-downsampled levels
      A/1/0/labels/<name>/...      optional image-label multiscales
"""

from __future__ import annotations

import json
import zlib
from pathlib import Path

import numpy as np

from tmlibrary_tpu_torch.errors import MetadataError

NGFF_VERSION = "0.4"
_AXES = [
    {"name": "t", "type": "time"},
    {"name": "c", "type": "channel"},
    {"name": "z", "type": "space"},
    {"name": "y", "type": "space"},
    {"name": "x", "type": "space"},
]


# ------------------------------------------------------------ zarr v2 arrays
def _dtype_str(dtype: np.dtype) -> str:
    dtype = np.dtype(dtype)
    if dtype.itemsize == 1:
        return "|" + dtype.str[1:]
    return "<" + dtype.str[1:]  # little-endian on disk


def zarr_write_array(
    path: Path,
    arr: np.ndarray,
    chunks: tuple[int, ...],
    compressor: str | None = "zlib",
    level: int = 1,
) -> None:
    """Write ``arr`` as a Zarr v2 array directory (C order, fill 0,
    dot-separated chunk keys).  Edge chunks are stored full-size padded
    with the fill value, exactly as the spec requires."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    chunks = tuple(int(min(c, s)) if s else int(c)
                   for c, s in zip(chunks, arr.shape))
    meta = {
        "zarr_format": 2,
        "shape": list(arr.shape),
        "chunks": list(chunks),
        "dtype": _dtype_str(arr.dtype),
        "compressor": (
            {"id": "zlib", "level": int(level)} if compressor == "zlib"
            else None
        ),
        "fill_value": 0,
        "order": "C",
        "filters": None,
        "dimension_separator": ".",
    }
    (path / ".zarray").write_text(json.dumps(meta, indent=2))
    arr = np.ascontiguousarray(arr, dtype=np.dtype(meta["dtype"]))
    grid = [range(0, s, c) for s, c in zip(arr.shape, chunks)]
    from itertools import product

    for origin in product(*grid):
        sel = tuple(
            slice(o, min(o + c, s))
            for o, c, s in zip(origin, chunks, arr.shape)
        )
        block = arr[sel]
        if block.shape != chunks:  # edge chunk: pad to full chunk shape
            full = np.zeros(chunks, arr.dtype)
            full[tuple(slice(0, e) for e in block.shape)] = block
            block = full
        raw = np.ascontiguousarray(block).tobytes()
        if compressor == "zlib":
            raw = zlib.compress(raw, int(level))
        key = ".".join(str(o // c) for o, c in zip(origin, chunks))
        (path / key).write_bytes(raw)


def _zarray_meta(path: Path) -> dict:
    try:
        meta = json.loads((Path(path) / ".zarray").read_text())
    except (OSError, ValueError) as exc:
        raise MetadataError(f"not a zarr array: {path}: {exc}") from exc
    # validate structure HERE so every consumer can index freely: a
    # corrupted document would otherwise leak KeyError/TypeError past
    # the ingest skip-unreadable contract (fuzz-caught)
    try:
        shape = [int(x) for x in meta["shape"]]
        chunks = [int(x) for x in meta["chunks"]]
        np.dtype(meta["dtype"])
    except (KeyError, TypeError, ValueError) as exc:
        raise MetadataError(f"corrupt zarr metadata at {path}: {exc}") from exc
    total = 1
    for s in shape:
        total *= max(s, 1)
    chunk_elems = 1
    for c in chunks:
        chunk_elems *= max(c, 1)
    # magnitude sanity (generous: 2G elements total, 128M per chunk): a
    # corrupt/malicious document declaring absurd dims would otherwise
    # reach np.zeros(shape) and leak ValueError/MemoryError — or OOM —
    # past the skip-unreadable contract
    if (len(shape) != len(chunks) or not chunks
            or any(c < 1 for c in chunks) or any(s < 0 for s in shape)
            or total > (1 << 31) or chunk_elems > (1 << 27)):
        raise MetadataError(f"nonsensical zarr shape/chunks at {path}")
    comp = meta.get("compressor")
    if comp is not None and not isinstance(comp, dict):
        raise MetadataError(f"corrupt zarr compressor entry at {path}")
    meta["shape"], meta["chunks"] = shape, chunks
    meta["dimension_separator"] = str(meta.get("dimension_separator", "."))
    return meta


def _read_chunk(path: Path, meta: dict, idx: tuple[int, ...]) -> np.ndarray:
    chunks = meta["chunks"]
    dtype = np.dtype(meta["dtype"])
    sep = meta["dimension_separator"]
    key = sep.join(str(i) for i in idx)
    f = Path(path) / key
    if not f.exists():
        try:
            return np.full(chunks, meta.get("fill_value") or 0, dtype)
        except (TypeError, ValueError) as exc:  # corrupt fill_value
            raise MetadataError(
                f"corrupt zarr fill_value at {path}: {exc}"
            ) from exc
    raw = f.read_bytes()
    comp = meta.get("compressor")
    if comp is not None:
        if comp.get("id") != "zlib":
            raise MetadataError(
                f"unsupported zarr compressor {comp.get('id')!r} "
                f"(first-party reader handles zlib/raw)"
            )
        try:
            raw = zlib.decompress(raw)
        except zlib.error as exc:
            raise MetadataError(
                f"corrupt zarr chunk {key} at {path}: {exc}"
            ) from exc
    if meta.get("filters"):
        raise MetadataError("zarr filters are not supported")
    order = meta.get("order", "C")
    try:
        return np.frombuffer(raw, dtype).reshape(chunks, order=order)
    except (ValueError, TypeError) as exc:  # wrong byte count / order
        raise MetadataError(
            f"corrupt zarr chunk {key} at {path}: {exc}"
        ) from exc


def zarr_read_array(path: Path) -> np.ndarray:
    """Read a whole Zarr v2 array directory into memory."""
    meta = _zarray_meta(path)
    shape, chunks = meta["shape"], meta["chunks"]
    out = np.zeros(shape, np.dtype(meta["dtype"]))
    from itertools import product

    grid = [range((s + c - 1) // c) for s, c in zip(shape, chunks)]
    for idx in product(*grid):
        block = _read_chunk(path, meta, idx)
        sel = tuple(
            slice(i * c, min((i + 1) * c, s))
            for i, c, s in zip(idx, chunks, shape)
        )
        out[sel] = block[tuple(slice(0, sl.stop - sl.start) for sl in sel)]
    return out


def zarr_read_plane(path: Path, t: int, c: int, z: int) -> np.ndarray:
    """One (y, x) plane of a 5-D (t, c, z, y, x) Zarr array, touching
    only the chunks that intersect it."""
    meta = _zarray_meta(path)
    shape, chunks = meta["shape"], meta["chunks"]
    if len(shape) != 5:
        raise MetadataError(f"expected a 5-D tczyx array at {path}")
    h, w = shape[3], shape[4]
    out = np.zeros((h, w), np.dtype(meta["dtype"]))
    ci = (t // chunks[0], c // chunks[1], z // chunks[2])
    off = (t % chunks[0], c % chunks[1], z % chunks[2])
    for yi in range((h + chunks[3] - 1) // chunks[3]):
        for xi in range((w + chunks[4] - 1) // chunks[4]):
            block = _read_chunk(path, meta, (*ci, yi, xi))
            y0, x0 = yi * chunks[3], xi * chunks[4]
            ye, xe = min(y0 + chunks[3], h), min(x0 + chunks[4], w)
            out[y0:ye, x0:xe] = block[off][: ye - y0, : xe - x0]
    return out


# ----------------------------------------------------------- plate metadata
def _well_name(row: int, col: int) -> tuple[str, str]:
    return chr(ord("A") + row), str(col + 1)


def _downsample_2x(plane: np.ndarray) -> np.ndarray:
    """2x2 mean pool (display levels); odd edges are cropped, matching
    the zoomify convention of ops/pyramid."""
    h, w = plane.shape
    he, we = h - h % 2, w - w % 2
    pooled = plane[:he, :we].reshape(he // 2, 2, we // 2, 2).mean((1, 3))
    if np.issubdtype(plane.dtype, np.integer):
        pooled = np.round(pooled)
    return pooled.astype(plane.dtype)


def _write_label_image(
    field_dir: Path,
    name: str,
    stack: np.ndarray,
    n_levels: int,
    chunk_yx: int,
    compressor: str | None,
) -> None:
    """One NGFF 0.4 ``image-label`` under ``<field>/labels/<name>``:
    a 5-D (t, 1, z, y, x) int32 multiscale whose display levels use
    nearest subsampling (mean-pooling label ids would invent objects).
    The ``labels/`` group listing is written by the caller — one listing
    per export run, so names from a previous export into the same
    directory are never advertised."""
    img_dir = field_dir / "labels" / name
    img_dir.mkdir(parents=True, exist_ok=True)
    (img_dir / ".zgroup").write_text(json.dumps({"zarr_format": 2}))
    datasets = []
    level = stack
    for lvl in range(n_levels):
        if lvl:
            # crop odd edges BEFORE subsampling — the exact level shapes
            # of the image pyramid's _downsample_2x, so viewers that pair
            # multiscale levels by index see aligned overlays
            h, w = level.shape[3], level.shape[4]
            level = level[:, :, :, : h - h % 2 : 2, : w - w % 2 : 2]
            if level.shape[3] < 1 or level.shape[4] < 1:
                break
        zarr_write_array(
            img_dir / str(lvl), level, (1, 1, 1, chunk_yx, chunk_yx),
            compressor,
        )
        datasets.append({
            "path": str(lvl),
            "coordinateTransformations": [{
                "type": "scale",
                "scale": [1.0, 1.0, 1.0, float(2 ** lvl), float(2 ** lvl)],
            }],
        })
    (img_dir / ".zattrs").write_text(json.dumps({
        "multiscales": [{
            "version": NGFF_VERSION,
            "name": name,
            "axes": _AXES,
            "datasets": datasets,
        }],
        "image-label": {
            "version": NGFF_VERSION,
            "source": {"image": "../../"},
        },
    }, indent=2))


def write_ngff_plate(
    store,
    out: Path,
    n_levels: int = 3,
    chunk_yx: int = 256,
    compressor: str | None = "zlib",
    label_names: list[str] | None = None,
) -> Path:
    """Export the experiment store as one OME-NGFF 0.4 HCS plate.

    Every (well, site, tpoint, zplane, channel) plane is read from the
    store (raw, as ingested) and written as 5-D tczyx multiscale fields
    grouped ``<row>/<col>/<field>``; ``n_levels`` 2x display levels per
    field.  ``label_names`` additionally exports those segmentation
    stacks as NGFF ``image-label`` multiscales under each field's
    ``labels/`` group (the standard road for masks, reference parity:
    MapobjectSegmentation rows served to the viewer).  Returns the plate
    root (``<out>``, conventionally ``*.zarr``)."""
    out = Path(out)
    exp = store.experiment
    # fail fast on a mistyped/partial label name BEFORE any plate I/O —
    # aborting mid-export would leave a partial .zarr the user has to
    # clean up.  Every (tpoint, zplane) the field loop will read must
    # exist, not just t0/z0 (a jterator run on one tpoint of a
    # multi-tpoint experiment is exactly the partial case)
    for lname in label_names or []:
        for t in range(exp.n_tpoints):
            for z in range(exp.n_zplanes):
                if not store.has_labels(lname, tpoint=t, zplane=z):
                    raise MetadataError(
                        f"no segmentation stack named {lname!r} for "
                        f"tpoint {t} zplane {z} (run jterator first, or "
                        f"check --ngff-labels spelling)"
                    )
    refs = list(exp.sites())
    n_t, n_z = exp.n_tpoints, exp.n_zplanes
    n_c = len(exp.channels)

    by_well: dict[tuple[int, int], list] = {}
    for i, r in enumerate(refs):
        by_well.setdefault((r.well_row, r.well_column), []).append((i, r))

    rows = sorted({wr for wr, _ in by_well})
    cols = sorted({wc for _, wc in by_well})
    plate_attrs = {
        "plate": {
            "version": NGFF_VERSION,
            "name": exp.name,
            "rows": [{"name": _well_name(r, 0)[0]} for r in rows],
            "columns": [{"name": _well_name(0, c)[1]} for c in cols],
            "wells": [
                {
                    "path": "/".join(_well_name(wr, wc)),
                    "rowIndex": rows.index(wr),
                    "columnIndex": cols.index(wc),
                }
                for wr, wc in sorted(by_well)
            ],
            "field_count": max(len(v) for v in by_well.values()),
        }
    }
    out.mkdir(parents=True, exist_ok=True)
    (out / ".zgroup").write_text(json.dumps({"zarr_format": 2}))
    (out / ".zattrs").write_text(json.dumps(plate_attrs, indent=2))

    omero = {
        "channels": [
            {"label": ch.name, "active": True}
            for ch in exp.channels
        ],
        "version": NGFF_VERSION,
    }
    for (wr, wc), sites in sorted(by_well.items()):
        rname, cname = _well_name(wr, wc)
        well_dir = out / rname / cname
        well_dir.mkdir(parents=True, exist_ok=True)
        (well_dir / ".zgroup").write_text(json.dumps({"zarr_format": 2}))
        (well_dir / ".zattrs").write_text(json.dumps({
            "well": {
                "images": [{"path": str(f)} for f in range(len(sites))],
                "version": NGFF_VERSION,
            }
        }, indent=2))
        for field, (site_idx, _ref) in enumerate(sites):
            field_dir = well_dir / str(field)
            field_dir.mkdir(parents=True, exist_ok=True)
            (field_dir / ".zgroup").write_text(
                json.dumps({"zarr_format": 2})
            )
            # level 0: (t, c, z, y, x)
            planes = np.stack([
                np.stack([
                    np.stack([
                        store.read_sites(
                            [site_idx], channel=c, tpoint=t, zplane=z
                        )[0]
                        for z in range(n_z)
                    ])
                    for c in range(n_c)
                ])
                for t in range(n_t)
            ])
            datasets = []
            level = planes
            for lvl in range(n_levels):
                if lvl:
                    level = np.stack([
                        np.stack([
                            np.stack([
                                _downsample_2x(level[t, c, z])
                                for z in range(n_z)
                            ])
                            for c in range(n_c)
                        ])
                        for t in range(n_t)
                    ])
                    if level.shape[3] < 1 or level.shape[4] < 1:
                        break
                zarr_write_array(
                    field_dir / str(lvl), level,
                    (1, 1, 1, chunk_yx, chunk_yx), compressor,
                )
                datasets.append({
                    "path": str(lvl),
                    "coordinateTransformations": [{
                        "type": "scale",
                        "scale": [1.0, 1.0, 1.0, float(2 ** lvl),
                                  float(2 ** lvl)],
                    }],
                })
            (field_dir / ".zattrs").write_text(json.dumps({
                "multiscales": [{
                    "version": NGFF_VERSION,
                    "name": f"{rname}{cname}/{field}",
                    "axes": _AXES,
                    "datasets": datasets,
                }],
                "omero": omero,
            }, indent=2))
            if label_names:
                labels_dir = field_dir / "labels"
                labels_dir.mkdir(parents=True, exist_ok=True)
                (labels_dir / ".zgroup").write_text(
                    json.dumps({"zarr_format": 2})
                )
                # the listing is THIS run's names only — never merged
                # with a previous export's leftovers in the same dir
                (labels_dir / ".zattrs").write_text(
                    json.dumps({"labels": list(label_names)}, indent=2)
                )
            for lname in label_names or []:
                stack = np.stack([
                    np.stack([
                        np.stack([
                            store.read_labels(
                                [site_idx], lname, tpoint=t, zplane=z
                            )[0]
                            for z in range(n_z)
                        ])
                    ])  # single label "channel"
                    for t in range(n_t)
                ])
                _write_label_image(
                    field_dir, lname, stack, n_levels, chunk_yx,
                    compressor,
                )
    return out


# ------------------------------------------------------- container protocol
def _level0_name(attrs: dict) -> str:
    """The first multiscale dataset's path — the level-0 array directory.
    Our writer uses ``"0"``, but the spec only promises SOME path, so
    wild images (``scale0``, ``s0``…) must be followed, not assumed."""
    try:
        return str(attrs["multiscales"][0]["datasets"][0]["path"])
    except (KeyError, IndexError, TypeError):
        return "0"


class NGFFReader:
    """Container-protocol reader over an OME-NGFF directory — an HCS
    plate, or a bare multiscale image (the most common OME-Zarr form in
    the wild), which reads as a one-well one-field plate.

    Matches the :mod:`tmlibrary_tpu_torch.readers` container conventions
    (context manager, ``height``/``width``, a linear page decode) so a
    ``*.zarr`` directory ingests as the JAX package ingests it.  The
    linear page convention (shared with the ``ngff`` metaconfig handler,
    which writes it into the file mappings) is::

        page = (((well * F + field) * T + t) * C + c) * Z + z

    with wells in plate-attrs order and F/T/C/Z the uniform per-field
    dimensions (non-uniform plates raise).  ``is_plate`` tells the two
    forms apart — for a bare image the handler assigns the well from the
    filename instead of plate metadata.
    """

    def __init__(self, path):
        self.path = Path(path)

    def _enter_bare_image(self, attrs: dict):
        """A root-level ``multiscales`` image: one well at (0, 0), one
        field whose directory IS the container root."""
        self.is_plate = False
        self.well_paths = [""]
        self.well_indices = [(0, 0)]
        self.fields_per_well = [1]
        self.field_paths = [[""]]
        self.level0_names = [[_level0_name(attrs)]]
        meta = _zarray_meta(self.path / self.level0_names[0][0])
        if len(meta["shape"]) != 5:
            raise MetadataError(
                f"NGFF image {self.path} is not 5-D tczyx"
            )
        dims = tuple(meta["shape"])
        self.channel_names = None
        omero = attrs.get("omero") or {}
        if isinstance(omero.get("channels"), list):
            self.channel_names = [
                ch.get("label", f"C{i:02d}")
                for i, ch in enumerate(omero["channels"])
            ]
        self.n_fields = 1
        self.n_tpoints, self.n_channels, self.n_zplanes = dims[:3]
        self.height, self.width = dims[3], dims[4]
        return self

    def __enter__(self):
        # one broad guard over BOTH the plate and bare-image parsing:
        # valid-JSON type corruption ("rowIndex": null, "omero": "x",
        # string channel entries) raises TypeError/AttributeError at
        # scattered consumers — all of it must surface as the
        # MetadataError the ingest skip-unreadable contract expects
        try:
            return self._enter_impl()
        except MetadataError:
            raise
        except (KeyError, TypeError, ValueError, AttributeError,
                IndexError) as exc:
            raise MetadataError(
                f"malformed NGFF metadata in {self.path}: "
                f"{type(exc).__name__}: {exc}"
            ) from exc

    def _enter_impl(self):
        attrs_file = self.path / ".zattrs"
        try:
            attrs = json.loads(attrs_file.read_text())
        except (OSError, ValueError) as exc:
            raise MetadataError(
                f"not an NGFF plate: {self.path}: {exc}"
            ) from exc
        plate = attrs.get("plate")
        if not plate or "wells" not in plate:
            if attrs.get("multiscales"):
                return self._enter_bare_image(attrs)
            raise MetadataError(
                f"no HCS 'plate' or 'multiscales' metadata in {attrs_file}"
            )
        self.is_plate = True
        try:
            self.well_paths = [w["path"] for w in plate["wells"]]
        except (KeyError, TypeError) as exc:
            raise MetadataError(
                f"malformed plate wells entry in {attrs_file}: {exc}"
            ) from exc
        self.well_indices = [
            (int(w.get("rowIndex", 0)), int(w.get("columnIndex", 0)))
            for w in plate["wells"]
        ]
        self.fields_per_well: list[int] = []
        #: per-well field directory names from the well metadata — the
        #: spec does not promise 0-based numeric image paths, so the
        #: linear page decode must index THESE, not str(field)
        self.field_paths: list[list[str]] = []
        #: per-(well, field) level-0 dataset directory names (the spec
        #: only promises some multiscales datasets[0].path, not "0")
        self.level0_names: list[list[str]] = []
        dims = None
        self.channel_names: list[str] | None = None
        for wp in self.well_paths:
            well_dir = self.path / wp
            try:
                wattrs = json.loads((well_dir / ".zattrs").read_text())
                images = wattrs["well"]["images"]
                paths = [img["path"] for img in images]
            except (OSError, ValueError, KeyError, TypeError) as exc:
                raise MetadataError(
                    f"bad NGFF well at {well_dir}: {exc}"
                ) from exc
            self.fields_per_well.append(len(images))
            self.field_paths.append(paths)
            well_levels: list[str] = []
            for img in images:
                field_dir = well_dir / img["path"]
                try:
                    fattrs = json.loads(
                        (field_dir / ".zattrs").read_text()
                    )
                except (OSError, ValueError):
                    fattrs = {}
                lvl0 = _level0_name(fattrs)
                well_levels.append(lvl0)
                meta = _zarray_meta(field_dir / lvl0)
                if len(meta["shape"]) != 5:
                    raise MetadataError(
                        f"NGFF field {field_dir} is not 5-D tczyx"
                    )
                if dims is None:
                    dims = tuple(meta["shape"])
                elif tuple(meta["shape"]) != dims:
                    raise MetadataError(
                        f"non-uniform NGFF fields: {field_dir} has "
                        f"{meta['shape']}, expected {list(dims)}"
                    )
                if self.channel_names is None:
                    try:
                        self.channel_names = [
                            ch.get("label", f"C{i:02d}")
                            for i, ch in enumerate(
                                fattrs["omero"]["channels"]
                            )
                        ]
                    except (KeyError, TypeError):
                        pass
            self.level0_names.append(well_levels)
        if dims is None:
            raise MetadataError(f"NGFF plate {self.path} has no fields")
        if len(set(self.fields_per_well)) != 1:
            raise MetadataError(
                f"non-uniform field counts per well in {self.path}: "
                f"{self.fields_per_well}"
            )
        self.n_fields = self.fields_per_well[0]
        self.n_tpoints, self.n_channels, self.n_zplanes = dims[:3]
        self.height, self.width = dims[3], dims[4]
        return self

    def __exit__(self, *exc) -> None:
        pass

    @property
    def n_wells(self) -> int:
        return len(self.well_paths)

    def read_plane_linear(self, page: int) -> np.ndarray:
        t_sz, c_sz, z_sz = self.n_tpoints, self.n_channels, self.n_zplanes
        per_field = t_sz * c_sz * z_sz
        field_lin, rem = divmod(page, per_field)
        well, field = divmod(field_lin, self.n_fields)
        t, rem = divmod(rem, c_sz * z_sz)
        c, z = divmod(rem, z_sz)
        if well >= len(self.well_paths):
            raise MetadataError(
                f"page {page} out of range for {self.path}"
            )
        field_dir = (
            self.path / self.well_paths[well]
            / self.field_paths[well][field]
            / self.level0_names[well][field]
        )
        return zarr_read_plane(field_dir, t, c, z)
