"""Vendor sidecar-metadata handlers for metaconfig.

Counterpart: ``tmlibrary_tpu/workflow/steps/vendors.py`` (reference
``tmlib/workflow/metaconfig/``, one handler module per microscope
vendor): host-side parsers that return canonical entry dicts (the keys
of ``FilenameHandler.parse`` plus optional stage positions or grid
coordinates), registered by name in :data:`SIDECAR_HANDLERS` in the
JAX package's order, and :func:`resolve_sidecars`, metaconfig's policy
over them.

Every handler of the JAX package is ported, in its order: those whose
planes are plain TIFF/PNG files -- ``cellvoyager`` (``MeasurementData.mlf``
+ ``.mes``), ``omexml`` (companion ``*.ome.xml``), ``harmony``
(``Index.idx.xml``), ``imagexpress`` (``.HTD``), ``metamorph`` (``.nd``),
``scanr`` and ``leica`` (token filenames) -- and the container handlers,
which read their files through :mod:`tmlibrary_tpu_torch.readers`:
``nd2``, ``czi`` (with the mosaic tile grid), ``lif``, ``ngff`` (through
:mod:`tmlibrary_tpu_torch.ngff`), ``dv``, ``stk``, ``lsm``, ``olympus``
(OIF and OIB) and ``flex`` (Opera's numeric well names).  They skip and
count the files their reader cannot read.  ``ims`` returns None when
the tree holds no ``.ims`` file and otherwise raises
:class:`~tmlibrary_tpu_torch.errors.NotSupportedError` naming ROADMAP
item 12b: the port has no HDF5 reader yet.  That error is not a
:class:`~tmlibrary_tpu_torch.errors.MetadataError`, so ``auto`` cannot
skip it silently.

Stage positions, when present, become within-well site grid coordinates
through :func:`positions_to_grid`, as the reference derives them.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Callable

import logging

from tmlibrary_tpu_torch.errors import (
    MetadataError,
    NotSupportedError,
    VendorConflictError,
)
from tmlibrary_tpu_torch.readers import (
    CODEC_ITEM,
    CZIReader,
    DVReader,
    FlexReader,
    LIFReader,
    LSMReader,
    ND2Reader,
    OIBReader,
    OIFReader,
    STKReader,
)
from tmlibrary_tpu_torch.workflow.steps.omexml import _strip_ns

logger = logging.getLogger(__name__)

#: registry: handler name -> callable(source_dir) ->
#:   (entries, n_skipped) when sidecar files were found (entries may be
#:   empty: sidecars present but nothing resolvable), or None when the
#:   vendor's sidecar files are absent entirely.
SIDECAR_HANDLERS: dict[
    str, Callable[[Path], "tuple[list[dict], int] | None"]
] = {}


def register_sidecar_handler(name: str):
    def deco(fn):
        SIDECAR_HANDLERS[name] = fn
        return fn

    return deco


def _index_files(source_dir: Path, stems: bool = False) -> dict[str, Path]:
    """filename (and optionally extension-less stem) -> path, first wins."""
    by_name: dict[str, Path] = {}
    for p in source_dir.rglob("*"):
        if p.is_file():
            by_name.setdefault(p.name, p)
            if stems and p.suffix.lower() in (".tif", ".tiff", ".png", ".stk"):
                by_name.setdefault(p.stem, p)
    return by_name


def _attr(el: ET.Element, *names: str) -> str | None:
    """Look an attribute up by local name, ignoring XML namespaces."""
    for key, value in el.attrib.items():
        if _strip_ns(key) in names:
            return value
    return None


def positions_to_grid(positions: list[float], tol: float | None = None) -> dict:
    """Map stage coordinates to dense grid indices.

    Positions within ``tol`` of each other collapse onto one grid line
    (stage repeatability jitter).  The default ``tol`` is derived from the
    gap distribution: real grids produce bimodal gaps (tiny jitter vs the
    site pitch), detected as the largest ratio jump in the sorted gaps.
    Without clear bimodality (exact grid with no jitter, or a single grid
    line where every gap IS jitter) tol falls to 0 and each distinct value
    keeps its own line — callers must cross-check the resulting grid
    (e.g. against the field-index count) before trusting it.
    """
    if not positions:
        return {}
    distinct = sorted(set(positions))
    if tol is None:
        gaps = sorted(
            b - a for a, b in zip(distinct, distinct[1:])
        )
        tol = 0.0
        if gaps:
            best_ratio, split = 1.0, None
            for a, b in zip(gaps, gaps[1:]):
                ratio = b / a if a > 0 else float("inf")
                if ratio > best_ratio:
                    best_ratio, split = ratio, (a, b)
            if split is not None and best_ratio > 10.0:
                tol = (split[0] * split[1]) ** 0.5  # between the two modes
    lines: list[float] = []
    index_of: dict[float, int] = {}
    for p in distinct:
        if lines and p - lines[-1] <= tol:
            index_of[p] = len(lines) - 1
        else:
            lines.append(p)
            index_of[p] = len(lines) - 1
    return index_of


def derive_well_grids(
    entries: list[dict],
) -> dict[tuple[int, int], tuple[dict, dict]]:
    """Per-well (y_index, x_index) grids from stage positions.

    Positions are absolute stage coordinates, so the grid must be derived
    per well (reference metaconfig ``base.py`` does the same per-well grid
    derivation).  A well's grid is kept only when it cross-checks: the
    grid cells must form a dense rectangle addressing exactly the well's
    field set, else stage jitter was misread as grid lines
    (:func:`positions_to_grid` docstring) and callers fall back to field
    indices for that well.
    """
    from collections import defaultdict

    per_well: dict[tuple[int, int], list[dict]] = defaultdict(list)
    for e in entries:
        per_well[(e["well_row"], e["well_col"])].append(e)
    grids: dict[tuple[int, int], tuple[dict, dict]] = {}
    for key, group in per_well.items():
        pairs = [
            (e["stage_y"], e["stage_x"]) for e in group
            if e["stage_x"] is not None and e["stage_y"] is not None
        ]
        fields = {e["site"] for e in group}
        res = dense_grid(
            [p[0] for p in pairs], [p[1] for p in pairs], len(fields)
        )
        if res is not None:
            grids[key] = (res[1], res[2])
    return grids


def dense_grid(ys, xs, n) -> "tuple[list, dict, dict] | None":
    """(cells, y_index, x_index) when the coordinates form a dense
    rectangle addressing exactly ``n`` items, else None — the ONE home
    of the cross-check shared by stage-position well grids and CZI
    mosaic tile origins (a misclustered grid must fall back, never
    emit wrong geometry)."""
    y_index = positions_to_grid(ys)
    x_index = positions_to_grid(xs)
    cells = [(y_index[y], x_index[x]) for y, x in zip(ys, xs)]
    ny = len(set(y_index.values()))
    nx = len(set(x_index.values()))
    if len(set(cells)) != n or ny * nx != n:
        return None
    return cells, y_index, x_index


# --------------------------------------------------------------- cellvoyager
def parse_mes_channels(path: Path) -> dict[int, str]:
    """Parse ``MeasurementSetting.mes``: channel number -> descriptive name."""
    channels: dict[int, str] = {}
    try:
        root = ET.fromstring(path.read_text(errors="replace"))
    except ET.ParseError as exc:
        raise MetadataError(f"cannot parse CellVoyager .mes file {path}: {exc}")
    for el in root.iter():
        if _strip_ns(el.tag) != "Channel":
            continue
        num = _attr(el, "Ch", "Number", "ChannelNumber")
        if num is None:
            continue
        name = (
            _attr(el, "Target", "Fluorophore", "Dye", "Name", "Acquisition")
            or f"C{int(num):02d}"
        )
        channels[int(num)] = str(name)
    return channels


def parse_mlf(path: Path) -> list[dict]:
    """Parse ``MeasurementData.mlf`` into canonical plane entries.

    Each ``MeasurementRecord`` of type ``IMG`` carries well row/column,
    field (site), timeline/timepoint, z index, channel and stage X/Y; the
    element text is the image filename.
    """
    try:
        root = ET.fromstring(path.read_text(errors="replace"))
    except ET.ParseError as exc:
        raise MetadataError(f"cannot parse CellVoyager .mlf file {path}: {exc}")
    entries = []
    for el in root.iter():
        if _strip_ns(el.tag) != "MeasurementRecord":
            continue
        rtype = _attr(el, "Type")
        if rtype is not None and rtype.upper() not in ("IMG", "IMAGE"):
            continue  # ERR / timeline bookkeeping records
        row = _attr(el, "Row")
        col = _attr(el, "Column")
        field_i = _attr(el, "FieldIndex", "Field")
        if row is None or col is None or field_i is None:
            continue
        ch = _attr(el, "Ch", "Channel", "ActionIndex") or "1"
        tp = _attr(el, "TimePoint", "TimelineIndex", "T") or "1"
        zi = _attr(el, "ZIndex", "Z") or "1"
        x = _attr(el, "X")
        y = _attr(el, "Y")
        entries.append(
            {
                "well_row": int(row) - 1,
                "well_col": int(col) - 1,
                "site": int(field_i) - 1,
                "channel": str(int(ch)),
                "cycle": 0,
                "tpoint": int(tp) - 1,
                "zplane": int(zi) - 1,
                "filename": (el.text or "").strip(),
                "stage_x": float(x) if x is not None else None,
                "stage_y": float(y) if y is not None else None,
            }
        )
    return entries


@register_sidecar_handler("cellvoyager")
def cellvoyager_sidecar(source_dir: Path) -> tuple[list[dict], int] | None:
    """CellVoyager handler: requires a ``*.mlf`` file in the source tree."""
    mlfs = sorted(source_dir.rglob("*.mlf"))
    if not mlfs:
        return None
    entries: list[dict] = []
    for mlf in mlfs:
        entries.extend(parse_mlf(mlf))
    if not entries:
        return [], 0  # .mlf present but held no IMG records

    # channel names from the .mes settings file, if present; a corrupt .mes
    # must not abort ingest — the C<nn> fallback names cover its absence
    channel_names: dict[int, str] = {}
    for mes in sorted(source_dir.rglob("*.mes")):
        try:
            channel_names.update(parse_mes_channels(mes))
        except (MetadataError, ValueError) as exc:
            # ValueError: well-formed XML with a non-numeric channel number
            logger.warning("ignoring unparseable .mes file: %s", exc)

    # resolve filenames against the tree once (rglob per entry would be O(n^2))
    by_name = _index_files(source_dir)

    # stage positions -> within-well grid (shared per-well derivation)
    grids = derive_well_grids(entries)

    out = []
    skipped = 0
    for e in entries:
        path = by_name.get(e["filename"])
        if path is None:
            skipped += 1  # record for a file not exported alongside the sidecar
            continue
        rec = {
            "plate": "plate00",
            "well_row": e["well_row"],
            "well_col": e["well_col"],
            "site": e["site"],
            "channel": channel_names.get(int(e["channel"]), f"C{int(e['channel']):02d}"),
            "cycle": e["cycle"],
            "tpoint": e["tpoint"],
            "zplane": e["zplane"],
            "path": str(path),
        }
        grid = grids.get((e["well_row"], e["well_col"]))
        if grid is not None and e["stage_x"] is not None and e["stage_y"] is not None:
            y_index, x_index = grid
            rec["site_y"] = y_index[e["stage_y"]]
            rec["site_x"] = x_index[e["stage_x"]]
        out.append(rec)
    return out, skipped


# ------------------------------------------------------------------- omexml
def _plane_page(order: str, c: int, t: int, z: int, img) -> int:
    """Linear page index of plane (c, t, z) in a multi-page OME-TIFF.

    ``DimensionOrder`` lists all five dims; the first non-XY dim varies
    fastest across pages (OME spec).
    """
    sizes = {"C": img.size_c, "T": img.size_t, "Z": img.size_z}
    coords = {"C": c, "T": t, "Z": z}
    page, stride = 0, 1
    for dim in order.upper():
        if dim in ("X", "Y"):
            continue
        page += coords[dim] * stride
        stride *= sizes[dim]
    return page


@register_sidecar_handler("omexml")
def omexml_sidecar(source_dir: Path) -> tuple[list[dict], int] | None:
    """Companion OME-XML handler: one Image element per (well, site).

    Multi-plane images (SizeC/T/Z > 1 backed by one file) get a ``page``
    index per entry so the extractor reads the right TIFF page instead of
    silently duplicating page 0 across planes.
    """
    import re

    from tmlibrary_tpu_torch.workflow.steps.omexml import read_ome_companion

    companions = sorted(source_dir.rglob("*.ome.xml")) + sorted(
        source_dir.rglob("*.companion.ome")
    )
    if not companions:
        return None

    # TIFF series referenced by stem: Image Name "foo" -> file foo.tif
    by_name = _index_files(source_dir, stems=True)

    entries: list[dict] = []
    skipped = 0
    for comp in companions:
        for img in read_ome_companion(comp):
            path = by_name.get(img.name) or by_name.get(Path(img.name).name)
            if path is None:
                skipped += 1  # Image declared but no pixel file on disk
                continue
            m = re.search(r"r(\d+)c(\d+).*?y(\d+)x(\d+)", img.name) or re.search(
                r"([A-P])(\d{2})_s(\d+)", img.name
            )
            if m and len(m.groups()) == 4:
                row, col, sy, sx = (int(g) for g in m.groups())
                site = None
            elif m:
                row = ord(m.group(1)) - ord("A")
                col = int(m.group(2)) - 1
                site = int(m.group(3))
                sy = sx = None
            else:
                skipped += 1  # image name carries no recognisable layout
                continue
            multi_plane = img.size_c * img.size_t * img.size_z > 1
            for c in range(img.size_c):
                for t in range(img.size_t):
                    for z in range(img.size_z):
                        rec = {
                            "plate": "plate00",
                            "well_row": row,
                            "well_col": col,
                            # None marks "grid coords are the only site
                            # address" — _linearise_sites refuses to drop
                            # the grid for such entries
                            "site": site,
                            "channel": (
                                img.channel_names[c]
                                if c < len(img.channel_names)
                                else f"channel_{c}"
                            ),
                            "cycle": 0,
                            "tpoint": t,
                            "zplane": z,
                            "path": str(path),
                        }
                        if multi_plane:
                            rec["page"] = _plane_page(
                                img.dimension_order, c, t, z, img
                            )
                        if sy is not None:
                            rec["site_y"] = sy
                            rec["site_x"] = sx
                        entries.append(rec)
    return entries, skipped


# ------------------------------------------------------------------ harmony
def _child_text(el: ET.Element, *names: str) -> str | None:
    """First child element's text matched by local tag name."""
    for ch in el:
        if _strip_ns(ch.tag) in names and ch.text is not None:
            return ch.text.strip()
    return None


def parse_harmony_index(path: Path) -> list[dict]:
    """Parse a PerkinElmer Operetta/Opera Phenix ``Index.idx.xml``.

    Reference parity: the reference's metaconfig vendor-handler set
    (SURVEY.md §2 metaconfig row, exact vendor set tagged [L]) is a plugin
    registry per microscope; Harmony exports are the PerkinElmer member of
    that zoo.  The index document lists one ``<Image>`` record per plane
    with child elements ``URL`` (filename), ``Row``/``Col`` (1-based well),
    ``FieldID`` (site), ``ChannelID``/``ChannelName``, ``PlaneID`` (z),
    ``TimepointID`` and stage ``PositionX``/``PositionY``.
    """
    try:
        root = ET.fromstring(path.read_text(errors="replace"))
    except ET.ParseError as exc:
        raise MetadataError(f"cannot parse Harmony index file {path}: {exc}")
    entries: list[dict] = []
    for el in root.iter():
        if _strip_ns(el.tag) != "Image":
            continue
        url = _child_text(el, "URL")
        row = _child_text(el, "Row")
        col = _child_text(el, "Col")
        field = _child_text(el, "FieldID")
        if url is None or row is None or col is None or field is None:
            continue  # non-plane Image stanza (e.g. map entries)
        ch_id = _child_text(el, "ChannelID") or "1"
        ch_name = _child_text(el, "ChannelName")
        z = _child_text(el, "PlaneID") or "1"
        t = _child_text(el, "TimepointID") or "1"
        # TimepointID is 0-based in some Harmony exports, 1-based in others;
        # normalised by a min-subtraction over the whole index below.
        x = _child_text(el, "PositionX")
        y = _child_text(el, "PositionY")
        entries.append(
            {
                "well_row": int(row) - 1,
                "well_col": int(col) - 1,
                "site": int(field) - 1,
                "channel": ch_name or f"ch{int(ch_id)}",
                "cycle": 0,
                "tpoint": int(t),
                "zplane": int(z) - 1,
                "filename": url,
                "stage_x": float(x) if x is not None else None,
                "stage_y": float(y) if y is not None else None,
            }
        )
    if entries:
        t_min = min(e["tpoint"] for e in entries)
        for e in entries:
            e["tpoint"] -= t_min
    return entries


@register_sidecar_handler("harmony")
def harmony_sidecar(source_dir: Path) -> tuple[list[dict], int] | None:
    """Operetta/Opera Phenix handler: requires an ``Index.idx.xml``
    under the source tree (``Index.ref.xml`` is a fallback when no idx
    file exists — a tree holding both describes the SAME planes twice,
    so only one flavour is ever read).

    FieldID order is not guaranteed row-major (Harmony supports meander /
    center-out field layouts), so within-well grid coordinates are derived
    from the stage positions via :func:`derive_well_grids` whenever they
    cross-check against the field set.
    """
    indexes = sorted(source_dir.rglob("Index.idx.xml")) or sorted(
        source_dir.rglob("Index.ref.xml")
    )
    if not indexes:
        return None
    entries: list[dict] = []
    for idx in indexes:
        entries.extend(parse_harmony_index(idx))
    if not entries:
        return [], 0

    by_name = _index_files(source_dir)
    grids = derive_well_grids(entries)
    out: list[dict] = []
    skipped = 0
    for e in entries:
        path = by_name.get(e["filename"]) or by_name.get(Path(e["filename"]).name)
        if path is None:
            skipped += 1
            continue
        rec = {
            "plate": "plate00",
            "well_row": e["well_row"],
            "well_col": e["well_col"],
            "site": e["site"],
            "channel": e["channel"],
            "cycle": e["cycle"],
            "tpoint": e["tpoint"],
            "zplane": e["zplane"],
            "path": str(path),
        }
        grid = grids.get((e["well_row"], e["well_col"]))
        if grid is not None and e["stage_x"] is not None and e["stage_y"] is not None:
            y_index, x_index = grid
            rec["site_y"] = y_index[e["stage_y"]]
            rec["site_x"] = x_index[e["stage_x"]]
        out.append(rec)
    return out, skipped


# -------------------------------------------------------------- imagexpress
def parse_htd(path: Path) -> dict:
    """Parse a Molecular Devices ImageXpress/MetaXpress ``.HTD`` file.

    Line-oriented ``"Key", v1, v2, ...`` records describing the plate scan:
    well grid (``XWells``/``YWells`` + per-row ``WellsSelection<r>``
    booleans), within-well site grid (``XSites``/``YSites`` +
    ``SiteSelection<r>``), wavelengths (``NWavelengths`` +
    ``WaveName<i>``) and timepoints.
    """
    fields: dict[str, list[str]] = {}
    for raw in path.read_text(errors="replace").splitlines():
        line = raw.strip()
        if not line:
            continue
        parts = [p.strip().strip('"') for p in line.split(",")]
        if parts:
            fields[parts[0]] = parts[1:]

    def num(name: str, default: int = 1) -> int:
        try:
            return int(fields.get(name, [str(default)])[0])
        except (ValueError, IndexError):
            raise MetadataError(f"malformed numeric field {name} in {path}")

    def bools(name: str) -> list[bool]:
        return [v.upper() == "TRUE" for v in fields.get(name, [])]

    n_waves = num("NWavelengths")
    waves = [
        fields.get(f"WaveName{i}", [f"w{i}"])[0] for i in range(1, n_waves + 1)
    ]
    x_sites, y_sites = num("XSites"), num("YSites")
    # site linear numbering (1-based, row-major) covers SELECTED cells only
    site_grid: list[tuple[int, int]] = []
    any_selection = any(f"SiteSelection{r + 1}" in fields for r in range(y_sites))
    for r in range(y_sites):
        sel = bools(f"SiteSelection{r + 1}") if any_selection else [True] * x_sites
        for c in range(x_sites):
            if c < len(sel) and sel[c]:
                site_grid.append((r, c))
    return {
        "waves": waves,
        "site_grid": site_grid,
        "sites_x": x_sites,
        "n_tpoints": num("TimePoints"),
        "n_zsteps": num("ZSteps") if fields.get("DoZSeries", ["FALSE"])[0].upper() == "TRUE" else 1,
    }


#: <base>_<well>_s<site>_w<wave>[GUID][_z<k>].tif — the GUID suffix appears
#: in MetaXpress ≥5 exports; thumbnails end in "_thumb" and are excluded
IMAGEXPRESS_FILE = re.compile(
    r"_(?P<well>[A-Z]{1,2}\d{2})"
    r"_s(?P<site>\d+)"
    r"_w(?P<wave>\d+)"
    r"(?!.*_thumb)"
    r"(?:[0-9A-F-]{36})?"
    r"(?:_z(?P<z>\d+))?"
    r"\.(?:tif|tiff|TIF|TIFF)$"
)


@register_sidecar_handler("imagexpress")
def imagexpress_sidecar(source_dir: Path) -> tuple[list[dict], int] | None:
    """ImageXpress handler: requires ``*.HTD`` plate-description files.

    Each ``.HTD`` describes ONE plate scan and applies only to the image
    files under its own directory (the standard MetaXpress export layout
    puts one HTD per plate folder); multi-plate source trees therefore get
    per-plate wave names and site grids instead of the first HTD's.  Image
    files are matched by the MetaXpress filename convention; the timepoint
    comes from the enclosing ``TimePoint_<t>`` directory when the scan is a
    timelapse.  Site linear indices from the filename are mapped onto the
    HTD's selected-site grid so the manifest's within-well grid coordinates
    are faithful even for sparse site selections.
    """
    htds = sorted(p for p in source_dir.rglob("*") if p.suffix.upper() == ".HTD")
    if not htds:
        return None
    # one plate scope per HTD directory; first parseable HTD in a dir wins.
    # Plate names come from the scope directory's path relative to the
    # source root — scope dirs are unique, so names cannot collide even
    # when two plate folders carry same-named .HTD files.
    scopes: list[tuple[Path, str, dict]] = []
    seen_dirs: set[Path] = set()
    for htd in htds:
        if htd.parent in seen_dirs:
            continue
        try:
            info = parse_htd(htd)
        except MetadataError as exc:
            logger.warning("ignoring unparseable .HTD file: %s", exc)
            continue
        seen_dirs.add(htd.parent)
        rel = htd.parent.relative_to(source_dir)
        plate = "_".join(rel.parts) if rel.parts else "plate00"
        scopes.append((htd.parent, plate, info))
    if not scopes:
        raise MetadataError(f"no parseable .HTD file under {source_dir}")

    entries: list[dict] = []
    skipped = 0
    claimed: set[Path] = set()
    # deepest scope first so nested plate folders claim their own files;
    # a final source-root pass under the shallowest scope picks up images
    # living outside every HTD directory (layouts that park the HTD in a
    # sidecar folder like PlateInfo/) instead of silently dropping them
    ordered = sorted(scopes, key=lambda s: len(s[0].parts), reverse=True)
    sweeps = list(ordered)
    if len(scopes) == 1:
        # single-plate layout with the HTD in a sidecar folder: images
        # outside the HTD directory unambiguously belong to that plate.
        # With several plates, a stray file outside every plate folder has
        # no owner — it is counted as skipped below, never guessed.
        only = scopes[0]
        sweeps.append((source_dir, only[1], only[2]))
    for scan_dir, plate, info in sweeps:
        for p in sorted(scan_dir.rglob("*")):
            if p in claimed or not p.is_file():
                continue
            if p.suffix.lower() not in (".tif", ".tiff"):
                continue
            claimed.add(p)
            if "_thumb" in p.name:
                continue
            m = IMAGEXPRESS_FILE.search(p.name)
            if m is None:
                skipped += 1
                continue
            row, col = parse_well_name_token(m.group("well"))
            site_i = int(m.group("site")) - 1
            if site_i < len(info["site_grid"]):
                sy, sx = info["site_grid"][site_i]
            else:
                sy, sx = divmod(site_i, info["sites_x"])
            wave_i = int(m.group("wave"))
            channel = (
                info["waves"][wave_i - 1]
                if 0 < wave_i <= len(info["waves"])
                else f"w{wave_i}"
            )
            tpoint = 0
            # only directory levels BELOW the plate scope address
            # timepoints — an ancestor dir named TimePoint_<n> must not
            for part in p.relative_to(scan_dir).parts[:-1]:
                tm = re.fullmatch(r"TimePoint_(\d+)", part)
                if tm:
                    tpoint = int(tm.group(1)) - 1
            entries.append(
                {
                    "plate": plate,
                    "well_row": row,
                    "well_col": col,
                    "site": site_i,
                    "site_y": sy,
                    "site_x": sx,
                    "channel": channel,
                    "cycle": 0,
                    "tpoint": tpoint,
                    "zplane": int(m.group("z") or 1) - 1,
                    "path": str(p),
                }
            )
    if len(scopes) > 1:
        # multi-plate: stray pattern-matching images outside every plate
        # folder are visible in the skip count instead of silently ignored
        for p in sorted(source_dir.rglob("*")):
            if p in claimed or not p.is_file():
                continue
            if p.suffix.lower() in (".tif", ".tiff") and "_thumb" not in p.name:
                skipped += 1
    return entries, skipped


def parse_well_name_token(token: str) -> tuple[int, int]:
    """'B03' → (1, 2) without importing metaconfig at module load."""
    from tmlibrary_tpu_torch.workflow.steps.metaconfig import parse_well_name

    return parse_well_name(token)


# ----------------------------------------------------------------- metamorph
def parse_nd(path: Path) -> dict:
    """Parse a MetaMorph ``.nd`` acquisition-description file.

    Reference parity: ``tmlib/workflow/metaconfig``'s vendor handler set
    (SURVEY.md §2 metaconfig row, vendor set tagged [L]).  The ``.nd``
    format is line-oriented ``"Key", value`` pairs describing the
    wave (channel), stage-position and timepoint dimensions of one
    acquisition; image files are named
    ``<base>_w<N><wave>_s<position>_t<timepoint>``.
    """
    keys: dict[str, str] = {}
    for raw in path.read_text(errors="replace").splitlines():
        line = raw.strip()
        if not line or line == '"EndFile"':
            continue
        parts = line.split(",", 1)
        key = parts[0].strip().strip('"')
        val = parts[1].strip().strip('"') if len(parts) > 1 else ""
        keys[key] = val

    def flag(name: str) -> bool:
        return keys.get(name, "FALSE").upper() == "TRUE"

    def num(name: str, default: int = 1) -> int:
        try:
            return int(keys.get(name, default))
        except ValueError:
            raise MetadataError(f"malformed numeric field {name} in {path}")

    waves = []
    if flag("DoWave"):
        waves = [keys.get(f"WaveName{i}", f"w{i}") for i in range(1, num("NWaves") + 1)]
    stages = []
    if flag("DoStage"):
        stages = [
            keys.get(f"Stage{i}", f"s{i}") for i in range(1, num("NStagePositions") + 1)
        ]
    return {
        "waves": waves,
        "stages": stages,
        "n_tpoints": num("NTimePoints") if flag("DoTimelapse") else 1,
        "n_zsteps": num("NZSteps") if flag("DoZSeries") else 1,
    }


def _well_token():
    """Compiled well-name token search, sourced from metaconfig's
    WELL_NAME_PATTERN so the two can't drift.  Deferred import:
    metaconfig is the module that imports this handler registry."""
    from tmlibrary_tpu_torch.workflow.steps.metaconfig import WELL_NAME_PATTERN

    return re.compile(WELL_NAME_PATTERN)


@register_sidecar_handler("metamorph")
def metamorph_sidecar(source_dir: Path) -> tuple[list[dict], int] | None:
    """MetaMorph handler: requires ``*.nd`` files in the source tree.

    Well assignment: a stage label containing a well token (``A01``) maps
    to that well, with repeated labels numbering sites within the well in
    label order; labels without a well token all land in one well with the
    position index as the site.  Z-series acquisitions are stored as
    multi-page stacks, addressed via per-plane ``page`` indices.
    """
    nds = sorted(source_dir.rglob("*.nd"))
    if not nds:
        return None
    by_stem = _index_files(source_dir, stems=True)

    entries: list[dict] = []
    skipped = 0
    # shared across .nd files: two acquisitions hitting the same well must
    # get distinct site numbers, not overwrite each other's store slots
    site_counter: dict[tuple[int, int], int] = {}
    for nd in nds:
        try:
            info = parse_nd(nd)
        except MetadataError as exc:
            logger.warning("ignoring unparseable .nd file: %s", exc)
            continue
        base = nd.stem
        waves = info["waves"] or [None]
        stages = info["stages"] or [None]

        from tmlibrary_tpu_torch.workflow.steps.metaconfig import parse_well_name
        well_token = _well_token()
        addr: list[tuple[int, int, int]] = []
        for pos, label in enumerate(stages):
            m = well_token.search(label) if label else None
            if m:
                row, col = parse_well_name(m.group(0))
            else:
                row, col = 0, 0
            site = site_counter.get((row, col), 0)
            site_counter[(row, col)] = site + 1
            addr.append((row, col, site))

        for t in range(info["n_tpoints"]):
            for wi, wave in enumerate(waves):
                for pos, label in enumerate(stages):
                    stem = base
                    if wave is not None:
                        stem += f"_w{wi + 1}{wave}"
                    if info["stages"]:
                        stem += f"_s{pos + 1}"
                    if info["n_tpoints"] > 1:
                        stem += f"_t{t + 1}"
                    path = by_stem.get(stem)
                    if path is None:
                        skipped += 1
                        continue
                    row, col, site = addr[pos]
                    for z in range(info["n_zsteps"]):
                        rec = {
                            "plate": "plate00",
                            "well_row": row,
                            "well_col": col,
                            "site": site,
                            "channel": wave if wave is not None else "w1",
                            "cycle": 0,
                            "tpoint": t,
                            "zplane": z,
                            "path": str(path),
                        }
                        if info["n_zsteps"] > 1:
                            rec["page"] = z  # stack page = z plane
                        entries.append(rec)
    return entries, skipped


def _image_files(source_dir: Path) -> list[Path]:
    """All image files under the tree, sorted (shared by the token-based
    filename handlers)."""
    return [
        p for p in sorted(source_dir.rglob("*"))
        if p.suffix.lower() in (".tif", ".tiff", ".png")
    ]


# -------------------------------------------------------------------- scanr
#: standard plate geometries (wells -> (rows, cols)), smallest-first
_PLATE_GEOMETRIES = (
    (6, (2, 3)), (12, (3, 4)), (24, (4, 6)), (48, (6, 8)),
    (96, (8, 12)), (384, (16, 24)), (1536, (32, 48)),
)


def _scanr_tokens(stem: str) -> dict[str, str] | None:
    """Split a ScanR filename stem on ``--`` into its dimension tokens.

    ScanR names planes ``<prefix>--W00001--P00012--Z00000--T00000--<chan>``
    (Z/T optional); W (well) and P (position) are required for a match,
    the trailing token is the channel name."""
    parts = stem.split("--")
    if len(parts) < 3:
        return None
    out: dict[str, str] = {}
    for tok in parts[1:-1]:
        m = re.fullmatch(r"([WPZT])(\d+)", tok)
        if m:
            out[m.group(1)] = m.group(2)
    if "W" not in out or "P" not in out:
        return None
    out["channel"] = parts[-1]
    return out


def _scanr_plate_shape(source_dir: Path, n_wells: int) -> tuple[int, int]:
    """Plate geometry: from ``experiment_descriptor.xml`` when a
    plate-describing element carries row/column counts, else the smallest
    standard plate that fits the well count (documented heuristic — ScanR
    well indices are linear).

    Only elements whose tag mentions "plate" with exact ``rows``/
    ``columns``-style attribute names are considered, so per-well
    ``<Well Row=.. Column=..>`` entries or pitch/spacing attributes can't
    masquerade as the geometry."""
    attr_rows = re.compile(r"^(n?_?rows?)$", re.IGNORECASE)
    attr_cols = re.compile(r"^(n?_?col(umn)?s?)$", re.IGNORECASE)
    for xml in sorted(source_dir.rglob("experiment_descriptor.xml")):
        try:
            root = ET.parse(xml).getroot()
        except ET.ParseError:
            continue
        for el in root.iter():
            if "plate" not in _strip_ns(el.tag).lower():
                continue
            rows = next(
                (v for k, v in el.attrib.items() if attr_rows.match(k)), None
            )
            cols = next(
                (v for k, v in el.attrib.items() if attr_cols.match(k)), None
            )
            try:
                if rows and cols and int(rows) * int(cols) >= n_wells:
                    return int(rows), int(cols)
            except ValueError:
                continue
    for n, shape in _PLATE_GEOMETRIES:
        if n >= n_wells:
            return shape
    # beyond 1536: single row of wells
    return 1, n_wells


@register_sidecar_handler("scanr")
def scanr_sidecar(source_dir: Path) -> tuple[list[dict], int] | None:
    """Olympus ScanR handler: recognizes the ``--W...--P...--`` token
    filename convention (``experiment_descriptor.xml`` is consulted for
    the plate geometry when present, but is not required).

    Reference parity: ``tmlib/workflow/metaconfig``'s vendor handler set
    (SURVEY.md §2 metaconfig row, vendor set tagged [L]).  ScanR well
    indices are linear and 1-based; they map row-major onto the plate
    geometry.  Positions are 1-based sites within the well; Z and T
    tokens become zplane/tpoint.
    """
    images = _image_files(source_dir)
    parsed = [(p, _scanr_tokens(p.stem)) for p in images]
    matches = [(p, t) for p, t in parsed if t is not None]
    if not matches:
        return None

    # ScanR W/P tokens are 1-based by convention, but some exports count
    # from 0: an observed zero token flips that dimension to 0-based.
    # (Min-normalization would be wrong — screens routinely image a well
    # subset, and W must keep its absolute plate position.)
    w_base = 0 if min(int(t["W"]) for _, t in matches) == 0 else 1
    p_base = 0 if min(int(t["P"]) for _, t in matches) == 0 else 1
    n_wells = max(int(t["W"]) for _, t in matches) - w_base + 1
    rows, cols = _scanr_plate_shape(source_dir, n_wells)

    entries: list[dict] = []
    skipped = len(parsed) - len(matches)
    for path, t in matches:
        w = int(t["W"]) - w_base  # linear well index, row-major
        entries.append(
            {
                "plate": "plate00",
                "well_row": w // cols,
                "well_col": w % cols,
                "site": int(t["P"]) - p_base,
                "channel": t["channel"],
                "cycle": 0,
                "tpoint": int(t.get("T", 0)),
                "zplane": int(t.get("Z", 0)),
                "path": str(path),
            }
        )
    return entries, skipped


# ------------------------------------------------------------------- leica
def _leica_tokens(stem: str) -> dict[str, int] | None:
    """Parse a Leica MatrixScreener image stem.

    The LAS X MatrixScreener export names planes
    ``image--L00--S00--U01--V02--J08--E00--O00--X03--Y04--T00--Z05--C01``:
    U/V are the well column/row on the plate, X/Y the field (site) grid
    within the well, T/Z/C the timepoint, z-plane and channel.  U, V, X
    and Y are required for a match; the other dimensions default to 0."""
    parts = stem.split("--")
    if len(parts) < 5:
        return None
    out: dict[str, int] = {}
    for tok in parts[1:]:
        m = re.fullmatch(r"([A-Z])(\d+)", tok)
        if m:
            out[m.group(1)] = int(m.group(2))
    if not {"U", "V", "X", "Y"} <= set(out):
        return None
    return out


@register_sidecar_handler("leica")
def leica_sidecar(source_dir: Path) -> tuple[list[dict], int] | None:
    """Leica MatrixScreener handler (``--U--V--X--Y`` token filenames).

    Reference parity: ``tmlib/workflow/metaconfig``'s vendor handler set
    (SURVEY.md §2 metaconfig row, vendor set tagged [L]).  Wells come from
    the U (column) / V (row) tokens; the within-well field grid (X, Y)
    passes through as authoritative grid coordinates (metaconfig derives
    the site numbering from them); time loops (L) fold with T into one
    dense tpoint axis."""
    images = _image_files(source_dir)
    matches = [
        (p, t) for p, t in ((p, _leica_tokens(p.name.split(".")[0]))
                            for p in images)
        if t is not None
    ]
    if not matches:
        return None

    # time loops (L) and timepoints (T) compose lexicographically into one
    # dense tpoint axis — collapsing L would silently overwrite whole loops
    n_t = max(t.get("T", 0) for _, t in matches) + 1
    entries: list[dict] = []
    for path, t in matches:
        entries.append(
            {
                "plate": "plate00",
                "well_row": t["V"],
                "well_col": t["U"],
                # site index is derived by metaconfig._linearise_sites from
                # the authoritative grid coords — no duplicate flattening
                "site": 0,
                "site_y": t["Y"],
                "site_x": t["X"],
                "channel": f"C{t.get('C', 0):02d}",
                "cycle": 0,
                "tpoint": t.get("L", 0) * n_t + t.get("T", 0),
                "zplane": t.get("Z", 0),
                "path": str(path),
            }
        )
    return entries, len(images) - len(matches)


# ------------------------------------------------- container-format helpers

def parse_well_token(stem: str) -> tuple[int, int] | None:
    """First well-name token (``A01``) in a filename stem, or None."""
    for token in re.split(r"[_\-\s]+", stem):
        try:
            return parse_well_name_token(token)
        except MetadataError:
            continue
    return None


def assign_container_wells(
    readable: list, kind: str
) -> list:
    """Shared well-assignment policy for one-file-per-well container
    formats (nd2, czi, …): explicit well tokens are authoritative and
    must be unique — two files on one well would silently overwrite each
    other's pixels in the store — and token-less files take the next FREE
    column on row A so they can't collide with a real A-row well either.

    ``readable``: ``[(path, meta, well_or_None)]`` →
    ``[(path, meta, (row, col))]``; raises
    :class:`~tmlibrary_tpu_torch.errors.VendorConflictError` on duplicates.
    """
    from tmlibrary_tpu_torch.errors import VendorConflictError

    by_well: dict[tuple[int, int], Path] = {}
    for path, _, well in readable:
        if well is None:
            continue
        if well in by_well:
            raise VendorConflictError(
                f"{kind} files {by_well[well]} and {path} both claim well "
                f"{well} — their planes would overwrite each other"
            )
        by_well[well] = path
    out = []
    next_col = 0
    for path, meta, well in readable:
        if well is None:
            while (0, next_col) in by_well:
                next_col += 1
            well = (0, next_col)
            by_well[well] = path
        out.append((path, meta, well))
    return out


def sanitize_channel_label(names, c: int) -> str:
    """The ONE channel-label policy for container metadata names:
    sanitize to the ingest pattern's charset, fall back to ``C%02d``
    when the name is absent or empty.  Prefer :func:`channel_labels`
    for a whole channel set — it adds the collision guard."""
    if names and c < len(names) and names[c]:
        return re.sub(r"[^A-Za-z0-9\-]", "-", names[c])
    return f"C{c:02d}"


def channel_labels(names, n: int) -> list[str]:
    """Sanitized labels for ``n`` channels with a collision guard:
    duplicate labels (two detectors sharing one LUT name, or distinct
    names merged by sanitization) would collapse distinct channels into
    ONE store channel downstream — metaconfig builds channels from a
    set and imextract groups planes by channel label, so one channel's
    pixels would silently overwrite the other's.  Any collision drops
    the whole set to the ``C%02d`` fallback."""
    labels = [sanitize_channel_label(names, c) for c in range(n)]
    if len(set(labels)) != n:
        return [f"C{c:02d}" for c in range(n)]
    return labels


def _container_entry(path: Path, well: tuple[int, int], site: int,
                     channel: int, zplane: int, tpoint: int,
                     page: int) -> dict:
    """The one home of the container-format entry schema."""
    return {
        "plate": "plate00",
        "well_row": well[0],
        "well_col": well[1],
        "site": site,
        "channel": f"C{channel:02d}",
        "cycle": 0,
        "tpoint": tpoint,
        "zplane": zplane,
        "path": str(path),
        "page": page,
    }


def _container_sidecar(
    source_dir: Path, suffix: str, reader_cls, kind: str,
    dims_of: Callable, entries_of: Callable,
    well_of: "Callable | None" = None,
) -> tuple[list[dict], int] | None:
    """Shared scan -> skip-unreadable -> assign-wells -> emit loop of the
    one-file-per-well container handlers (nd2/czi/lif/dv); only the
    reader, the dims tuple and the page formula differ per format.
    ``suffix`` may be one extension or a tuple of them; ``well_of``
    overrides the default well-token parse (flex: Opera numeric names)."""
    suffixes = (suffix,) if isinstance(suffix, str) else suffix
    files = sorted(
        p for suf in suffixes for p in source_dir.rglob(f"*{suf}")
    )
    if not files:
        return None
    readable = []
    skipped = 0
    for path in files:
        try:
            with reader_cls(path) as r:
                dims = dims_of(r)
        # NotSupportedError too: a reader gating on a feature it does not
        # model (RGB .stk, interleaved .lsm) must skip that file like any
        # unreadable one, not abort the whole ingest
        except (MetadataError, NotSupportedError) as exc:
            logger.warning("skipping unreadable %s file %s: %s", kind, path, exc)
            skipped += 1
            continue
        readable.append(
            (path, dims, (well_of or parse_well_token)(path.stem))
        )
    entries: list[dict] = []
    for path, dims, well in assign_container_wells(readable, kind):
        entries.extend(entries_of(path, dims, well))
    return entries, skipped


# ----------------------------------------------------------------------- nd2
@register_sidecar_handler("nd2")
def nd2_sidecar(source_dir: Path) -> tuple[list[dict], int] | None:
    """Nikon NIS-Elements ``.nd2`` containers, read by the first-party
    chunk-map parser (:class:`tmlibrary_tpu_torch.readers.ND2Reader`).

    One file per well when a well-name token (``A01``) appears in the
    filename; otherwise each file becomes its own well on row A.  The
    SLxExperiment loop structure assigns each sequence its
    (XY-position, Z, T) coordinate — XY positions map to sites with
    time/Z preserved; files without a modeled loop structure keep the
    flat sequences-as-sites mapping.  When the XYPosLoop's stage
    coordinates form a dense rectangle, each site also carries its
    within-well grid coordinate (``site_y``/``site_x``) so multi-point
    wells linearize in acquisition geometry (same dense-grid
    cross-check as CZI mosaic origins).  Interleaved components map to
    channels (``C00``/``C01``/…); ``page`` encodes
    ``seq * n_components + comp`` for imextract's plane decode."""
    def entries_of(path, dims, well):
        n_seq, n_comp, coords, positions, names = dims
        if not coords:
            # zero-sequence file (aborted acquisition): no entries, and
            # max() below must not crash the whole ingest
            return []
        n_xy = max(xy for xy, _, _ in coords) + 1
        grid = None
        if positions is not None and len(positions) == n_xy and n_xy > 1:
            res = dense_grid(
                [p[0] for p in positions], [p[1] for p in positions], n_xy
            )
            grid = None if res is None else res[0]
        labels = channel_labels(names, n_comp)
        out = []
        for seq in range(n_seq):
            xy, z, t = coords[seq]
            for comp in range(n_comp):
                e = _container_entry(path, well, site=xy, channel=comp,
                                     zplane=z, tpoint=t,
                                     page=seq * n_comp + comp)
                e["channel"] = labels[comp]
                if grid is not None:
                    e["site_y"], e["site_x"] = grid[xy]
                out.append(e)
        return out

    return _container_sidecar(
        source_dir, ".nd2", ND2Reader, "ND2",
        lambda r: (r.n_sequences, r.n_components,
                   [r.seq_coords(s) for s in range(r.n_sequences)],
                   r.xy_positions(), r.channel_names()),
        entries_of,
    )


# ----------------------------------------------------------------------- czi
@register_sidecar_handler("czi")
def czi_sidecar(source_dir: Path) -> tuple[list[dict], int] | None:
    """Zeiss ``.czi`` containers, read by the first-party ZISRAW parser
    (:class:`tmlibrary_tpu_torch.readers.CZIReader`).

    Same conventions as the nd2 handler: one file per well (well-name
    token in the filename, else the next free column on row A), scenes
    (S) × mosaic tiles (M, slide scans) map to sites, channels to
    ``C00``/…, with Z/T preserved; ``page`` encodes
    ``(((s * M + m) * C + c) * Z + z) * T + t`` for imextract.

    Single-scene mosaics additionally carry each tile's within-well
    grid coordinate (``site_y``/``site_x`` from the subblock directory's
    mosaic pixel origins) whenever the origins form a dense rectangle —
    the adjacency ``--layout spatial`` needs to stitch a slide scan in
    acquisition geometry rather than a square-ish default grid."""
    def tile_grid(n_m, origins) -> "list[tuple[int, int]] | None":
        """(y, x) grid index per tile rank, or None when origins are
        absent or not a dense rectangle (shared cross-check)."""
        if origins is None:
            return None
        res = dense_grid(
            [float(y) for y, _ in origins],
            [float(x) for _, x in origins], n_m,
        )
        return None if res is None else res[0]

    def entries_of(path, dims, well):
        n_s, n_m, n_c, n_z, n_t, origins, names = dims
        grid = tile_grid(n_m, origins) if n_s == 1 and n_m > 1 else None
        labels = channel_labels(names, n_c)
        out = []
        for s in range(n_s):
            for m in range(n_m):
                for c in range(n_c):
                    label = labels[c]
                    for z in range(n_z):
                        for t in range(n_t):
                            e = _container_entry(
                                path, well, site=s * n_m + m, channel=c,
                                zplane=z, tpoint=t,
                                page=(((s * n_m + m) * n_c + c) * n_z + z)
                                * n_t + t)
                            e["channel"] = label
                            if grid is not None:
                                e["site_y"], e["site_x"] = grid[m]
                            out.append(e)
        return out

    return _container_sidecar(
        source_dir, ".czi", CZIReader, "CZI",
        lambda r: (r.n_scenes, r.n_tiles, r.n_channels, r.n_zplanes,
                   r.n_tpoints,
                   [r.tile_origin(0, m) for m in range(r.n_tiles)]
                   if r.n_scenes == 1 else None,
                   r.channel_names),
        entries_of,
    )


# ----------------------------------------------------------------------- lif
@register_sidecar_handler("lif")
def lif_sidecar(source_dir: Path) -> tuple[list[dict], int] | None:
    """Leica Image Files, read by the first-party block parser
    (:class:`tmlibrary_tpu_torch.readers.LIFReader`).

    Same conventions as the nd2/czi handlers: one file per well (token or
    next free column on row A), image series map to sites, channel labels
    from the LUTName attributes (``C00``/… fallback), Z/T preserved;
    ``page`` encodes the whole-file linear index
    ``series * C*Z*T + (c*Z + z)*T + t`` for imextract.  Files whose
    series disagree on (C, Z, T) are skipped with a logged reason."""
    def entries_of(path, dims, well):
        n_series, n_c, n_z, n_t, names = dims
        labels = channel_labels(names, n_c)
        out = []
        for s in range(n_series):
            for c in range(n_c):
                for z in range(n_z):
                    for t in range(n_t):
                        e = _container_entry(
                            path, well, site=s, channel=c, zplane=z,
                            tpoint=t,
                            page=(s * n_c + c) * n_z * n_t + z * n_t + t)
                        e["channel"] = labels[c]
                        out.append(e)
        return out

    return _container_sidecar(
        source_dir, ".lif", LIFReader, "LIF",
        lambda r: (r.n_series, *r.uniform_dims(), r.channel_names()),
        entries_of,
    )


# ---------------------------------------------------------------------- ngff
@register_sidecar_handler("ngff")
def ngff_sidecar(source_dir: Path) -> "tuple[list[dict], int] | None":
    """OME-NGFF (OME-Zarr v0.4) HCS plates, read by the first-party Zarr
    v2 parser (:class:`tmlibrary_tpu_torch.ngff.NGFFReader`).

    HCS plates take their wells from the plate's own metadata
    (``rowIndex``/``columnIndex``) and their plate name from the
    ``*.zarr`` directory's stem; BARE multiscale images (no ``plate``
    key — the most common OME-Zarr form) are assigned wells like the
    nd2/czi/lif containers: filename token (``A01``), else the next
    free column on row A.  Fields map to sites, omero channel labels
    (sanitized) name the channels.  ``page`` encodes
    ``(((well * F + field) * T + t) * C + c) * Z + z`` — the convention
    :meth:`~tmlibrary_tpu_torch.ngff.NGFFReader.read_plane_linear` decodes
    for imextract.  Counterpart: ``tmlibrary_tpu/workflow/steps/vendors.py``
    ``ngff_sidecar`` (``:1284-1369``)."""
    from tmlibrary_tpu_torch.ngff import NGFFReader

    plates = sorted(
        p for p in source_dir.rglob("*.zarr")
        if p.is_dir() and (p / ".zattrs").exists()
    )
    if not plates:
        return None
    entries: list[dict] = []
    skipped = 0
    bare: list[tuple] = []

    def channel_names(nc, labels):
        return channel_labels(labels, nc)

    def emit(path, info, wells, plate_name):
        nf, nt, nc, nz, labels = info
        names = channel_names(nc, labels)
        for wi, well in enumerate(wells):
            for f in range(nf):
                for t in range(nt):
                    for c in range(nc):
                        for z in range(nz):
                            e = _container_entry(
                                path, well, site=f, channel=c,
                                zplane=z, tpoint=t,
                                page=(((wi * nf + f) * nt + t) * nc + c)
                                * nz + z,
                            )
                            e["plate"] = plate_name
                            e["channel"] = names[c]
                            entries.append(e)

    for path in plates:
        try:
            with NGFFReader(path) as r:
                info = (r.n_fields, r.n_tpoints, r.n_channels,
                        r.n_zplanes, r.channel_names)
                if r.is_plate:
                    plate_name = (
                        re.sub(r"[^A-Za-z0-9]", "", path.stem) or "plate00"
                    )
                    emit(path, info, list(r.well_indices), plate_name)
                else:
                    bare.append((path, info, parse_well_token(path.stem)))
        except MetadataError as exc:
            logger.warning("skipping unreadable NGFF plate %s: %s",
                           path, exc)
            skipped += 1
    # bare images land on "plate00" (the shared container convention);
    # assign_container_wells only deduplicates AMONG the bare files, so
    # an HCS plate whose sanitized stem is also "plate00" must not have
    # its wells silently overwritten by a bare image's pixels
    claimed = {
        (e["plate"], e["well_row"], e["well_col"]) for e in entries
    }
    for path, info, well in assign_container_wells(bare, "NGFF"):
        if ("plate00", well[0], well[1]) in claimed:
            raise VendorConflictError(
                f"bare NGFF image {path} would land on plate00 well "
                f"{well}, already claimed by an HCS plate in the same "
                f"source dir — rename one of them"
            )
        emit(path, info, [well], "plate00")
    return entries, skipped


# ------------------------------------------------------------------------ dv
@register_sidecar_handler("dv")
def dv_sidecar(source_dir: Path) -> "tuple[list[dict], int] | None":
    """DeltaVision ``.dv`` / ``.r3d`` stacks, read by the first-party
    MRC-variant parser (:class:`tmlibrary_tpu_torch.readers.DVReader`).

    Same conventions as the nd2/czi/lif handlers: one file per well
    (well-name token in the filename, else the next free column on row
    A); each stack is a single site with its wavelengths as channels and
    Z/T preserved; ``page`` encodes ``(c * Z + z) * T + t`` for
    imextract's plane decode."""
    def entries_of(path, dims, well):
        n_c, n_z, n_t = dims
        return [
            _container_entry(path, well, site=0, channel=c, zplane=z,
                             tpoint=t, page=(c * n_z + z) * n_t + t)
            for c in range(n_c)
            for z in range(n_z)
            for t in range(n_t)
        ]

    return _container_sidecar(
        source_dir, (".dv", ".r3d"), DVReader, "DV",
        lambda r: (r.n_channels, r.n_zplanes, r.n_tpoints), entries_of,
    )


# ----------------------------------------------------------------------- ims
@register_sidecar_handler("ims")
def ims_sidecar(source_dir: Path) -> None:
    """Bitplane Imaris ``.ims`` files (HDF5): None when the tree holds
    none; with one present, :class:`NotSupportedError` naming ROADMAP
    item 12b, as the port has no HDF5 reader yet (the JAX package reads
    them through ``h5py``).  Not a
    :class:`~tmlibrary_tpu_torch.errors.MetadataError`, so ``--handler
    auto`` cannot skip the files silently."""
    files = sorted(source_dir.rglob("*.ims"))
    if files:
        raise NotSupportedError(
            f"Imaris .ims files are HDF5, which the port does not read without h5py yet "
            f"({CODEC_ITEM}): {', '.join(str(p) for p in files[:3])}"
            + (f" and {len(files) - 3} more" if len(files) > 3 else ""))
    return None


# ----------------------------------------------------------------------- stk
@register_sidecar_handler("stk")
def stk_sidecar(source_dir: Path) -> "tuple[list[dict], int] | None":
    """Standalone MetaMorph ``.stk`` stacks, read by
    :class:`tmlibrary_tpu_torch.readers.STKReader` (the UIC2-tag plane count a
    paged TIFF reader cannot see).

    MetaMorph acquisitions WITH a parseable ``.nd`` go through the richer
    ``metamorph`` handler (wavelengths, stage labels): it is registered
    first, so in auto mode it wins whenever its sidecar resolves images
    and this handler only sees trees whose ``.nd`` is absent or
    unusable.  No ``.nd`` veto here — an explicit ``handler='stk'`` (or
    a stray/corrupt ``.nd`` in auto mode) must still ingest the stacks.
    Conventions: one file per well (token or next free column on row A),
    one site per file, single channel, planes map to Z; ``page = z``."""
    def entries_of(path, dims, well):
        (n_z,) = dims
        return [
            _container_entry(path, well, site=0, channel=0, zplane=z,
                             tpoint=0, page=z)
            for z in range(n_z)
        ]

    return _container_sidecar(
        source_dir, ".stk", STKReader, "STK",
        lambda r: (r.n_zplanes,), entries_of,
    )


# ----------------------------------------------------------------------- lsm
@register_sidecar_handler("lsm")
def lsm_sidecar(source_dir: Path) -> "tuple[list[dict], int] | None":
    """Zeiss LSM confocal stacks, read by
    :class:`tmlibrary_tpu_torch.readers.LSMReader` (planar per-channel strips,
    thumbnail IFDs skipped, dims from CZ_LSMINFO).

    Same conventions as the other container handlers: one file per well
    (token or next free column on row A), one site per file, C/Z/T
    preserved; ``page`` encodes ``(c * Z + z) * T + t``."""
    def entries_of(path, dims, well):
        n_c, n_z, n_t = dims
        return [
            _container_entry(path, well, site=0, channel=c, zplane=z,
                             tpoint=t, page=(c * n_z + z) * n_t + t)
            for c in range(n_c)
            for z in range(n_z)
            for t in range(n_t)
        ]

    return _container_sidecar(
        source_dir, ".lsm", LSMReader, "LSM",
        lambda r: (r.n_channels, r.n_zplanes, r.n_tpoints), entries_of,
    )


# ------------------------------------------------------------------- olympus
@register_sidecar_handler("olympus")
def olympus_sidecar(source_dir: Path) -> "tuple[list[dict], int] | None":
    """Olympus FluoView ``.oif`` acquisitions and their single-file
    ``.oib`` (OLE2 compound document) form, read by
    :class:`tmlibrary_tpu_torch.readers.OIFReader` /
    :class:`~tmlibrary_tpu_torch.readers.OIBReader` — the compound container
    parsed by the first-party :mod:`tmlibrary_tpu_torch.cfb` walker, no JVM.

    Same conventions as the other container handlers: one file per well
    (token or next free column on row A), one site per file, C/Z/T
    preserved; ``page`` encodes ``(c * Z + z) * T + t``.  The companion
    ``.oif.files`` TIFF directories are consumed through their main file
    only — in auto mode this handler resolves them before the filename
    fallback could ingest the raw plane TIFFs as separate channels."""
    def entries_of(path, dims, well):
        n_c, n_z, n_t, names = dims
        labels = channel_labels(names, n_c)
        out = []
        for c in range(n_c):
            for z in range(n_z):
                for t in range(n_t):
                    e = _container_entry(
                        path, well, site=0, channel=c, zplane=z,
                        tpoint=t, page=(c * n_z + z) * n_t + t)
                    e["channel"] = labels[c]
                    out.append(e)
        return out

    def open_either(path):
        # ONE shared scan for both suffixes: two token-less files must
        # take two different free wells, which per-suffix passes (each
        # with its own assign_container_wells) would not guarantee
        cls = OIBReader if str(path).lower().endswith(".oib") else OIFReader
        return cls(path)

    return _container_sidecar(
        source_dir, (".oif", ".oib"), open_either, "Olympus",
        lambda r: (r.n_channels, r.n_zplanes, r.n_tpoints,
                   r.channel_names),
        entries_of,
    )


# ---------------------------------------------------------------------- flex
@register_sidecar_handler("flex")
def flex_sidecar(source_dir: Path) -> "tuple[list[dict], int] | None":
    """PerkinElmer Opera/Operetta ``.flex`` containers, read by
    :class:`tmlibrary_tpu_torch.readers.FlexReader` (paged TIFF + FLEX XML in
    tag 65200) — the reference's own instrument class (high-content
    screening; upstream reads these through Bio-Formats' FlexReader).

    One file per well; unlike the other containers a flex file carries
    SEVERAL fields (sites) whose pages cycle channel-fastest, so
    ``site = page // C`` and ``page = field * C + c``.  Wells come from
    a filename token (``A01``) or the Opera numeric convention
    (``rrrcccfff…`` digit stems: first three digits = 1-based row, next
    three = column); token-less files take the next free column on row
    A.  Channel labels come from the FLEX Array names when present."""
    def opera_well(stem: str) -> "tuple[int, int] | None":
        token = parse_well_token(stem)
        if token is not None:
            return token
        digits = re.match(r"(\d{3})(\d{3})\d*$", stem)
        if digits:
            row, col = int(digits.group(1)), int(digits.group(2))
            if row >= 1 and col >= 1:
                return row - 1, col - 1
        return None

    def entries_of(path, dims, well):
        n_fields, n_c, names = dims
        labels = channel_labels(names, n_c)
        out = []
        for c in range(n_c):
            label = labels[c]
            for f in range(n_fields):
                e = _container_entry(path, well, site=f, channel=c,
                                     zplane=0, tpoint=0,
                                     page=f * n_c + c)
                e["channel"] = label
                out.append(e)
        return out

    return _container_sidecar(
        source_dir, ".flex", FlexReader, "FLEX",
        lambda r: (r.n_fields, r.n_channels, r.channel_names),
        entries_of, well_of=opera_well,
    )


def resolve_sidecars(
    src: Path, names: "list[str]", is_auto: bool,
) -> "tuple[str, list[dict], int] | None":
    """The ONE home of metaconfig's sidecar-resolution policy, shared
    with ``tmx inspect DIR``'s dry-run preview (a separate copy would
    silently drift from real ingest behavior).

    Tries ``names`` in order; returns ``(handler, entries, skipped)``
    for the first handler that resolves images, or None when none did
    (callers fall back to filename patterns).  A data-integrity conflict
    (:class:`~tmlibrary_tpu_torch.errors.VendorConflictError`) always
    surfaces; in non-auto mode a broken or image-less sidecar raises
    instead of being skipped.
    """
    for name in names:
        try:
            result = SIDECAR_HANDLERS[name](src)
        except VendorConflictError:
            # e.g. two containers claim one well: must surface, not be
            # laundered into a "no files matched" fallback error
            raise
        except MetadataError:
            if not is_auto:
                raise
            continue  # auto: a broken sidecar should not end ingest
        if result is None:
            continue  # this vendor's sidecar files are absent
        found, skipped = result
        if found:
            return name, found, skipped
        if not is_auto:
            raise MetadataError(
                f"'{name}' sidecar files exist under {src} but no "
                "image could be resolved from them (unrecognised "
                "image names or missing pixel files)"
            )
    return None

