"""metaconfig: configure experiment metadata from microscope files.

Counterpart: ``tmlibrary_tpu/workflow/steps/metaconfig.py`` (reference
``tmlib/workflow/metaconfig/`` ``MetadataConfigurator``): vendor sidecar
metadata (:mod:`~tmlibrary_tpu_torch.workflow.steps.vendors`) or one of
three filename styles (``default``, ``cellvoyager``, ``incell``) give a
canonical layout -- plates, wells, sites with grid coordinates,
channels, cycles, z-planes -- which becomes the store's manifest, plus
the ``file_mapping.json`` that imextract consumes (reference
``ImageFileMapping``) and the merged ``experiment.ome.xml``, both the
same text as the JAX package's for the same directory.

Host work, one batch.  The site-shape probe reads the first file's
header through the port's TIFF reader or PNG codec where the JAX package
decodes it with ``cv2.imread``; a microscope container gives its planes'
shape (:func:`~tmlibrary_tpu_torch.readers.container_dimensions`).
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from pathlib import Path

from tmlibrary_tpu_torch.errors import MetadataError
from tmlibrary_tpu_torch.models.experiment import Channel, Experiment, Plate, Site, Well
from tmlibrary_tpu_torch.models.store import ExperimentStore
from tmlibrary_tpu_torch.workflow.api import Step
from tmlibrary_tpu_torch.workflow.args import Argument, ArgumentCollection
from tmlibrary_tpu_torch.workflow.registry import register_step

#: default handler: one named-group regex over the filename
DEFAULT_PATTERN = (
    r"(?:(?P<plate>[A-Za-z0-9]+)_)?"
    r"(?P<well>[A-Z]{1,2}\d{2})_"
    r"s(?P<site>\d+)_"
    r"(?:c(?P<cycle>\d+)_)?"
    r"(?:t(?P<tpoint>\d+)_)?"
    r"(?:z(?P<zplane>\d+)_)?"
    r"(?P<channel>[A-Za-z0-9\-]+)"
    r"\.(?:tif|tiff|png)$"
)

#: Yokogawa CellVoyager: ...__W0001F001T0001Z01C1.tif style
CELLVOYAGER_PATTERN = (
    r"(?P<prefix>.*?)_?"
    r"W(?P<well_num>\d+)"
    r"F(?P<site>\d+)"
    r"T(?P<tpoint>\d+)"
    r"Z(?P<zplane>\d+)"
    r"C(?P<channel>\d+)"
    r"\.(?:tif|tiff|png)$"
)


#: GE/Cytiva InCell Analyzer export convention ("A - 1(fld 1 wv
#: Blue - FITC).tif"; z-stack/timelapse exports add "z N" / "tp N"
#: tokens inside the parens, order varying by InCell version — the
#: style branch tokenizes the paren body instead of pinning an order)
INCELL_PATTERN = (
    r"^(?P<wrow>[A-Z]{1,2}) - (?P<wcol>\d{1,2})"
    r"\((?P<tokens>[^)]*\bfld\b[^)]*)\)"
    r"\.(?:tif|tiff)$"
)


def _parse_incell_tokens(tokens: str) -> "dict | None":
    """'fld 1 wv Blue - FITC z 3' → {site, channel, zplane, tpoint}.
    The wv value runs until a trailing ``z N``/``tp N`` token or the
    end (channel names like 'Blue - FITC' contain spaces/dashes but
    never a bare z/tp-digit token)."""
    site = re.search(r"\bfld (\d+)", tokens)
    wv = re.search(r"\bwv (.+?)(?= \b(?:z|tp) \d|$)", tokens)
    if not site or not wv:
        return None
    z = re.search(r"\bz (\d+)", tokens)
    tp = re.search(r"\btp (\d+)", tokens)
    return {
        "site": int(site.group(1)),
        "channel": wv.group(1).strip(),
        "zplane": int(z.group(1)) if z else 1,
        "tpoint": int(tp.group(1)) if tp else 1,
    }


#: the well-name grammar ('B03', 'AA12'): single source of truth shared by
#: parse_well_name and the vendor sidecar handlers' token search
WELL_NAME_PATTERN = r"([A-Z]{1,2})(\d{1,2})"


def parse_well_name(name: str) -> tuple[int, int]:
    """'B03' → (row=1, col=2)."""
    m = re.fullmatch(WELL_NAME_PATTERN, name)
    if not m:
        raise MetadataError(f"cannot parse well name '{name}'")
    letters, digits = m.groups()
    row = 0
    for ch in letters:
        row = row * 26 + (ord(ch) - ord("A") + 1)
    return row - 1, int(digits) - 1


def well_num_to_rowcol(num: int, plate_cols: int = 24) -> tuple[int, int]:
    """CellVoyager numeric well index (1-based, row-major) → (row, col)."""
    return (num - 1) // plate_cols, (num - 1) % plate_cols


def probe_shape(path: str) -> tuple[int, int]:
    """(height, width) of a site from its file's header: a container
    gives its planes' (:func:`~tmlibrary_tpu_torch.readers.container_dimensions`),
    a TIFF gives its first page's, a PNG its image's; anything else
    raises :class:`MetadataError`."""
    from tmlibrary_tpu_torch.io import png
    from tmlibrary_tpu_torch.readers import container_dimensions, tiff_dimensions

    dims = container_dimensions(path) or tiff_dimensions(path)
    if dims is None and png.is_png(path):
        dims = png.info(path)[:2]
    if dims is None:
        raise MetadataError(f"cannot read probe image {path}")
    return dims


class FilenameHandler:
    """Parse one file path into a canonical index dict."""

    def __init__(self, pattern: str, style: str, plate_cols: int = 24,
                 sites_per_well_x: int | None = None):
        self.regex = re.compile(pattern)
        self.style = style
        self.plate_cols = plate_cols
        self.sites_per_well_x = sites_per_well_x

    def parse(self, filename: str) -> dict | None:
        m = self.regex.search(filename)
        if not m:
            return None
        g = m.groupdict()
        if self.style == "incell":
            row = 0
            for ch in g["wrow"]:
                row = row * 26 + (ord(ch) - ord("A") + 1)
            parsed = _parse_incell_tokens(g["tokens"])
            if parsed is None:
                return None
            return {
                "plate": "plate00",
                "well_row": row - 1,
                "well_col": int(g["wcol"]) - 1,
                "site": parsed["site"] - 1,  # fld is 1-based
                "channel": parsed["channel"],
                "cycle": 0,
                "tpoint": parsed["tpoint"] - 1,
                "zplane": parsed["zplane"] - 1,
            }
        if self.style == "cellvoyager":
            row, col = well_num_to_rowcol(int(g["well_num"]), self.plate_cols)
        else:
            row, col = parse_well_name(g["well"])
        return {
            "plate": g.get("plate") or "plate00",
            "well_row": row,
            "well_col": col,
            "site": int(g["site"]) - (1 if self.style == "cellvoyager" else 0),
            "channel": str(g["channel"]),
            "cycle": int(g.get("cycle") or 0),
            "tpoint": int(g.get("tpoint") or (1 if self.style == "cellvoyager" else 0))
            - (1 if self.style == "cellvoyager" else 0),
            "zplane": int(g.get("zplane") or (1 if self.style == "cellvoyager" else 0))
            - (1 if self.style == "cellvoyager" else 0),
        }


@register_step("metaconfig")
class MetadataConfigurator(Step):
    """Build the experiment manifest + file mapping from a source directory."""

    batch_args = ArgumentCollection(
        Argument("source_dir", str, required=True,
                 help="directory of microscope image files"),
        Argument("handler", str, default="default",
                 choices=("default", "cellvoyager", "incell", "omexml",
                          "metamorph", "harmony", "imagexpress", "scanr",
                          "leica", "nd2", "czi", "lif", "ngff", "dv",
                          "ims", "stk", "lsm", "olympus", "flex", "auto"),
                 help="vendor metadata handler (sidecar files preferred, "
                      "filename patterns as fallback)"),
        Argument("pattern", str, default=None,
                 help="override the handler's filename regex"),
        Argument("sites_per_well_x", int, default=None,
                 help="well grid width in sites (default: square-ish)"),
        Argument("plate_cols", int, default=24,
                 help="plate width in wells (cellvoyager numeric wells)"),
    )

    MAPPING_FILE = "file_mapping.json"

    def delete_previous_output(self) -> None:
        # the persisted file mapping and merged OME-XML, or a later
        # imextract would silently extract against a stale mapping
        for name in (self.MAPPING_FILE, "experiment.ome.xml"):
            (self.step_dir / name).unlink(missing_ok=True)

    def create_batches(self, args):
        # metadata configuration is one unit of host work
        return [{"source_dir": args["source_dir"]}]

    def run_batch(self, batch: dict) -> dict:
        args = batch["args"]
        src = Path(args["source_dir"])
        if not src.is_dir():
            raise MetadataError(f"source directory not found: {src}")

        # sidecar metadata (CellVoyager .mlf/.mes, companion OME-XML) wins
        # over filename parsing when present — reference metaconfig likewise
        # prefers vendor metadata files over filename heuristics.  An
        # explicit --pattern overrides everything: the user is naming the
        # files to ingest, so sidecars must not widen the selection.
        from tmlibrary_tpu_torch.workflow.steps.vendors import SIDECAR_HANDLERS

        entries: list[dict] | None = None
        skipped = 0
        use_sidecars = not args.get("pattern") and (
            args["handler"] in SIDECAR_HANDLERS or args["handler"] == "auto"
        )
        if use_sidecars:
            from tmlibrary_tpu_torch.workflow.steps.vendors import resolve_sidecars

            is_auto = args["handler"] == "auto"
            names = list(SIDECAR_HANDLERS) if is_auto else [args["handler"]]
            resolved = resolve_sidecars(src, names, is_auto)
            if resolved is not None:
                _, entries, skipped = resolved
        if entries is None and use_sidecars and args["handler"] == "omexml":
            raise MetadataError(f"no companion OME-XML files found under {src}")

        if entries is None:  # filename-pattern fallback
            style = (
                args["handler"]
                if args["handler"] in ("cellvoyager", "incell")
                else "default"
            )
            # --handler auto with no sidecars: try every filename style
            # and keep the one matching the MOST files (InCell and
            # CellVoyager export names cannot match the default pattern;
            # first-match-wins would let one stray default-named file in
            # a vendor export dir shadow the real style)
            styles = (
                [("default", DEFAULT_PATTERN),
                 ("cellvoyager", CELLVOYAGER_PATTERN),
                 ("incell", INCELL_PATTERN)]
                if args["handler"] == "auto" and not args.get("pattern")
                else [(style, args["pattern"] or {
                    "cellvoyager": CELLVOYAGER_PATTERN,
                    "incell": INCELL_PATTERN,
                }.get(style, DEFAULT_PATTERN))]
            )
            files = [p for p in sorted(src.rglob("*")) if p.is_file()]
            entries, skipped = [], len(files)
            for sname, pattern in styles:
                handler = FilenameHandler(pattern, sname, args["plate_cols"])
                cand = []
                for path in files:
                    parsed = handler.parse(path.name)
                    if parsed is None:
                        continue
                    parsed["path"] = str(path)
                    cand.append(parsed)
                if len(cand) > len(entries):
                    entries, skipped = cand, len(files) - len(cand)
        if not entries:
            raise MetadataError(
                f"no files in {src} matched the '{args['handler']}' pattern"
            )
        self._linearise_sites(entries, args)

        manifest = self._build_manifest(entries, args)
        store = ExperimentStore.create(self.store.root, manifest)
        # refresh our store handle's manifest
        self.store.experiment = manifest
        self.store._site_index = store._site_index

        mapping = self._build_mapping(entries, manifest)
        (self.step_dir / self.MAPPING_FILE).write_text(json.dumps(mapping))
        # parity artifact: merged metadata as OME-XML (reference metaconfig
        # normalises everything into OME-XML before layout derivation)
        from tmlibrary_tpu_torch.workflow.steps.omexml import write_ome_xml

        (self.step_dir / "experiment.ome.xml").write_text(write_ome_xml(manifest))
        return {
            "n_files": len(entries),
            "n_skipped": skipped,
            "n_sites": manifest.n_sites,
            "n_channels": manifest.n_channels,
        }

    @staticmethod
    def _linearise_sites(entries: list[dict], args) -> None:
        """Collapse explicit (site_y, site_x) grid coords to linear indices.

        Sidecar handlers emit stage-position-derived grid coordinates;
        filename handlers emit linear indices.  Everything downstream works
        on the linear index + a well grid width.
        """
        if not any("site_y" in e for e in entries):
            if any(e.get("site") is None for e in entries):
                raise MetadataError(
                    "sidecar metadata provided neither site indices nor "
                    "grid coordinates for some images"
                )
            return
        if not all("site_y" in e for e in entries):
            # mixed basis (some records lacked stage positions): grid-derived
            # and field-index site numbers would collide, so fall back to the
            # always-present field index for every entry — unless an entry
            # has no field index at all (grid was its only address).
            if any(e.get("site") is None for e in entries):
                raise MetadataError(
                    "inconsistent site addressing in sidecar metadata: some "
                    "images carry only grid coordinates, others only site "
                    "indices — cannot merge them into one layout"
                )
            for e in entries:
                e.pop("site_y", None)
                e.pop("site_x", None)
            return
        derived = max(e["site_x"] for e in entries) + 1
        explicit = args.get("sites_per_well_x")
        if explicit and explicit < derived:
            raise MetadataError(
                f"sites_per_well_x={explicit} is narrower than the "
                f"stage-position-derived well grid ({derived} columns)"
            )
        spw_x = explicit or derived
        for e in entries:
            e["site"] = e["site_y"] * spw_x + e["site_x"]
        if not explicit:
            args["sites_per_well_x"] = spw_x

    # ------------------------------------------------------------------ build
    def _build_manifest(self, entries: list[dict], args) -> Experiment:
        channels = sorted({e["channel"] for e in entries})
        n_cycles = max(e["cycle"] for e in entries) + 1
        n_tpoints = max(e["tpoint"] for e in entries) + 1
        n_zplanes = max(e["zplane"] for e in entries) + 1

        # site linear index -> (y, x) grid within well
        sites_per_well = max(e["site"] for e in entries) + 1
        spw_x = args["sites_per_well_x"] or int(round(sites_per_well**0.5)) or 1
        spw_y = -(-sites_per_well // spw_x)

        by_plate: dict[str, set[tuple[int, int]]] = defaultdict(set)
        for e in entries:
            by_plate[e["plate"]].add((e["well_row"], e["well_col"]))

        site_objs = tuple(
            Site(y=i // spw_x, x=i % spw_x) for i in range(sites_per_well)
        )
        plates = [
            Plate(
                name=pname,
                wells=tuple(
                    Well(row=r, column=c, sites=site_objs)
                    for r, c in sorted(wells)
                ),
            )
            for pname, wells in sorted(by_plate.items())
        ]

        h, w = probe_shape(entries[0]["path"])

        return Experiment(
            name=self.store.experiment.name,
            plates=plates,
            channels=[Channel(index=i, name=n) for i, n in enumerate(channels)],
            site_height=int(h),
            site_width=int(w),
            n_cycles=n_cycles,
            n_tpoints=n_tpoints,
            n_zplanes=n_zplanes,
        )

    def _build_mapping(self, entries: list[dict], manifest: Experiment) -> list[dict]:
        """Reference ``ImageFileMapping``: file path → store coordinates."""
        channel_index = {c.name: c.index for c in manifest.channels}
        spw_x = max(s.x for p in manifest.plates for w in p.wells for s in w.sites) + 1
        from tmlibrary_tpu_torch.models.experiment import SiteRef

        mapping = []
        for e in entries:
            ref = SiteRef(
                plate=e["plate"],
                well_row=e["well_row"],
                well_column=e["well_col"],
                site_y=e["site"] // spw_x,
                site_x=e["site"] % spw_x,
            )
            rec = {
                "path": e["path"],
                "site_index": self.store.site_linear_index(ref),
                "cycle": e["cycle"],
                "channel": channel_index[e["channel"]],
                "tpoint": e["tpoint"],
                "zplane": e["zplane"],
            }
            if "page" in e:  # multi-page OME-TIFF plane
                rec["page"] = e["page"]
            mapping.append(rec)
        return mapping

    def load_mapping(self) -> list[dict]:
        path = self.step_dir / self.MAPPING_FILE
        if not path.exists():
            raise MetadataError("file mapping missing — run metaconfig first")
        return json.loads(path.read_text())
