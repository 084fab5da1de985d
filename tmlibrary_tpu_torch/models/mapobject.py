"""Mapobject types: the registry of segmented and static object classes.

Counterpart: ``tmlibrary_tpu/models/mapobject.py`` (reference
``tmlib/models/mapobject.py`` ``MapobjectType``): the type registry, a
JSON document in the store (``mapobject_types.json``, the same file in
both packages), the plate geometry jterator's ``collect`` needs for
the polygon-zoom threshold, and the static outlines of plates, wells and
sites (:func:`static_mapobjects`) that illuminati's ``collect`` writes.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np

from tmlibrary_tpu_torch.errors import MetadataError
from tmlibrary_tpu_torch.models.experiment import Experiment

#: static mapobject type names the reference auto-creates per experiment
STATIC_TYPES = ("Plates", "Wells", "Sites")


@dataclasses.dataclass(frozen=True)
class MapobjectType:
    """One class of map objects (reference ``MapobjectType`` row).

    ``ref_type`` is ``"segmented"`` for jterator outputs or one of
    ``STATIC_TYPES``'s singular forms for geometry-derived types.
    ``min_poly_zoom`` is the pyramid zoom level below which the viewer
    renders centroids instead of polygons (computed from object size in
    the reference; recorded here for the serving layer).
    """

    name: str
    ref_type: str = "segmented"
    min_poly_zoom: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "MapobjectType":
        return cls(**d)


class MapobjectTypeRegistry:
    """JSON-backed registry of an experiment's mapobject types.

    The reference keeps these as ORM rows keyed by experiment; jterator's
    collect phase inserts segmented types and ``delete_cascade`` removes a
    type with its objects.  Same operations here, against the store's
    ``mapobject_types.json``.
    """

    FILENAME = "mapobject_types.json"

    def __init__(self, root: Path):
        self.path = Path(root) / self.FILENAME

    def _read(self) -> dict[str, dict]:
        if not self.path.exists():
            return {}
        return json.loads(self.path.read_text())

    def _write(self, d: dict[str, dict]) -> None:
        self.path.write_text(json.dumps(d, indent=2, sort_keys=True))

    def register(self, mtype: MapobjectType) -> None:
        d = self._read()
        d[mtype.name] = mtype.to_dict()
        self._write(d)

    def get(self, name: str) -> MapobjectType:
        d = self._read()
        if name not in d:
            raise MetadataError(f"no mapobject type '{name}'")
        return MapobjectType.from_dict(d[name])

    def list(self) -> list[MapobjectType]:
        return [MapobjectType.from_dict(v) for v in self._read().values()]

    def names(self) -> list[str]:
        return sorted(self._read())

    def delete(self, name: str) -> None:
        """Remove a type from the registry (reference
        ``MapobjectType.delete_cascade`` also drops the object rows; the
        caller owns deleting the store's label/feature artifacts)."""
        d = self._read()
        d.pop(name, None)
        self._write(d)


#: plural static type name → the singular ``ref_type`` recorded on it
STATIC_REF_TYPES = {"Plates": "plate", "Wells": "well", "Sites": "site"}


# ------------------------------------------------------------- static geometry
def plate_grid(exp: Experiment, plate_name: str) -> tuple[int, int, int, int]:
    """(n_well_rows, n_well_cols, sites_y, sites_x) for one plate — the
    single source of truth for plate-grid geometry, shared by illuminati's
    stitching, the static outlines and the pyramid-depth computation."""
    plate = next((p for p in exp.plates if p.name == plate_name), None)
    if plate is None:
        raise MetadataError(f"no plate named '{plate_name}'")
    n_rows = max((w.row for w in plate.wells), default=0) + 1
    n_cols = max((w.column for w in plate.wells), default=0) + 1
    sy = max((s.y for w in plate.wells for s in w.sites), default=0) + 1
    sx = max((s.x for w in plate.wells for s in w.sites), default=0) + 1
    return n_rows, n_cols, sy, sx


def plate_mosaic_shape(
    exp: Experiment, plate_name: str, well_spacing: int = 0
) -> tuple[int, int]:
    """(height, width) in pixels of one plate's stitched mosaic — the
    single source of truth shared by illuminati's stitching and the
    pyramid-depth computation."""
    n_rows, n_cols, sy, sx = plate_grid(exp, plate_name)
    wh = sy * exp.site_height
    ww = sx * exp.site_width
    return (
        n_rows * wh + (n_rows - 1) * well_spacing,
        n_cols * ww + (n_cols - 1) * well_spacing,
    )


def _rect(y0: int, x0: int, y1: int, x1: int) -> np.ndarray:
    """Closed rectangle outline, (5, 2) [y, x] int32.  The winding is
    counter-clockwise in y-down image coordinates (clockwise in
    math-convention y-up axes)."""
    return np.array(
        [[y0, x0], [y1, x0], [y1, x1], [y0, x1], [y0, x0]], dtype=np.int32
    )


def static_mapobjects(
    exp: Experiment, plate_name: str, well_spacing: int = 0
) -> dict[str, list[tuple[str, np.ndarray]]]:
    """Outlines of the plate, its wells, and its sites in plate-mosaic
    pixel coordinates (reference: the static MapobjectTypes created during
    pyramid build so the viewer can draw the grid).

    ``well_spacing`` adds a pixel gutter between wells, matching
    illuminati's mosaic layout option.  Returns
    ``{"Plates"|"Wells"|"Sites": [(label, (5, 2) outline), ...]}``.
    """
    n_rows, n_cols, sy, sx = plate_grid(exp, plate_name)
    wh = sy * exp.site_height  # well height in px
    ww = sx * exp.site_width
    out: dict[str, list[tuple[str, np.ndarray]]] = {
        "Plates": [], "Wells": [], "Sites": []
    }
    plate_h = n_rows * wh + (n_rows - 1) * well_spacing
    plate_w = n_cols * ww + (n_cols - 1) * well_spacing
    out["Plates"].append((plate_name, _rect(0, 0, plate_h, plate_w)))
    plate = next(p for p in exp.plates if p.name == plate_name)
    for well in plate.wells:
        oy = well.row * (wh + well_spacing)
        ox = well.column * (ww + well_spacing)
        out["Wells"].append((well.name, _rect(oy, ox, oy + wh, ox + ww)))
        for site in well.sites:
            sy0 = oy + site.y * exp.site_height
            sx0 = ox + site.x * exp.site_width
            out["Sites"].append(
                (
                    f"{well.name}_{site.y}_{site.x}",
                    _rect(sy0, sx0, sy0 + exp.site_height, sx0 + exp.site_width),
                )
            )
    return out


def min_poly_zoom(n_levels: int, mean_object_px: float) -> int:
    """Zoom level below which polygons degrade to centroids: the level at
    which a typical object spans < ~2 display pixels (reference computes
    the same threshold from segmentation size when creating a
    MapobjectType; levels count 0 = most zoomed-out)."""
    if mean_object_px <= 0:
        return n_levels - 1
    diameter = math.sqrt(mean_object_px)
    # at level L (0 = coarsest of n_levels), scale = 2^(n_levels-1-L)
    for level in range(n_levels):
        scale = 2 ** (n_levels - 1 - level)
        if diameter / scale >= 2.0:
            return level
    return n_levels - 1
