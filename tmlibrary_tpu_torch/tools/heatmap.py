"""Heatmap tool: one feature as a continuous per-object layer.

Counterpart: ``tmlibrary_tpu/tools/heatmap.py``: the raw feature column
as the layer, min/max and the p01/p99 display window in the attributes,
and a ``plate_heatmap`` plot of the per-well means of the finite values
(a well whose values are all NaN keeps its place with ``mean`` null).
"""

from __future__ import annotations

import numpy as np

from tmlibrary_tpu_torch.errors import NotSupportedError
from tmlibrary_tpu_torch.tools.base import Plot, Tool, ToolResult, register_tool

_FAMILIES = ("Intensity", "Morphology", "Texture", "Zernike")


def well_means(ids: dict, vals: np.ndarray) -> list[dict]:
    """Every observed (plate, well_row, well_col), sorted, with the mean
    of its finite values (None when it has none)."""
    keys = list(zip(ids["plate"].tolist(), ids["well_row"].tolist(), ids["well_col"].tolist()))
    wells = sorted(set(keys))
    pos = {w: i for i, w in enumerate(wells)}
    group = np.fromiter((pos[k] for k in keys), np.int64, len(keys))
    finite = np.isfinite(vals)
    sums = np.bincount(group[finite], weights=vals[finite], minlength=len(wells))
    counts = np.bincount(group[finite], minlength=len(wells))
    return [{"plate": w[0], "well_row": int(w[1]), "well_col": int(w[2]),
             "mean": float(s / c) if c else None}
            for w, s, c in zip(wells, sums, counts)]


@register_tool("heatmap")
class Heatmap(Tool):
    """One feature as a continuous per-object layer plus a per-well
    plate_heatmap plot.  Payload: ``objects_name``, ``feature``."""

    def process(self, payload: dict) -> ToolResult:
        objects_name = payload["objects_name"]
        feature = payload.get("feature")
        if not feature:
            raise NotSupportedError("heatmap needs a 'feature'")
        fs = self.feature_store(objects_name)
        if feature not in fs.features:
            raise NotSupportedError(
                f"feature '{feature}' not found (have: "
                f"{sorted(c for c in fs.features if c.startswith(_FAMILIES))})")
        ids = fs.identity()
        vals = fs.column(feature).astype(np.float64)
        ids["value"] = vals
        plots = []
        if len(vals):
            plots.append(Plot(type="plate_heatmap",
                              figure={"feature": feature, "wells": well_means(ids, vals)}))
        finite = vals[np.isfinite(vals)]
        return ToolResult(
            tool=self.name, objects_name=objects_name, layer_type="continuous", values=ids,
            attributes={
                "feature": feature,
                "min": float(finite.min()) if len(finite) else 0.0,
                "max": float(finite.max()) if len(finite) else 0.0,
                "p01": float(np.percentile(finite, 1)) if len(finite) else 0.0,
                "p99": float(np.percentile(finite, 99)) if len(finite) else 0.0,
                "n_objects": int(len(vals)),
            },
            plots=plots,
        )
