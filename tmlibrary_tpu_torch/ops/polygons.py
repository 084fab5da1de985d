"""Host-side polygon extraction from label images.

Counterpart: ``tmlibrary_tpu/ops/polygons.py:15-93`` (reference
``tmlib/models/mapobject.py`` ``MapobjectSegmentation``): the outer
contour of every object, for the Parquet object table.  Contours are
ragged, so they are traced on the host by the Moore tracer of the port's
host library (:func:`~tmlibrary_tpu_torch.native.trace_boundary`, the
JAX package's native tracer), each object on its bounding-box crop (the
boxes come from one pass, :func:`~tmlibrary_tpu_torch.native.mosaic_morph`):
the trace starts at the object's first pixel in scan order, which the
crop keeps, so the contours are the whole image's shifted by the crop's
corner.  A failed build of the library raises; the JAX package's cv2
fallback has no counterpart (the card's machine has no cv2).
"""

from __future__ import annotations

import numpy as np

from tmlibrary_tpu_torch import native
from tmlibrary_tpu_torch.io import parquet


def labels_to_polygons(labels: np.ndarray) -> list[tuple[int, np.ndarray]]:
    """``[(label, contour)]`` for every object of an ``(H, W)`` label
    image in ascending label order, ``contour`` an ``(K, 2)`` int32 array
    of ``(y, x)`` vertices."""
    labels = np.ascontiguousarray(labels, np.int32)
    count = int(labels.max(initial=0))
    if count <= 0:
        return []
    area, _, _, ymin, ymax, xmin, xmax = native.mosaic_morph(np.maximum(labels, 0), count)
    out = []
    for lab in np.flatnonzero(area[1:]) + 1:
        y0, x0 = int(ymin[lab]), int(xmin[lab])
        crop = labels[y0:int(ymax[lab]) + 1, x0:int(xmax[lab]) + 1]
        pts = native.trace_boundary(crop, int(lab))
        if len(pts):
            out.append((int(lab), pts + np.asarray([y0, x0], np.int32)))
    return out


def polygons_to_table(polygons: list[tuple[int, np.ndarray]], site_index: int) -> dict:
    """The traced polygons as the object table's columns (``site``,
    ``label``, the vertices' mean as ``centroid_y``/``_x``,
    ``n_vertices``, and the ``contour_y``/``_x`` LIST columns), the
    reference's DataFrame column for column."""
    return {
        "site": np.full(len(polygons), int(site_index), np.int64),
        "label": np.asarray([lab for lab, _ in polygons], np.int64),
        "centroid_y": np.asarray([float(c[:, 0].mean()) for _, c in polygons], np.float64),
        "centroid_x": np.asarray([float(c[:, 1].mean()) for _, c in polygons], np.float64),
        "n_vertices": np.asarray([int(c.shape[0]) for _, c in polygons], np.int64),
        "contour_y": parquet.list_column([c[:, 0].astype(np.int64) for _, c in polygons]),
        "contour_x": parquet.list_column([c[:, 1].astype(np.int64) for _, c in polygons]),
    }


def concat_tables(tables: list[dict]) -> dict:
    """Tables of :func:`polygons_to_table` one after another."""
    return {k: (parquet.list_column([cell for t in tables for cell in t[k]])
                if tables[0][k].dtype == object
                else np.concatenate([t[k] for t in tables]))
            for k in tables[0]}
