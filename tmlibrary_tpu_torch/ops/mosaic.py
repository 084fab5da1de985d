"""Ragged features of a whole-well label mosaic (the spatial layout).

Counterpart: the feature table of
``tmlibrary_tpu/workflow/steps/jterator.py`` ``_persist_mosaic_objects``
(``:1073-1163``), with ``native.mosaic_morph_host`` (``:1225``),
``_mosaic_intensity_stats`` (``:36-44``) and
``ops/measure.py:1091`` ``zernike_host_features``.  A mosaic's object
count is only known after labeling, so nothing is padded to a capacity:
one host pass over the mosaic accumulates each object's area, centroid
sums and bounding box, one more per channel its intensity sum, sum of
squares, minimum and maximum, all in float64 as the reference does
(centroid sums of ``y`` reach ``H * area``, beyond float32's integers at
plate scale), in the port's host library
(:func:`~tmlibrary_tpu_torch.native.mosaic_morph`,
:func:`~tmlibrary_tpu_torch.native.mosaic_intensity`).  Solidity takes
the host hulls (:func:`~tmlibrary_tpu_torch.native.solidity`) and the
Zernike moments the reference's row-blocked numpy pass.  The columns are
the reference's, in its order, bit for bit.
"""

from __future__ import annotations

import numpy as np

from tmlibrary_tpu_torch import native
from tmlibrary_tpu_torch.ops.measure import _zernike_coeffs

INTENSITY_STATS = ("mean", "sum", "std", "min", "max")


def morphology_columns(labels: np.ndarray, count: int) -> dict[str, np.ndarray]:
    """Area, centroid, bounding-box size and solidity of objects
    ``1..count``, float64."""
    area_i, cy_sum, cx_sum, ymin, ymax, xmin, xmax = native.mosaic_morph(labels, count)
    area = area_i[1:].astype(np.float64)
    denom = np.maximum(area, 1)
    solidity = (native.solidity(labels, count, areas=area).astype(np.float64)
                if count else np.zeros(0))
    return {
        "Morphology_area": area,
        "Morphology_centroid_y": cy_sum[1:] / denom,
        "Morphology_centroid_x": cx_sum[1:] / denom,
        "Morphology_bbox_height": (ymax[1:] - ymin[1:] + 1).astype(np.float64),
        "Morphology_bbox_width": (xmax[1:] - xmin[1:] + 1).astype(np.float64),
        "Morphology_solidity": solidity,
    }


def intensity_columns(labels: np.ndarray, values: np.ndarray, count: int,
                      area: np.ndarray, channel: str) -> dict[str, np.ndarray]:
    """``Intensity_{mean,sum,std,min,max}_<channel>`` of objects
    ``1..count`` over a stitched channel; empty columns for no objects."""
    if count == 0:
        return {f"Intensity_{s}_{channel}": np.zeros(0) for s in INTENSITY_STATS}
    s, q, mn, mx = native.mosaic_intensity(labels, values, count)
    denom = np.maximum(area, 1)
    mean = s[1:] / denom
    var = np.maximum(q[1:] / denom - mean * mean, 0.0)
    return {
        f"Intensity_mean_{channel}": mean,
        f"Intensity_sum_{channel}": s[1:],
        f"Intensity_std_{channel}": np.sqrt(var),
        f"Intensity_min_{channel}": np.where(area > 0, mn[1:], 0.0),
        f"Intensity_max_{channel}": np.where(area > 0, mx[1:], 0.0),
    }


def zernike_host_features(labels: np.ndarray, count: int, degree: int = 9,
                          row_block: int = 512) -> np.ndarray:
    """Zernike moment magnitudes of objects ``1..count`` of a label
    mosaic, ``(count, n_table)`` float32 in :func:`_zernike_coeffs`
    order: each object's pixels on its own unit disk (centroid and
    largest radius), projected on the basis, mass-normalised,
    ``* (n + 1) / pi``; three passes over row blocks of ``row_block``
    rows, so transient memory stays ``O(row_block * W + count)``."""
    labels = np.asarray(labels)
    table = _zernike_coeffs(degree)
    out = np.zeros((count, len(table)), np.float32)
    if count == 0:
        return out
    h, w = labels.shape
    colf = np.arange(w, dtype=np.float64)

    area = np.zeros(count + 1)
    ysum = np.zeros(count + 1)
    xsum = np.zeros(count + 1)
    for y0 in range(0, h, row_block):
        blk = labels[y0:y0 + row_block]
        flat = blk.ravel()
        area += np.bincount(flat, minlength=count + 1)
        rows = np.repeat(np.arange(y0, y0 + blk.shape[0], dtype=np.float64), w)
        xsum += np.bincount(flat, weights=np.tile(colf, blk.shape[0]), minlength=count + 1)
        ysum += np.bincount(flat, weights=rows, minlength=count + 1)
    safe_a = np.maximum(area[1:], 1.0)
    cy = np.concatenate([[0.0], ysum[1:] / safe_a])
    cx = np.concatenate([[0.0], xsum[1:] / safe_a])

    r2_max = np.zeros(count + 1)
    for y0 in range(0, h, row_block):
        blk = labels[y0:y0 + row_block]
        ys, xs = np.nonzero(blk)
        if not len(ys):
            continue
        lab = blk[ys, xs]
        dy = (ys + y0) - cy[lab]
        dx = xs - cx[lab]
        np.maximum.at(r2_max, lab, dy * dy + dx * dx)
    r_obj = np.concatenate([
        [1.0], np.sqrt(np.maximum(np.where(area[1:] > 0, r2_max[1:], 1.0), 1.0))])

    re_acc = np.zeros((len(table), count + 1))
    im_acc = np.zeros((len(table), count + 1))
    for y0 in range(0, h, row_block):
        blk = labels[y0:y0 + row_block]
        ys, xs = np.nonzero(blk)
        if not len(ys):
            continue
        lab = blk[ys, xs]
        dy = (ys + y0) - cy[lab]
        dx = xs - cx[lab]
        rho = np.sqrt(dy * dy + dx * dx) / r_obj[lab]
        theta = np.arctan2(dy, dx)
        ok = (rho <= 1.0).astype(np.float64)
        rho_pow = [np.ones_like(rho)]
        for _ in range(degree):
            rho_pow.append(rho_pow[-1] * rho)
        cos_m = [np.ones_like(theta)]
        sin_m = [np.zeros_like(theta)]
        for m_ in range(1, degree + 1):
            cos_m.append(np.cos(m_ * theta))
            sin_m.append(np.sin(m_ * theta))
        for idx, (n, m_, coeffs) in enumerate(table):
            radial = np.zeros_like(rho)
            for k, c in enumerate(coeffs):
                radial = radial + float(c) * rho_pow[n - 2 * k]
            base = radial * ok
            re_acc[idx] += np.bincount(lab, weights=base * cos_m[m_], minlength=count + 1)
            im_acc[idx] += np.bincount(lab, weights=base * sin_m[m_], minlength=count + 1)
    for idx, (n, m_, _) in enumerate(table):
        mag = np.sqrt(re_acc[idx, 1:] ** 2 + im_acc[idx, 1:] ** 2) * (n + 1) / np.pi / safe_a
        out[:, idx] = np.where(area[1:] > 0, mag, 0.0)
    return out


def mosaic_feature_table(labels: np.ndarray, count: int, well: tuple, channels,
                         zernike_degree: int) -> dict[str, np.ndarray]:
    """The well's feature shard: site columns (``site_index``, ``site_y``
    and ``site_x`` -1: a mosaic object may span sites), ``label``,
    morphology, intensity of every ``(name, stitch)`` in ``channels``
    (``stitch()`` returns the channel's mosaic, called one channel at a
    time and only when there are objects) and
    Zernike moments up to ``zernike_degree`` (0: none)."""
    plate, well_row, well_col = well
    cols: dict[str, np.ndarray] = {
        "site_index": np.full(count, -1, np.int64),
        "plate": np.full(count, str(plate), dtype=object).astype(str),
        "well_row": np.full(count, int(well_row), np.int64),
        "well_col": np.full(count, int(well_col), np.int64),
        "site_y": np.full(count, -1, np.int64),
        "site_x": np.full(count, -1, np.int64),
        "label": np.arange(1, count + 1, dtype=np.int64),
    }
    cols.update(morphology_columns(labels, count))
    area = cols["Morphology_area"]
    for name, stitch in channels:
        cols.update(intensity_columns(labels, stitch() if count else None, count, area, name))
    if zernike_degree > 0:
        zern = zernike_host_features(labels, count, zernike_degree)
        for z_idx, (n_z, m_z, _) in enumerate(_zernike_coeffs(zernike_degree)):
            cols[f"Zernike_{n_z}_{m_z}"] = zern[:, z_idx].astype(np.float64)
    return cols
