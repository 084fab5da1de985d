"""The benchmark pipelines and their synthetic data.

Counterpart: ``tmlibrary_tpu/benchmarks.py:24-184,186-381,628-725,
759-791,795-847,861-891``.  The port's own copies of ``CELL_PAINTING_PIPE`` (BASELINE.json
config 3: ``smooth`` → ``segment_primary`` on DAPI → ``segment_secondary``
on Actin → ``measure_intensity`` on both; with ``declump: true`` the
declumping path), of ``full_feature_description`` (config 4: the same
segmentation, then intensity on five channels, morphology, Haralick
texture and Zernike moments), of ``SMOOTH_THRESHOLD_PIPE`` (config 2:
smooth → adaptive threshold → label), of ``volume_description``
(config 5, the 3-D z-stack pipeline) and of the numpy generators, which
draw the same random sequence as the reference's, so both packages see
the same pixels for the same seed; corilla's (config 1) stack and
single-thread numpy channel job, illuminati's numpy pyramid job, and
the spatial layout's well (``synthetic_mosaic_well``, ``:893-951``) with
its scipy chain (``cpu_reference_mosaic``).
The ``dl`` configuration (:func:`dl_description`) and its primary +
secondary form (:func:`dl_secondary_pipe`) run the DL segmenters.  The
reference's single-thread numpy ``dl`` site (``cpu_reference_site_dl``)
is not ported: nothing here times the CPU against the card for it.
"""

from __future__ import annotations

import time

import numpy as np

from tmlibrary_tpu_torch.jterator.description import PipelineDescription

CELL_PAINTING_PIPE = {
    "description": "Cell Painting: segment nuclei + cells, measure intensity",
    "input": {
        "channels": [
            {"name": "DAPI", "correct": False, "align": False},
            {"name": "Actin", "correct": False, "align": False},
        ]
    },
    "pipeline": [
        {
            "handles": {
                "module": "smooth",
                "input": [
                    {"name": "intensity_image", "type": "IntensityImage", "key": "DAPI"},
                    {"name": "sigma", "type": "Numeric", "value": 1.5},
                ],
                "output": [
                    {"name": "smoothed_image", "type": "IntensityImage", "key": "dapi_sm"}
                ],
            }
        },
        {
            "handles": {
                "module": "segment_primary",
                "input": [
                    {"name": "intensity_image", "type": "IntensityImage", "key": "dapi_sm"},
                    {"name": "threshold_method", "type": "Character", "value": "otsu"},
                    {"name": "smooth_sigma", "type": "Numeric", "value": 0.0},
                    {"name": "min_area", "type": "Numeric", "value": 20},
                ],
                "output": [
                    {
                        "name": "objects",
                        "type": "SegmentedObjects",
                        "key": "nuclei",
                        "objects": "nuclei",
                    }
                ],
            }
        },
        {
            "handles": {
                "module": "segment_secondary",
                "input": [
                    {"name": "primary_label_image", "type": "LabelImage", "key": "nuclei"},
                    {"name": "intensity_image", "type": "IntensityImage", "key": "Actin"},
                    {"name": "correction_factor", "type": "Numeric", "value": 0.8},
                    {"name": "n_levels", "type": "Numeric", "value": 16},
                ],
                "output": [
                    {
                        "name": "objects",
                        "type": "SegmentedObjects",
                        "key": "cells",
                        "objects": "cells",
                    }
                ],
            }
        },
        {
            "handles": {
                "module": "measure_intensity",
                "input": [
                    {"name": "objects_image", "type": "LabelImage", "key": "nuclei"},
                    {"name": "intensity_image", "type": "IntensityImage", "key": "DAPI"},
                ],
                "output": [
                    {
                        "name": "measurements",
                        "type": "Measurement",
                        "objects": "nuclei",
                        "channel": "DAPI",
                    }
                ],
            }
        },
        {
            "handles": {
                "module": "measure_intensity",
                "input": [
                    {"name": "objects_image", "type": "LabelImage", "key": "cells"},
                    {"name": "intensity_image", "type": "IntensityImage", "key": "Actin"},
                ],
                "output": [
                    {
                        "name": "measurements",
                        "type": "Measurement",
                        "objects": "cells",
                        "channel": "Actin",
                    }
                ],
            }
        },
    ],
    "output": {
        "objects": [{"name": "nuclei"}, {"name": "cells"}]
    },
}


def cell_painting_description() -> PipelineDescription:
    return PipelineDescription.from_dict(CELL_PAINTING_PIPE)


#: the five canonical Cell Painting stains (BASELINE.json config 4)
FULL_STACK_CHANNELS = ("DAPI", "Actin", "Tubulin", "ER", "Mito")


def full_feature_description(
    channels: tuple[str, ...] = FULL_STACK_CHANNELS,
    texture_levels: int = 16,
    zernike_degree: int = 6,
) -> PipelineDescription:
    """BASELINE.json config 4, the full feature stack: nuclei + cells
    segmentation as in config 3, then ``measure_intensity`` on every
    channel for both object types, ``measure_morphology`` on both,
    Haralick texture of the cells on the second channel and Zernike
    moments of the nuclei."""
    return PipelineDescription.from_dict(
        full_feature_pipe(channels, texture_levels, zernike_degree))


def full_feature_pipe(
    channels: tuple[str, ...] = FULL_STACK_CHANNELS,
    texture_levels: int = 16,
    zernike_degree: int = 6,
    correct: bool = False,
    align: bool = False,
) -> dict:
    """Config 4 as the dict a ``.pipe.json`` holds, every channel with
    ``correct`` and ``align`` as given."""
    nucleus_ch, cell_ch = channels[0], channels[1]

    def _measure(module, inputs, objects, channel=None):
        out = {"name": "measurements", "type": "Measurement", "objects": objects}
        if channel:
            out["channel"] = channel
        return {"handles": {"module": module, "input": inputs, "output": [out]}}

    def _labels(objects):
        return {"name": "objects_image", "type": "LabelImage", "key": objects}

    def _objects(key):
        return [{"name": "objects", "type": "SegmentedObjects", "key": key, "objects": key}]

    pipeline = [
        {"handles": {
            "module": "smooth",
            "input": [
                {"name": "intensity_image", "type": "IntensityImage", "key": nucleus_ch},
                {"name": "sigma", "type": "Numeric", "value": 1.5},
            ],
            "output": [{"name": "smoothed_image", "type": "IntensityImage", "key": "nuc_sm"}],
        }},
        {"handles": {
            "module": "segment_primary",
            "input": [
                {"name": "intensity_image", "type": "IntensityImage", "key": "nuc_sm"},
                {"name": "threshold_method", "type": "Character", "value": "otsu"},
                {"name": "smooth_sigma", "type": "Numeric", "value": 0.0},
                {"name": "min_area", "type": "Numeric", "value": 20},
            ],
            "output": _objects("nuclei"),
        }},
        {"handles": {
            "module": "segment_secondary",
            "input": [
                {"name": "primary_label_image", "type": "LabelImage", "key": "nuclei"},
                {"name": "intensity_image", "type": "IntensityImage", "key": cell_ch},
                {"name": "correction_factor", "type": "Numeric", "value": 0.8},
                {"name": "n_levels", "type": "Numeric", "value": 16},
            ],
            "output": _objects("cells"),
        }},
    ]
    for objects in ("nuclei", "cells"):
        for ch in channels:
            pipeline.append(_measure(
                "measure_intensity",
                [_labels(objects),
                 {"name": "intensity_image", "type": "IntensityImage", "key": ch}],
                objects, channel=ch))
    for objects in ("nuclei", "cells"):
        pipeline.append(_measure("measure_morphology", [_labels(objects)], objects))
    pipeline.append(_measure(
        "measure_texture",
        [_labels("cells"),
         {"name": "intensity_image", "type": "IntensityImage", "key": cell_ch},
         {"name": "levels", "type": "Numeric", "value": texture_levels}],
        "cells", channel=cell_ch))
    pipeline.append(_measure(
        "measure_zernike",
        [_labels("nuclei"), {"name": "degree", "type": "Numeric", "value": zernike_degree}],
        "nuclei"))
    return {
        "description": "Cell Painting full feature stack (config 4)",
        "input": {"channels": [
            {"name": ch, "correct": correct, "align": align} for ch in channels]},
        "pipeline": pipeline,
        "output": {"objects": [{"name": "nuclei"}, {"name": "cells"}]},
    }


def synthetic_full_stack_batch(
    n_sites: int,
    size: int = 256,
    n_cells: int = 12,
    channels: tuple[str, ...] = FULL_STACK_CHANNELS,
    seed: int = 0,
) -> dict[str, np.ndarray]:
    """Synthetic multi-channel Cell Painting sites, float32: nuclei in
    channel 0, cell bodies of varying radius and brightness in every
    other channel.  Draws the reference generator's random sequence."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    out = {
        ch: rng.normal(300.0, 25.0, (n_sites, size, size)).astype(np.float32)
        for ch in channels
    }
    margin = size // 10
    for s in range(n_sites):
        ys = rng.integers(margin, size - margin, n_cells)
        xs = rng.integers(margin, size - margin, n_cells)
        for y, x in zip(ys, xs):
            r_n = rng.uniform(3.5, 5.5)
            d2 = (yy - y) ** 2 + (xx - x) ** 2
            out[channels[0]][s] += 4000.0 * np.exp(-d2 / (2 * r_n**2))
            for ch in channels[1:]:
                r_c = r_n * rng.uniform(1.8, 3.0)
                amp = rng.uniform(900.0, 1800.0)
                out[ch][s] += amp * np.exp(-d2 / (2 * r_c**2))
    return {ch: np.clip(v, 0, 65535) for ch, v in out.items()}


def cell_painting_declump_description() -> PipelineDescription:
    """Config 3 with ``declump: true`` on ``segment_primary``: touching
    nuclei split by a watershed of the distance transform."""
    pipeline = [
        {"handles": {**item["handles"], "input": item["handles"]["input"] + [
            {"name": "declump", "type": "Boolean", "value": True}]}}
        if item["handles"]["module"] == "segment_primary" else item
        for item in CELL_PAINTING_PIPE["pipeline"]
    ]
    return PipelineDescription.from_dict({**CELL_PAINTING_PIPE, "pipeline": pipeline})


def synthetic_cell_painting_batch(
    n_sites: int, size: int = 256, n_cells: int = 12, seed: int = 0,
    dapi_only: bool = False,
) -> dict[str, np.ndarray]:
    """Synthetic DAPI (nuclei) + Actin (cell body) site images, float32:
    Gaussian noise around 300 plus one Gaussian splat per cell."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    dapi = rng.normal(300.0, 25.0, (n_sites, size, size)).astype(np.float32)
    actin = rng.normal(300.0, 25.0, (n_sites, size, size)).astype(np.float32)
    margin = size // 10
    for s in range(n_sites):
        ys = rng.integers(margin, size - margin, n_cells)
        xs = rng.integers(margin, size - margin, n_cells)
        for y, x in zip(ys, xs):
            r_n = rng.uniform(3.5, 5.5)
            r_c = r_n * rng.uniform(2.0, 3.0)
            d2 = (yy - y) ** 2 + (xx - x) ** 2
            dapi[s] += 4000.0 * np.exp(-d2 / (2 * r_n**2))
            if not dapi_only:
                actin[s] += 1500.0 * np.exp(-d2 / (2 * r_c**2))
    out = {"DAPI": np.clip(dapi, 0, 65535)}
    if not dapi_only:
        out["Actin"] = np.clip(actin, 0, 65535)
    return out


#: BASELINE.json config 2: the minimum end-to-end slice — smooth +
#: adaptive threshold + 8-connected labeling of single-channel sites
SMOOTH_THRESHOLD_PIPE = {
    "description": "smooth + adaptive threshold (BASELINE config 2)",
    "input": {"channels": [{"name": "DAPI", "correct": False, "align": False}]},
    "pipeline": [
        {
            "handles": {
                "module": "smooth",
                "input": [
                    {"name": "intensity_image", "type": "IntensityImage", "key": "DAPI"},
                    {"name": "sigma", "type": "Numeric", "value": 1.5},
                ],
                "output": [
                    {"name": "smoothed_image", "type": "IntensityImage", "key": "sm"}
                ],
            }
        },
        {
            "handles": {
                "module": "threshold_adaptive",
                "input": [
                    {"name": "intensity_image", "type": "IntensityImage", "key": "sm"},
                    {"name": "method", "type": "Character", "value": "mean"},
                    {"name": "kernel_size", "type": "Numeric", "value": 31},
                    {"name": "constant", "type": "Numeric", "value": 2},
                ],
                "output": [{"name": "mask", "type": "BinaryImage", "key": "mask"}],
            }
        },
        {
            "handles": {
                "module": "label",
                "input": [{"name": "mask", "type": "BinaryImage", "key": "mask"}],
                "output": [
                    {"name": "label_image", "type": "SegmentedObjects",
                     "key": "fg", "objects": "fg"}
                ],
            }
        },
    ],
}


def _dl_segment(weights: str, prob_threshold: float, extra: list, key: str) -> dict:
    return {"handles": {
        "module": "segment_dl_primary",
        "input": [
            {"name": "intensity_image", "type": "IntensityImage", "key": "DAPI"},
            {"name": "weights", "type": "Character", "value": weights},
            {"name": "prob_threshold", "type": "Numeric", "value": prob_threshold},
        ] + extra,
        "output": [{"name": "objects", "type": "SegmentedObjects", "key": key,
                    "objects": key}],
    }}


def _measure(objects: str) -> dict:
    return {"handles": {
        "module": "measure_intensity",
        "input": [
            {"name": "objects_image", "type": "LabelImage", "key": objects},
            {"name": "intensity_image", "type": "IntensityImage", "key": "DAPI"},
        ],
        "output": [{"name": "measurements", "type": "Measurement", "objects": objects,
                    "channel": "DAPI"}],
    }}


def dl_description(
    weights: str = "seed:0", prob_threshold: float = 0.6, min_area: int = 4,
) -> PipelineDescription:
    """BENCH_CONFIG ``dl`` (``tmlibrary_tpu/benchmarks.py:128``):
    ``segment_dl_primary`` (the flow-field U-Net and its decoder) on DAPI,
    then ``measure_intensity`` of the decoded objects ("cells")."""
    return PipelineDescription.from_dict({
        "description": "DL segmentation: U-Net nuclei, measure intensity",
        "input": {"channels": [{"name": "DAPI", "correct": False, "align": False}]},
        "pipeline": [
            _dl_segment(weights, prob_threshold,
                        [{"name": "min_area", "type": "Numeric", "value": min_area}], "cells"),
            _measure("cells"),
        ],
        "output": {"objects": [{"name": "cells"}]},
    })


def dl_secondary_pipe(
    weights: str = "seed:0", prob_threshold: float = 0.6, min_area: int = 4,
    correct: bool = False, align: bool = False,
) -> dict:
    """The ``dl`` configuration with both DL segmenters: nuclei by
    ``segment_dl_primary`` on DAPI, cells grown from them by
    ``segment_dl_secondary`` over the same net's probabilities, then
    ``measure_intensity`` of both on DAPI; ``correct``/``align`` set the
    DAPI channel's flags for runs over a store."""
    return {
        "description": "DL segmentation: U-Net nuclei and cells, measure intensity",
        "input": {"channels": [{"name": "DAPI", "correct": correct, "align": align}]},
        "pipeline": [
            _dl_segment(weights, prob_threshold,
                        [{"name": "min_area", "type": "Numeric", "value": min_area}], "nuclei"),
            {"handles": {
                "module": "segment_dl_secondary",
                "input": [
                    {"name": "primary_label_image", "type": "LabelImage", "key": "nuclei"},
                    {"name": "intensity_image", "type": "IntensityImage", "key": "DAPI"},
                    {"name": "weights", "type": "Character", "value": weights},
                    {"name": "prob_threshold", "type": "Numeric", "value": prob_threshold},
                ],
                "output": [{"name": "objects", "type": "SegmentedObjects", "key": "cells",
                            "objects": "cells"}],
            }},
            _measure("nuclei"),
            _measure("cells"),
        ],
        "output": {"objects": [{"name": "nuclei"}, {"name": "cells"}]},
    }


def smooth_threshold_description() -> PipelineDescription:
    return PipelineDescription.from_dict(SMOOTH_THRESHOLD_PIPE)


def volume_description(n_levels: int = 8) -> PipelineDescription:
    """BASELINE.json config 5: the 3-D z-stack pipeline — focus-weighted
    volume generation, 3-D primary segmentation (Otsu + 26-connected
    components), 3-D secondary growth by level-ordered flooding and the
    volumetric measurements of the nuclei."""
    def h(module, inputs, outputs):
        return {"handles": {"module": module, "input": inputs, "output": outputs}}

    def objects(name):
        return [{"name": "objects", "type": "SegmentedObjects", "key": name, "objects": name}]

    vol = {"name": "volume_image", "type": "IntensityImage", "key": "vol"}
    return PipelineDescription.from_dict({
        "description": "3-D volume segment+measure",
        "input": {"channels": [{"name": "DAPI", "correct": False, "zstack": True}]},
        "pipeline": [
            h("generate_volume_image",
              [{"name": "zstack", "type": "IntensityImage", "key": "DAPI"},
               {"name": "mode", "type": "Character", "value": "focus"}],
              [{"name": "volume_image", "type": "IntensityImage", "key": "vol"}]),
            h("segment_volume",
              [vol, {"name": "threshold_method", "type": "Character", "value": "otsu"}],
              objects("nuclei3d")),
            h("segment_volume_secondary",
              [vol,
               {"name": "primary_label_image", "type": "LabelImage", "key": "nuclei3d"},
               {"name": "correction_factor", "type": "Numeric", "value": 0.8},
               {"name": "n_levels", "type": "Numeric", "value": n_levels}],
              objects("cells3d")),
            h("measure_volume",
              [{"name": "objects_image", "type": "LabelImage", "key": "nuclei3d"},
               {"name": "intensity_image", "type": "IntensityImage", "key": "vol"}],
              [{"name": "measurements", "type": "Measurement", "objects": "nuclei3d"}]),
        ],
        "output": {"objects": [{"name": "nuclei3d"}, {"name": "cells3d"}]},
    })


def synthetic_volume_batch(
    n_sites: int, size: int = 128, depth: int = 16, n_cells: int = 8, seed: int = 0
) -> dict[str, np.ndarray]:
    """Synthetic ``(B, Z, H, W)`` DAPI z-stacks, float32: 3-D Gaussian
    nuclei at random depths over a noisy background.  Draws the reference
    generator's random sequence."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.mgrid[0:depth, 0:size, 0:size].astype(np.float32)
    out = rng.normal(300.0, 25.0, (n_sites, depth, size, size)).astype(np.float32)
    margin = size // 8
    for s in range(n_sites):
        for _ in range(n_cells):
            y = rng.integers(margin, size - margin)
            x = rng.integers(margin, size - margin)
            z = rng.integers(depth // 4, 3 * depth // 4)
            r_xy = rng.uniform(4.0, 6.0)
            r_z = rng.uniform(1.5, 2.5)
            out[s] += 4000.0 * np.exp(
                -(
                    ((zz - z) ** 2) / (2 * r_z**2)
                    + ((yy - y) ** 2 + (xx - x) ** 2) / (2 * r_xy**2)
                )
            )
    return {"DAPI": np.clip(out, 0, 65535)}


# ------------------------------------------------------------ corilla config
def synthetic_channel_stack(
    n_channels: int, n_sites: int, size: int, seed: int = 0
) -> np.ndarray:
    """``(C, S, H, W)`` float32 uint16-range site stack for the corilla
    benchmark (BASELINE config 1)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 5000, (n_channels, n_sites, size, size)).astype(np.float32)


def cpu_reference_channel(sites: np.ndarray) -> dict[str, np.ndarray]:
    """Single-thread numpy equivalent of one corilla channel job, in
    float64: online log-domain Welford mean/std (unshifted) and the exact
    65,536-bin raw-intensity histogram (reference
    ``OnlineStatistics.update`` per site)."""
    mean = np.zeros(sites.shape[1:], np.float64)
    m2 = np.zeros_like(mean)
    hist = np.zeros(65536, np.int64)
    for i, raw in enumerate(sites):
        x = np.log10(1.0 + raw)
        delta = x - mean
        mean += delta / (i + 1)
        m2 += delta * (x - mean)
        hist += np.bincount(np.clip(raw, 0, 65535).astype(np.int64).ravel(), minlength=65536)
    return {"mean_log": mean, "std_log": np.sqrt(m2 / max(len(sites), 1)), "hist": hist}


# ---------------------------------------------------------- illuminati config
def cpu_reference_pyramid(
    sites: np.ndarray, grid: tuple[int, int], n_levels: int, lower: float, upper: float,
) -> list[np.ndarray]:
    """Single-thread numpy equivalent of one illuminati mosaic job: stitch
    the site grid, then the level chain (2x2 mean, odd sides edge-padded),
    each level stretched to uint8 (numpy's own summation order, so a level
    can differ from the device chain's by a rounding)."""
    gy, gx = grid
    n, h, w = sites.shape
    mosaic = (sites.reshape(gy, gx, h, w).transpose(0, 2, 1, 3)
              .reshape(gy * h, gx * w).astype(np.float32))
    span = max(upper - lower, 1e-6)

    def stretch(lvl):
        return np.clip((lvl - lower) / span * 255.0, 0, 255).astype(np.uint8)

    levels = [stretch(mosaic)]
    cur = mosaic
    for _ in range(n_levels - 1):
        hh, ww = cur.shape
        if hh % 2 or ww % 2:
            cur = np.pad(cur, ((0, hh % 2), (0, ww % 2)), mode="edge")
        cur = cur.reshape(cur.shape[0] // 2, 2, cur.shape[1] // 2, 2).mean((1, 3))
        levels.append(stretch(cur))
    return levels



# ------------------------------------------------------------ spatial layout
def synthetic_mosaic_well(
    grid_y: int, grid_x: int, size: int = 256, cells_per_site: float = 8.0, seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """One well's mosaic with blobs scattered across the site seams (the
    case the spatial layout exists for), and its site tiles: ``(mosaic
    (Hm, Wm) uint16, tiles (gy*gx, size, size) uint16)``, tiles in
    row-major site order."""
    rng = np.random.default_rng(seed)
    hm, wm = grid_y * size, grid_x * size
    mosaic = rng.normal(300.0, 25.0, (hm, wm)).astype(np.float32)
    n_cells = int(cells_per_site * grid_y * grid_x)
    ys = rng.uniform(4, hm - 4, n_cells)
    xs = rng.uniform(4, wm - 4, n_cells)
    rr = rng.uniform(3.5, 5.5, n_cells)
    # local splats: a whole-mosaic gaussian per cell would be quadratic
    for y, x, r in zip(ys, xs, rr):
        rad = int(4 * r)
        y0, y1 = max(0, int(y) - rad), min(hm, int(y) + rad + 1)
        x0, x1 = max(0, int(x) - rad), min(wm, int(x) + rad + 1)
        yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
        mosaic[y0:y1, x0:x1] += 4000.0 * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * r**2))
    mosaic = np.clip(mosaic, 0, 65535).astype(np.uint16)
    tiles = (mosaic.reshape(grid_y, size, grid_x, size).transpose(0, 2, 1, 3)
             .reshape(grid_y * grid_x, size, size))
    return mosaic, np.ascontiguousarray(tiles)


def _otsu_numpy(img: np.ndarray, bins: int = 256) -> float:
    """Numpy Otsu over the same fixed bins as ``ops.threshold.otsu_value``."""
    lo, hi = float(img.min()), float(img.max())
    span = max(hi - lo, 1e-6)
    idx = np.clip(((img - lo) / span * bins).astype(np.int32), 0, bins - 1)
    hist = np.bincount(idx.ravel(), minlength=bins).astype(np.float64)
    centers = lo + (np.arange(bins) + 0.5) / bins * span
    w0 = np.cumsum(hist)
    w1 = w0[-1] - w0
    sum0 = np.cumsum(hist * centers)
    mu0 = sum0 / np.maximum(w0, 1e-12)
    mu1 = (sum0[-1] - sum0) / np.maximum(w1, 1e-12)
    between = np.where((w0 > 0) & (w1 > 0), w0 * w1 * (mu0 - mu1) ** 2, -1.0)
    return float(centers[int(np.argmax(between))])


def cpu_reference_mosaic(mosaic: np.ndarray) -> int:
    """The spatial layout's chain on one stitched mosaic with scipy:
    smooth, Otsu, 8-connected label, the per-object morphology and
    intensity statistics; returns the object count."""
    import scipy.ndimage as ndi

    img = mosaic.astype(np.float32)
    sm = ndi.gaussian_filter(img, 1.5, mode="reflect")
    labels, n = ndi.label(sm > _otsu_numpy(sm), ndi.generate_binary_structure(2, 2))
    if n:
        ids = np.arange(1, n + 1)
        np.bincount(labels.ravel())
        ndi.center_of_mass(np.ones_like(labels), labels, ids)
        ndi.find_objects(labels)
        img64 = img.astype(np.float64)
        for fn in (ndi.mean, ndi.standard_deviation, ndi.minimum, ndi.maximum, ndi.sum):
            fn(img64, labels, ids)
    return n


# ------------------------------------------------------------ analytics
#: the reference bench's analytics knobs (bench.py:1521-1700): default
#: populations, feature width and each tool's k
ANALYTICS_SIZES = (10_000, 100_000)
ANALYTICS_FEATURES = 32
ANALYTICS_PARAMS = {"knn_k": 10, "embedding_k": 15, "kmeans_k": 5, "pca_components": 2,
                    "spatial_radius": 2}


def analytics_population(n: int, n_features: int = ANALYTICS_FEATURES, seed: int = 0
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The bench's iid population: ``(x (n, F) float32, site_index (n,)
    over 64 sites, centroids (n, 2) uniform on [0, 2048))``, drawn in
    the reference's order from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, n_features)).astype(np.float32)
    site_index = rng.integers(0, 64, size=n).astype(np.int64)
    centroids = rng.uniform(0.0, 2048.0, size=(n, 2)).astype(np.float64)
    return x, site_index, centroids


def clustered_population(n: int, n_features: int = ANALYTICS_FEATURES, seed: int = 7
                         ) -> np.ndarray:
    """The bench's index-vs-brute population: round(sqrt(n)) (at least
    8) Gaussian blobs of spread 0.15."""
    rng = np.random.default_rng(seed)
    n_blobs = max(8, int(round(np.sqrt(n))))
    centers = rng.normal(size=(n_blobs, n_features))
    labels = rng.integers(0, n_blobs, size=n)
    return (centers[labels] + 0.15 * rng.normal(size=(n, n_features))).astype(np.float32)


def analytics_runners(x, site_index, centroids, device) -> dict:
    """Each tool's device op on a built matrix, as a cache miss of
    ``tmx-torch query`` runs it (store reads and Parquet writes
    excluded): name -> zero-argument callable returning the output."""
    from tmlibrary_tpu_torch.analytics import ops
    from tmlibrary_tpu_torch.analytics import spatial as asp
    from tmlibrary_tpu_torch.tools.clustering import kmeans

    p = ANALYTICS_PARAMS

    def run_spatial():
        return asp.density(asp.build_index(site_index, centroids, device=device),
                           radius_bins=p["spatial_radius"])

    def run_clustering():
        assign, cent = kmeans(x, p["kmeans_k"], device=device)
        return assign.cpu().numpy(), cent.cpu().numpy()

    return {
        "knn": lambda: ops.knn(x, p["knn_k"], device=device),
        "pca": lambda: ops.pca(x, p["pca_components"], device=device),
        "embedding": lambda: ops.spectral_embedding(x, 2, k=p["embedding_k"], device=device),
        "spatial": run_spatial,
        "clustering": run_clustering,
    }


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(_same(u, v) for u, v in zip(a, b))
    return np.array_equal(a, b)


def time_warm(fn, reps: int, sync=lambda: None) -> tuple[float, object, bool]:
    """(mean seconds of ``reps`` warm calls on the host clock, ended by
    ``sync``; the first warm call's output; whether every warm call's
    output equals it)."""
    first = fn()  # warm-up
    sync()
    same = True
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
        same = same and _same(out, first)
    sync()
    return (time.perf_counter() - t0) / reps, first, same


def measure_analytics(sizes=ANALYTICS_SIZES, n_features: int = ANALYTICS_FEATURES,
                      reps: int = 3, device: str = "cuda") -> dict:
    """``analytics_queries_per_sec``: queries/s of each tool's device op
    (knn k 10, pca 2 components, embedding k 15, spatial density radius
    2, k-means k 5) on the bench's iid populations at each ``sizes``,
    and ``index_vs_brute`` rows (brute and IVF self-sweep queries/s, the
    speedup, the build seconds, recall@10) on the clustered ones.  A
    time is the mean of ``reps`` warm calls; ``repeat_identical`` says
    whether the warm calls' outputs were bit-identical."""
    import torch

    from tmlibrary_tpu_torch.analytics import index as aidx
    from tmlibrary_tpu_torch.analytics import ops

    sync = torch.cuda.synchronize if str(device).startswith("cuda") else (lambda: None)
    per_tool: dict = {}
    identical: dict = {}
    for n in sizes:
        x, site_index, centroids = analytics_population(n, n_features)
        for tool, fn in analytics_runners(x, site_index, centroids, device).items():
            seconds, _, same = time_warm(fn, reps, sync)
            per_tool.setdefault(tool, {})[str(n)] = 1.0 / seconds
            identical.setdefault(tool, {})[str(n)] = same
    k = ANALYTICS_PARAMS["knn_k"]
    index_rows = []
    for n in sizes:
        xb = clustered_population(n, n_features)
        t0 = time.perf_counter()
        cent, mem, _ = aidx.ivf_build_arrays(xb, device=device)
        sync()
        build_s = time.perf_counter() - t0
        brute_s, _, _ = time_warm(lambda: ops.knn(xb, k, device=device)[0], reps, sync)
        ivf_s, _, _ = time_warm(
            lambda: aidx.ivf_search_arrays(xb, cent, mem, k, device=device)[0], reps, sync)
        index_rows.append({
            "n": n, "brute_qps": 1.0 / brute_s, "ivf_qps": 1.0 / ivf_s,
            "speedup": brute_s / ivf_s,
            "recall_at_k": aidx.measure_recall(xb, cent, mem, k=k, device=device),
            "build_s": build_s, "n_cells": int(cent.shape[0]), "top_p": aidx.DEFAULT_TOP_P,
            "k": k,
        })
    largest = str(max(sizes))
    return {
        "metric": "analytics_queries_per_sec",
        "value": per_tool["knn"][largest],
        "unit": f"queries/sec (knn k={k}, N={largest} x {n_features} features; "
                "per-tool breakdown in per_tool)",
        "config": "analytics",
        "device": str(device),
        "n_objects": list(sizes),
        "n_features": n_features,
        "per_tool": per_tool,
        "repeat_identical": identical,
        "index_vs_brute": index_rows,
        "timing_methodology": f"analytics-tools-v1: mean of {reps} warm calls, host clock "
                              "ended by a device sync",
    }


# --------------------------------------------------------------- ingest
#: the reference bench's ingest knobs (bench.py:1164-1310): 96 blob sites,
#: best of 3 runs, a cold source's 2 ms a plane
INGEST_SITES, INGEST_REPS, INGEST_COLD_MS = 96, 3, 2.0


def ingest_source(fmt: str, planes: np.ndarray, src) -> None:
    """The bench's source directory for one format from ``(n, H, W)``
    uint16 planes: ``tiff_raw`` one uncompressed TIFF a site (the port's
    ``ImageWriter``), ``nd2`` one container of ``n`` sequences, ``czi``
    one of ``n`` scenes (uncompressed), as the reference bench writes them."""
    from pathlib import Path

    from tmlibrary_tpu_torch import container_writers
    from tmlibrary_tpu_torch.writers import ImageWriter

    src = Path(src)
    src.mkdir(parents=True)
    if fmt == "tiff_raw":
        for i, plane in enumerate(planes):
            with ImageWriter(src / f"img_A01_s{i}_C00.tif") as w:
                w.write(plane)
    elif fmt == "nd2":
        container_writers.write_nd2(src / "plate_A01.nd2", planes[:, :, :, None])
    elif fmt == "czi":
        container_writers.write_czi(src / "scan_A01.czi", planes[:, None, :, :])
    else:
        raise ValueError(f"unknown ingest format {fmt!r}")


def time_ingest(src, root, workers: "int | None", throttle_ms: "float | None",
                reps: int = INGEST_REPS, device: str = "cuda") -> float:
    """Best of ``reps`` wall seconds of the whole imextract phase over
    ``src`` (metaconfig ``handler: auto`` first, untimed), with
    ``TMX_INGEST_WORKERS`` and ``TMX_INGEST_THROTTLE_MS`` set for the
    run (None: unset) and restored after."""
    import os
    import shutil
    from pathlib import Path

    from tmlibrary_tpu_torch.models.experiment import Experiment
    from tmlibrary_tpu_torch.models.store import ExperimentStore
    from tmlibrary_tpu_torch.workflow import get_step

    saved = {k: os.environ.get(k) for k in ("TMX_INGEST_WORKERS", "TMX_INGEST_THROTTLE_MS")}
    for key, value in (("TMX_INGEST_WORKERS", workers), ("TMX_INGEST_THROTTLE_MS", throttle_ms)):
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = str(value)
    best = float("inf")
    try:
        for rep in range(reps):
            path = Path(root) / f"exp_{rep}"
            store = ExperimentStore.create(path, Experiment(
                name="b", plates=[], channels=[], site_height=1, site_width=1))
            meta = get_step("metaconfig")(store, device=device)
            meta.init({"source_dir": str(src), "handler": "auto"})
            meta.run(0)
            ime = get_step("imextract")(store, device=device)
            ime.init({})
            batches = ime.list_batches()
            t0 = time.perf_counter()
            for j in batches:
                ime.run(j)
            best = min(best, time.perf_counter() - t0)
            shutil.rmtree(path, ignore_errors=True)
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    return best


def measure_ingest(workdir, size: int = 256, n_sites: int = INGEST_SITES,
                   reps: int = INGEST_REPS, cold_ms: float = INGEST_COLD_MS,
                   formats=("tiff_raw", "nd2", "czi"), device: str = "cuda") -> dict:
    """``imextract_ingest_mpix_per_sec``, the counterpart of the reference
    bench's ``measure_ingest``: Mpix/s of imextract's decode -> store
    path per format over ``n_sites`` config-3 DAPI sites of ``size``²
    (seed 0) with the default pool, with one worker, and from a cold
    source (``cold_ms`` a plane in the worker) pooled and with one
    worker.  The reference's LZW TIFF row is left out: the port's
    ``ImageWriter`` writes uncompressed TIFFs only."""
    import shutil
    from pathlib import Path

    workdir = Path(workdir)
    planes = np.asarray(synthetic_cell_painting_batch(n_sites, size=size, dapi_only=True)
                        ["DAPI"], np.uint16)
    mpix = n_sites * size * size / 1e6
    per_format: dict = {}
    try:
        for fmt in formats:
            src = workdir / f"src_{fmt}"
            ingest_source(fmt, planes, src)
            runs = {name: time_ingest(src, workdir / f"{fmt}_{name}", workers, throttle,
                                      reps, device)
                    for name, workers, throttle in (("pooled", None, None), ("single", 1, None),
                                                    ("cold", None, cold_ms),
                                                    ("cold_single", 1, cold_ms))}
            per_format[fmt] = {
                "mpix_per_sec": mpix / runs["pooled"],
                "single_thread_mpix_per_sec": mpix / runs["single"],
                "pool_speedup": runs["single"] / runs["pooled"],
                "cold_source_ms_per_plane": cold_ms,
                "cold_mpix_per_sec": mpix / runs["cold"],
                "cold_single_thread_mpix_per_sec": mpix / runs["cold_single"],
                "cold_pool_speedup": runs["cold_single"] / runs["cold"],
            }
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {
        "metric": "imextract_ingest_mpix_per_sec",
        "value": sum(f["mpix_per_sec"] for f in per_format.values()),
        "unit": f"Mpix/sec summed over {' + '.join(formats)} ({n_sites} blob sites of "
                f"{size}x{size} each, decode -> store)",
        "sites": n_sites,
        "site_size": size,
        "per_format": per_format,
        "timing_methodology": f"best of {reps} runs of imextract's batches, host clock",
    }
