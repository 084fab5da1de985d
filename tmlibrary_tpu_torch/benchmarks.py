"""The Cell Painting pipelines and their synthetic data.

Counterpart: ``tmlibrary_tpu/benchmarks.py:24-125,186-381``.  The port's
own copies of ``CELL_PAINTING_PIPE`` (BASELINE.json config 3:
``smooth`` → ``segment_primary`` on DAPI → ``segment_secondary`` on Actin
→ ``measure_intensity`` on both), of ``full_feature_description``
(config 4: the same segmentation, then intensity on five channels,
morphology, Haralick texture and Zernike moments) and of the numpy
generators, which draw the same random sequence as the reference's, so
both packages see the same pixels for the same seed.
"""

from __future__ import annotations

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
    return PipelineDescription.from_dict({
        "description": "Cell Painting full feature stack (config 4)",
        "input": {"channels": [
            {"name": ch, "correct": False, "align": False} for ch in channels]},
        "pipeline": pipeline,
        "output": {"objects": [{"name": "nuclei"}, {"name": "cells"}]},
    })


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
