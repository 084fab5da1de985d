"""Module registry and the ported module implementations.

Counterpart: ``tmlibrary_tpu/jterator/modules.py:34-344`` and the DL
segmenters at ``:727-812`` (reference: the external ``jtmodules``
package).  Modules register under a name and a
``backend`` key; the descriptions written for the JAX package name
``backend: tpu`` (the default), so the port registers its twins under
the same key and an unchanged ``.pipe`` description runs on either
package.

Module contract: ``fn(**kwargs) -> dict`` mapping output-handle names to
tensors (or, for ``Measurement`` outputs, to ``{feature: (B, max_objects)
tensor}`` dicts).  Array kwargs are ``(B, H, W)`` batches, or ``(B, Z, H,
W)`` for the volume modules; everything else is a constant from the
handle description.  A module that drops objects beyond ``max_objects``
before a filter may also return ``"<output name>" + FOUND``: the ``(B,)``
number of objects it found before the clip (the workflow step's capacity
router escalates on it).  Outputs named ``MODULE_QC_PREFIX + <stat>`` are
diagnostic streams, not handles: ``build_site_fn(collect_diagnostics=True)``
gathers them for the QC session.
"""

from __future__ import annotations

import inspect
import math
from typing import Callable

import torch

from tmlibrary_tpu_torch.errors import NotSupportedError, RegistryError
from tmlibrary_tpu_torch.ops import label as label_ops
from tmlibrary_tpu_torch.ops import smooth as smooth_ops
from tmlibrary_tpu_torch.ops import threshold as threshold_ops
from tmlibrary_tpu_torch.ops._exact import div

#: suffix of a segmentation output's pre-clip object count
FOUND = "__found"

#: name -> backend -> (fn, version)
_REGISTRY: dict[str, dict[str, tuple[Callable, str]]] = {}


def register_module(name: str, version: str = "0.1.0", backend: str = "tpu"):
    def deco(fn: Callable) -> Callable:
        _REGISTRY.setdefault(name, {})[backend] = (fn, version)
        return fn

    return deco


def get_module(name: str, backend: str = "tpu") -> Callable:
    try:
        return _REGISTRY[name][backend][0]
    except KeyError:
        have = {n: list(b) for n, b in _REGISTRY.items()}
        raise RegistryError(
            f"no module '{name}' for backend '{backend}' (registered: {have})"
        ) from None


def module_accepts(name: str, backend: str, kwarg: str) -> bool:
    fn = get_module(name, backend)
    params = inspect.signature(fn).parameters
    return kwarg in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
    )


# --------------------------------------------------------------------------
# module implementations
# --------------------------------------------------------------------------


@register_module("smooth")
def smooth(intensity_image, method: str = "gaussian", sigma: float = 2.0, size: int = 3):
    """Smoothing (reference ``jtmodules/smooth.py``); the gaussian and
    average methods are ported, median and bilateral are not."""
    if method == "gaussian":
        out = smooth_ops.gaussian_smooth(intensity_image, sigma)
    elif method == "average":
        out = smooth_ops.uniform_smooth(intensity_image, size)
    elif method in ("median", "bilateral"):
        raise NotSupportedError(f"smooth method '{method}' is not ported yet")
    else:
        raise ValueError(f"unknown smooth method '{method}'")
    return {"smoothed_image": out}


@register_module("threshold_manual")
def threshold_manual(intensity_image, threshold: float = 0.0):
    """Reference ``jtmodules/threshold_manual.py``."""
    return {"mask": threshold_ops.threshold_manual(intensity_image, threshold)}


@register_module("threshold_adaptive")
def threshold_adaptive(
    intensity_image,
    method: str = "gaussian",
    kernel_size: int = 31,
    constant: float = 0.0,
    min_threshold: float | None = None,
    max_threshold: float | None = None,
):
    """Reference ``jtmodules/threshold_adaptive.py``."""
    return {
        "mask": threshold_ops.threshold_adaptive(
            intensity_image,
            method=method,
            kernel_size=kernel_size,
            constant=constant,
            min_threshold=min_threshold,
            max_threshold=max_threshold,
        )
    }


@register_module("threshold_otsu")
def threshold_otsu(intensity_image, correction_factor: float = 1.0, bins: int = 256):
    """Reference ``jtmodules/threshold_otsu.py``."""
    return {
        "mask": threshold_ops.threshold_otsu(
            intensity_image, bins=bins, correction_factor=correction_factor
        )
    }


@register_module("label")
def label(mask, connectivity: int = 8):
    """Reference ``jtmodules/label.py``."""
    return {"label_image": label_ops.label(mask, connectivity)}


@register_module("fill")
def fill(mask):
    """Reference ``jtmodules/fill.py`` (fill holes in binary mask)."""
    return {"filled_mask": label_ops.fill_holes(mask)}


@register_module("segment_primary")
def segment_primary(
    intensity_image,
    threshold_method: str = "otsu",
    threshold_value: float = 0.0,
    correction_factor: float = 1.0,
    kernel_size: int = 31,
    constant: float = 0.0,
    smooth_sigma: float = 1.0,
    fill: bool = True,
    min_area: int = 0,
    max_area: int | None = None,
    declump: bool = False,
    declump_min_distance: int = 5,
    max_objects: int = 256,
):
    """Reference ``jtmodules/segment_primary.py`` (nuclei)."""
    from tmlibrary_tpu_torch.ops.segment_primary import segment_primary as _sp

    labels, _count, found = _sp(
        intensity_image,
        threshold_method=threshold_method,
        threshold_value=threshold_value,
        correction_factor=correction_factor,
        kernel_size=kernel_size,
        constant=constant,
        smooth_sigma=smooth_sigma,
        fill=fill,
        min_area=min_area,
        max_area=max_area,
        declump=declump,
        declump_min_distance=declump_min_distance,
        max_objects=max_objects,
        with_found=True,
    )
    return {"objects": labels, "objects" + FOUND: found}


@register_module("segment_secondary")
def segment_secondary(
    primary_label_image,
    intensity_image,
    method: str = "watershed",
    threshold_method: str = "otsu",
    threshold_value: float = 0.0,
    correction_factor: float = 1.0,
    n_levels: int = 32,
):
    """Reference ``jtmodules/segment_secondary.py`` (cells grown from
    nuclei seeds, same label ids as seeds)."""
    from tmlibrary_tpu_torch.ops.segment_secondary import watershed_from_seeds

    img = intensity_image.to(torch.float32)
    if threshold_method == "otsu":
        mask = threshold_ops.threshold_otsu(img, correction_factor=correction_factor)
    elif threshold_method == "manual":
        mask = threshold_ops.threshold_manual(img, threshold_value)
    else:
        raise ValueError(f"unknown threshold method '{threshold_method}'")
    if method != "watershed":
        raise ValueError(f"unknown secondary method '{method}'")
    labels = watershed_from_seeds(img, primary_label_image, mask, n_levels=n_levels)
    return {"objects": labels}


@register_module("measure_intensity")
def measure_intensity(
    objects_image, intensity_image, max_objects: int = 256, quantiles: bool = False
):
    """Reference ``jtmodules/measure_intensity.py``; ``quantiles=True``
    adds the per-object p25/median/p75."""
    from tmlibrary_tpu_torch.ops.measure import intensity_features, intensity_quantiles

    feats = intensity_features(objects_image, intensity_image, max_objects)
    if quantiles:
        feats.update(intensity_quantiles(objects_image, intensity_image, max_objects))
    return {"measurements": feats}


@register_module("measure_morphology")
def measure_morphology(objects_image, max_objects: int = 256):
    """Reference ``jtmodules/measure_morphology.py``."""
    from tmlibrary_tpu_torch.ops.measure import morphology_features

    return {"measurements": morphology_features(objects_image, max_objects)}


@register_module("measure_texture")
def measure_texture(
    objects_image, intensity_image, levels: int = 32, distance: int = 1,
    max_objects: int = 256,
):
    """Reference ``jtmodules/measure_texture.py`` (Haralick); only
    ``distance=1`` is ported."""
    from tmlibrary_tpu_torch.ops.measure import haralick_features

    return {"measurements": haralick_features(
        objects_image, intensity_image, max_objects, levels=levels, distance=distance)}


@register_module("measure_zernike")
def measure_zernike(objects_image, degree: int = 9, patch: int = 64, max_objects: int = 256):
    """Reference ``jtmodules/measure_zernike.py``; ``patch`` is accepted
    and ignored, as in the reference."""
    from tmlibrary_tpu_torch.ops.measure import zernike_features

    return {"measurements": zernike_features(
        objects_image, max_objects, degree=degree, patch=patch)}


@register_module("separate_clumps")
def separate_clumps(
    label_image,
    min_distance: int = 5,
    max_objects: int = 256,
    max_form_factor: float = 1.0,
    min_area_to_cut: int = 0,
):
    """Split touching objects by distance-transform watershed (reference
    ``jtmodules/separate_clumps.py``).  An object is cut when its form
    factor ``4π area / perimeter²`` (perimeter: exposed 4-neighbour
    edges) is below ``max_form_factor`` and its area is at least
    ``min_area_to_cut``; ``max_form_factor >= 1`` cuts every object.  The
    kept and the split objects are renumbered together by first pixel
    (scipy order)."""
    from tmlibrary_tpu_torch.ops.fused_measure import grouped_stats
    from tmlibrary_tpu_torch.ops.kernels import shift_with_fill
    from tmlibrary_tpu_torch.ops.segment_primary import (
        distance_transform_approx,
        local_maxima_seeds,
    )
    from tmlibrary_tpu_torch.ops.segment_secondary import watershed_from_seeds

    labels = label_ops.clip_label_count(label_image.to(torch.int32), max_objects)
    mask = labels > 0
    edge_count = torch.zeros(labels.shape, dtype=torch.float32, device=labels.device)
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        edge_count = edge_count + (shift_with_fill(labels, dy, dx, 0) != labels).to(torch.float32)
    edge_count = torch.where(mask, edge_count, 0.0)
    sums = grouped_stats(labels, [torch.ones_like(edge_count), edge_count], max_objects)[0]
    area, perim = sums[..., 0], sums[..., 1]
    ff = div(4.0 * math.pi * area, torch.clamp(perim * perim, min=1.0))
    eligible = (ff < max_form_factor) & (area >= min_area_to_cut) & (area > 0)
    if max_form_factor >= 1.0:
        eligible = torch.ones_like(eligible)
    table = torch.cat([torch.zeros_like(eligible[:, :1]), eligible], dim=1).to(torch.int32)
    elig_pix = label_ops.remap_labels(labels, table).to(torch.bool) & mask

    dist = distance_transform_approx(elig_pix)
    seeds = local_maxima_seeds(
        dist, elig_pix, min_distance=min_distance, smooth_sigma=min_distance / 2.0)
    split = watershed_from_seeds(dist, seeds, elig_pix)
    # clip before relabeling: seed ids are not bounded by max_objects
    combined = torch.where(elig_pix, split + max_objects, labels)
    combined = torch.where(mask, combined, 0)
    combined = label_ops.clip_label_count(combined, 2 * max_objects)
    out = label_ops.relabel_by_scan_order(combined, 2 * max_objects)
    return {"separated_label_image": label_ops.clip_label_count(out, max_objects)}


# --------------------------------------------------------------- volumes
@register_module("generate_volume_image")
def generate_volume_image(zstack, focus_window: int = 5, mode: str = "volume"):
    """Volume image from ``(B, Z, H, W)`` z-stacks (reference
    ``jtmodules/generate_volume_image.py``).  Per-plane focus is the
    box-filtered squared 5-point Laplacian on an edge-replicated pad;
    outputs the stack unchanged (``mode="volume"``) or scaled by each
    voxel's focus relative to its sharpest plane (``"focus"``), the
    ``(B, H, W)`` sharpest-plane index (ties to the first plane) and the
    all-in-focus composite."""
    vol = zstack.to(torch.float32)
    h, w = vol.shape[-2:]
    rows = torch.arange(h, device=vol.device)
    cols = torch.arange(w, device=vol.device)
    up = vol.index_select(-2, torch.clamp(rows - 1, min=0))
    down = vol.index_select(-2, torch.clamp(rows + 1, max=h - 1))
    left = vol.index_select(-1, torch.clamp(cols - 1, min=0))
    right = vol.index_select(-1, torch.clamp(cols + 1, max=w - 1))
    lap = -4.0 * vol + up + down + left + right
    focus = smooth_ops.uniform_smooth(lap * lap, focus_window)
    depth = torch.argmax(focus, dim=1)  # the first maximum, like jnp.argmax
    best = focus.amax(dim=1)
    in_focus = vol.gather(1, depth[:, None])[:, 0]
    if mode == "focus":
        # uniform pixels (focus 0 in every plane) keep full weight
        weights = torch.where(
            best[:, None] > 1e-6, div(focus, torch.clamp(best[:, None], min=1e-6)), 1.0)
        out_vol = vol * weights
    elif mode == "volume":
        out_vol = vol
    else:
        raise ValueError(f"unknown volume mode '{mode}'")
    return {
        "volume_image": out_vol,
        "depth_image": depth.to(torch.float32),
        "focus_image": in_focus,
    }


def _volume_mask(vol, threshold_method, threshold_value, correction_factor):
    if threshold_method == "otsu":
        t = threshold_ops.otsu_value(vol) * correction_factor
        return vol > t[:, None, None, None]
    if threshold_method == "manual":
        return vol > threshold_value
    raise ValueError(f"unknown threshold method '{threshold_method}'")


@register_module("segment_volume")
def segment_volume(
    volume_image,
    threshold_method: str = "otsu",
    threshold_value: float = 0.0,
    correction_factor: float = 1.0,
    connectivity: int = 26,
    max_objects: int = 256,
):
    """3-D segmentation: threshold + 3-D connected components at
    ``connectivity`` 6, 18 or 26 (anything else raises ``ValueError``)."""
    from tmlibrary_tpu_torch.ops.volume import connected_components_3d

    vol = volume_image.to(torch.float32)
    mask = _volume_mask(vol, threshold_method, threshold_value, correction_factor)
    labels, _ = connected_components_3d(mask, connectivity)
    return {"objects": label_ops.clip_label_count(labels, max_objects)}


@register_module("segment_volume_secondary")
def segment_volume_secondary(
    volume_image,
    primary_label_image,
    threshold_value: float = 0.0,
    correction_factor: float = 1.0,
    n_levels: int = 16,
    max_objects: int = 256,
):
    """3-D secondary segmentation: grow cell volumes outward from the
    primary 3-D seeds by level-ordered flooding, keeping seed ids; the
    mask is Otsu (or ``threshold_value`` when positive) times
    ``correction_factor``."""
    from tmlibrary_tpu_torch.ops.volume import watershed_from_seeds_3d

    vol = volume_image.to(torch.float32)
    if threshold_value > 0.0:
        t = torch.tensor(threshold_value, dtype=torch.float32) * correction_factor
        mask = vol > t.to(vol.device)
    else:
        mask = _volume_mask(vol, "otsu", 0.0, correction_factor)
    out = watershed_from_seeds_3d(
        vol, label_ops.clip_label_count(primary_label_image, max_objects), mask,
        n_levels=n_levels,
    )
    return {"objects": label_ops.clip_label_count(out, max_objects)}


@register_module("measure_volume")
def measure_volume(objects_image, intensity_image, max_objects: int = 256):
    """3-D per-object measurements (voxels, centroid, intensity stats)."""
    from tmlibrary_tpu_torch.ops.volume import volume_features

    return {"measurements": volume_features(objects_image, intensity_image, max_objects)}


# -------------------------------------------------------- DL segmentation
#: output-key prefix of a module's diagnostic streams: ``__qc__<stat>``
#: outputs are not pipeline handles; ``build_site_fn`` gathers them (in
#: QC-enabled builds only) and the QC session sketches them under the
#: ``__model__`` pseudo-objects
MODULE_QC_PREFIX = "__qc__"


def _qc_sample(values: torch.Tensor, k: int = 64) -> torch.Tensor:
    """``(B, k)``: ``k`` evenly strided pixels of each site's stat image
    in scan order (``(i * (n // k)) % n``), as the reference samples."""
    flat = values.reshape(values.shape[0], -1).to(torch.float32)
    n = flat.shape[1]
    idx = (torch.arange(k, dtype=torch.int64, device=flat.device) * (n // k)) % n
    return flat[:, idx]


def _dl_head(intensity_image, weights: str) -> torch.Tensor:
    """The U-Net's ``(B, 3, H, W)`` head on the standardized sites; the
    net is resolved once per (weights digest, device) and stays
    resident."""
    from tmlibrary_tpu_torch import nn

    net, _digest = nn.unet_for(weights, intensity_image.device)
    return net(nn.normalize_image(intensity_image)[:, None])


@register_module("segment_dl_primary")
def segment_dl_primary(
    intensity_image,
    weights: str = "seed:0",
    prob_threshold: float = 0.5,
    flow_steps: int = 24,
    min_seed_hits: int = 2,
    min_area: int = 0,
    max_objects: int = 256,
):
    """Deep-learning primary segmentation (nuclei): the flow-field U-Net
    and the integer decoder (:mod:`tmlibrary_tpu_torch.nn`).  ``weights``
    is a checkpoint spec (``seed:<n>[:base=C][:depth=D]``, a name in the
    weights directory or an ``.npz`` path).  Also returns 64 samples a
    site of the flow magnitude and the cell probability as QC streams."""
    from tmlibrary_tpu_torch import nn
    from tmlibrary_tpu_torch.ops._exact import sqrt

    head = _dl_head(intensity_image, weights)
    flow = head[:, :2]
    cellprob = torch.sigmoid(head[:, 2])
    labels, _count = nn.decode_flows(
        flow, cellprob, prob_threshold=prob_threshold, flow_steps=flow_steps,
        min_seed_hits=min_seed_hits, min_area=min_area, max_objects=max_objects)
    flow_mag = sqrt(flow[:, 0] * flow[:, 0] + flow[:, 1] * flow[:, 1])
    return {
        "objects": labels,
        f"{MODULE_QC_PREFIX}flow_mag": _qc_sample(flow_mag),
        f"{MODULE_QC_PREFIX}cell_prob": _qc_sample(cellprob),
    }


@register_module("segment_dl_secondary")
def segment_dl_secondary(
    primary_label_image,
    intensity_image,
    weights: str = "seed:0",
    prob_threshold: float = 0.5,
    max_objects: int = 256,
):
    """Deep-learning secondary segmentation: the primary objects grown
    across the U-Net's cell-probability foreground, keeping their ids
    (:func:`~tmlibrary_tpu_torch.nn.decode.decode_secondary`)."""
    from tmlibrary_tpu_torch import nn

    cellprob = torch.sigmoid(_dl_head(intensity_image, weights)[:, 2])
    labels, _count = nn.decode_secondary(
        primary_label_image, cellprob, prob_threshold=prob_threshold, max_objects=max_objects)
    return {
        "objects": labels,
        f"{MODULE_QC_PREFIX}cell_prob_secondary": _qc_sample(cellprob),
    }
