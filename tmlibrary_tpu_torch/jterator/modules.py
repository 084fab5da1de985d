"""Module registry and the ported module implementations.

Counterpart: ``tmlibrary_tpu/jterator/modules.py:34-718`` (every module
the reference registers) and the DL segmenters at ``:727-812``
(reference: the external ``jtmodules`` package).  Modules register
under a name and a ``backend`` key; the descriptions written for the JAX package name
``backend: tpu`` (the default), so the port registers its twins under
the same key and an unchanged ``.pipe`` description runs on either
package.

Module contract: ``fn(**kwargs) -> dict`` mapping output-handle names to
tensors (or, for ``Measurement`` outputs, to ``{feature: (B, max_objects)
tensor}`` dicts).  Array kwargs are ``(B, H, W)`` batches, or ``(B, Z, H,
W)`` for the volume modules; everything else is a constant from the
handle description.  The reference computes one site under ``vmap``;
here every reduction the reference takes over "the image" (``invert``'s
maximum, ``project``'s z axis, ``detect_blobs``' count) is taken over
each site.  A module that drops objects beyond ``max_objects``
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

import numpy as np
import torch

from tmlibrary_tpu_torch.errors import RegistryError
from tmlibrary_tpu_torch.ops import kernels
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


def get_module_version(name: str, backend: str = "tpu") -> str:
    return _REGISTRY[name][backend][1]


def list_modules(backend: str | None = None) -> list[str]:
    if backend is None:
        return sorted(_REGISTRY)
    return sorted(n for n, b in _REGISTRY.items() if backend in b)


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
    """Smoothing (reference ``jtmodules/smooth.py``): gaussian | median |
    average | bilateral."""
    if method == "gaussian":
        out = smooth_ops.gaussian_smooth(intensity_image, sigma)
    elif method == "median":
        out = smooth_ops.median_smooth(intensity_image, size)
    elif method == "average":
        out = smooth_ops.uniform_smooth(intensity_image, size)
    elif method == "bilateral":
        out = smooth_ops.bilateral_smooth(intensity_image, size=size, sigma_space=sigma)
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


@register_module("filter")
def filter_objects(
    label_image,
    feature: str = "area",
    lower_threshold: float | None = None,
    upper_threshold: float | None = None,
    max_objects: int = 256,
):
    """Reference ``jtmodules/filter.py``: remove objects whose morphology
    feature (``area``, ``form_factor``, ``eccentricity``, ...; bare or
    ``Morphology_``-prefixed) falls outside ``[lower_threshold,
    upper_threshold]``, renumbering the rest."""
    if lower_threshold is None and upper_threshold is None:
        raise ValueError("filter needs lower_threshold and/or upper_threshold")
    if feature in ("area", "Morphology_area"):
        # pixel counting only; float thresholds compare as in the generic path
        out = label_ops.filter_by_area(
            label_image, max_objects=max_objects,
            min_area=lower_threshold if lower_threshold is not None else 0,
            max_area=upper_threshold,
        )
    else:
        out = label_ops.filter_by_feature(
            label_image, feature, max_objects, lower=lower_threshold, upper=upper_threshold)
    return {"filtered_label_image": out}


@register_module("register_objects")
def register_objects(label_image):
    """Reference ``jtmodules/register_objects.py``: promote a label image
    to registered objects."""
    return {"objects": label_image.to(torch.int32)}


@register_module("invert")
def invert(image):
    """Reference ``jtmodules/invert.py``: a mask's complement, or each
    site's maximum minus its pixels."""
    if image.dtype == torch.bool:
        return {"inverted_image": ~image}
    # PyTorch's unsigned types lack reductions: integers go through int64
    # (max - v is in range, so the cast back is exact)
    wide = image if image.dtype.is_floating_point else image.to(torch.int64)
    top = wide.reshape(wide.shape[0], -1).amax(dim=1)
    out = top.reshape((-1,) + (1,) * (wide.dim() - 1)) - wide
    return {"inverted_image": out.to(image.dtype)}


@register_module("rescale")
def rescale(intensity_image, lower: float = 0.0, upper: float = 65535.0):
    """Linear rescale of ``[lower, upper]`` to ``[0, 1]``, clipped."""
    from tmlibrary_tpu_torch.ops import image_ops

    return {"rescaled_image": image_ops.rescale(intensity_image, lower, upper)}


@register_module("mask")
def apply_mask(image, mask):
    """Zero out pixels outside ``mask`` (reference ``jtmodules/mask.py``)."""
    return {"masked_image": torch.where(mask.to(torch.bool), image, torch.zeros_like(image))}


@register_module("combine_masks")
def combine_masks(mask_1, mask_2, operation: str = "AND"):
    """Reference ``jtmodules/combine_masks.py``: AND | OR | XOR."""
    a = mask_1.to(torch.bool)
    b = mask_2.to(torch.bool)
    if operation.upper() == "AND":
        return {"combined_mask": a & b}
    if operation.upper() == "OR":
        return {"combined_mask": a | b}
    if operation.upper() == "XOR":
        return {"combined_mask": a ^ b}
    raise ValueError(f"unknown combine operation '{operation}'")


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


@register_module("measure_point_pattern")
def measure_point_pattern(
    objects_image,
    points_image,
    max_objects: int = 256,
    max_points: int = 256,
):
    """Reference ``jtlib/features/point_pattern.py``: spatial statistics
    of child point objects (spots) within parent objects — count,
    density, nearest-neighbour distances, the Clark–Evans index,
    distances to the parent centroid and border."""
    from tmlibrary_tpu_torch.ops.measure import point_pattern_features

    return {"measurements": point_pattern_features(
        objects_image, points_image, max_objects, max_points)}


def _sum_planes(v: torch.Tensor) -> torch.Tensor:
    """Sum over the z axis of ``(B, Z, H, W)``, plane after plane in
    order (the same order on either device)."""
    out = v[:, 0]
    for z in range(1, v.shape[1]):
        out = out + v[:, z]
    return out


@register_module("project")
def project(zstack, method: str = "max"):
    """Z-projection of ``(B, Z, H, W)`` z-stacks (reference
    ``jtmodules/project.py``): max | mean | sum.  The mean is the sum
    times the float32 reciprocal of Z, as ``jnp.mean`` computes it."""
    v = zstack.to(torch.float32)
    if method == "max":
        return {"projected_image": v.amax(dim=1)}
    if method == "mean":
        reciprocal = float(np.float32(1.0) / np.float32(v.shape[1]))
        return {"projected_image": _sum_planes(v) * reciprocal}
    if method == "sum":
        return {"projected_image": _sum_planes(v)}
    raise ValueError(f"unknown projection method '{method}'")


@register_module("morphology")
def morphology(mask, operation: str = "open", iterations: int = 1):
    """Binary morphology (reference ``jtmodules/morphology.py``), 8-connected:
    open | close | dilate | erode."""
    m = mask.to(torch.bool)
    if operation == "dilate":
        out = kernels.binary_dilate(m, 8, iterations)
    elif operation == "erode":
        out = kernels.binary_erode(m, 8, iterations)
    elif operation == "open":
        out = kernels.binary_dilate(kernels.binary_erode(m, 8, iterations), 8, iterations)
    elif operation == "close":
        out = kernels.binary_erode(kernels.binary_dilate(m, 8, iterations), 8, iterations)
    else:
        raise ValueError(f"unknown morphology operation '{operation}'")
    return {"output_mask": out}


def _edge_shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``out[..., y, x] = img[..., clamp(y + dy), clamp(x + dx)]`` (an
    edge-replicated pad of one pixel)."""
    h, w = img.shape[-2:]
    rows = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    cols = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img.index_select(-2, rows).index_select(-1, cols)


@register_module("filter_edges")
def filter_edges(intensity_image, method: str = "sobel"):
    """Edge enhancement on an edge-replicated pad (reference
    ``jtmodules/filter.py`` edge options): the 3x3 sobel gradient
    magnitude, or the 5-point Laplacian of the gaussian at σ 2."""
    from tmlibrary_tpu_torch.ops._exact import sqrt

    img = intensity_image.to(torch.float32)
    if method == "sobel":
        def s(dy, dx):
            return _edge_shift(img, dy, dx)

        gy = (s(1, -1) + 2 * s(1, 0) + s(1, 1)) - (s(-1, -1) + 2 * s(-1, 0) + s(-1, 1))
        gx = (s(-1, 1) + 2 * s(0, 1) + s(1, 1)) - (s(-1, -1) + 2 * s(0, -1) + s(1, -1))
        return {"filtered_image": sqrt(gy * gy + gx * gx)}
    if method == "log":
        sm = smooth_ops.gaussian_smooth(img, 2.0)
        lap = (_edge_shift(sm, -1, 0) + _edge_shift(sm, 1, 0) + _edge_shift(sm, 0, -1)
               + _edge_shift(sm, 0, 1) - 4.0 * sm)
        return {"filtered_image": lap}
    raise ValueError(f"unknown edge filter '{method}'")


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
    lap = (-4.0 * vol + _edge_shift(vol, -1, 0) + _edge_shift(vol, 1, 0)
           + _edge_shift(vol, 0, -1) + _edge_shift(vol, 0, 1))
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


@register_module("expand_or_shrink")
def expand_or_shrink(label_image, n: int = 1, max_objects: int = 256):
    """Reference ``jtmodules/expand_or_shrink.py``: grow objects by ``n``
    adopt steps (``n > 0``; ties to the larger label) or keep each label
    where its object mask survives ``-n`` 8-connected erosions (``n < 0``)."""
    from tmlibrary_tpu_torch.ops.segment_secondary import expand_labels

    lab = label_image.to(torch.int32)
    if n == 0:
        return {"expanded_image": lab}
    if n > 0:
        return {"expanded_image": expand_labels(lab, iterations=n)}
    eroded = kernels.binary_erode(lab > 0, connectivity=8, iterations=-n)
    return {"expanded_image": torch.where(eroded, lab, torch.zeros_like(lab))}


@register_module("clip")
def clip(intensity_image, lower: float = 0.0, upper: float = 65535.0):
    """Reference ``jtmodules/clip.py``: clip intensities to [lower, upper]."""
    from tmlibrary_tpu_torch.ops import image_ops

    return {"clipped_image": image_ops.clip_values(intensity_image, lower, upper)}


@register_module("combine_channels")
def combine_channels(image_1, image_2, weight_1: float = 1.0, weight_2: float = 1.0):
    """Reference ``jtmodules/combine_channels.py``: ``weight_1 * a +
    weight_2 * b`` in float32, each product rounded."""
    a = image_1.to(torch.float32)
    b = image_2.to(torch.float32)
    return {"combined_image": weight_1 * a + weight_2 * b}


@register_module("expand")
def expand(label_image, n: int = 1):
    """Reference ``jtmodules/expand.py``: grow labeled objects by ``n``
    pixels."""
    return {"expanded_image": expand_or_shrink(label_image, n=n)["expanded_image"]}


@register_module("shrink")
def shrink(label_image, n: int = 1):
    """Reference ``jtmodules/shrink.py``: erode labeled objects by ``n``
    pixels."""
    return {"shrunken_image": expand_or_shrink(label_image, n=-n)["expanded_image"]}


@register_module("mip")
def mip(zstack):
    """Reference ``jtmodules/mip.py``: maximum-intensity projection of
    ``(B, Z, H, W)`` z-stacks."""
    return {"mip_image": project(zstack, method="max")["projected_image"]}


@register_module("detect_blobs")
def detect_blobs(
    intensity_image,
    threshold: float = 10.0,
    min_distance: int = 3,
    sigma_min: float = 1.5,
    sigma_max: float = 4.0,
    n_scales: int = 3,
    max_objects: int = 256,
):
    """Reference ``jtmodules/detect_blobs.py``: LoG spot detection at
    ``n_scales`` sigmas evenly from ``sigma_min`` to ``sigma_max``
    (:func:`tmlibrary_tpu_torch.ops.blobs.detect_blobs`)."""
    from tmlibrary_tpu_torch.ops.blobs import detect_blobs as _db

    lo, hi, n = float(sigma_min), float(sigma_max), int(n_scales)
    sigmas = tuple(lo + (hi - lo) * i / max(n - 1, 1) for i in range(n))
    blobs, centers, _count = _db(intensity_image, sigmas=sigmas, threshold=threshold,
                                 min_distance=min_distance, max_objects=max_objects)
    return {"objects": blobs, "centers": centers}


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
