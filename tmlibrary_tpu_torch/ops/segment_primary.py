"""Primary object segmentation (nuclei), with optional declumping.

Counterpart: ``tmlibrary_tpu/ops/segment_primary.py`` — optional
smoothing → threshold (Otsu, manual or adaptive) → fill holes →
8-connected labeling, or with ``declump`` a watershed of the distance
transform from its local maxima → clip to capacity → area filter.  The
distance fixpoint runs in :func:`tmlibrary_tpu_torch.ops.kernels.
distance_transform` (CUDA kernel on the card, plain PyTorch on the CPU).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tmlibrary_tpu_torch.ops import kernels
from tmlibrary_tpu_torch.ops import label as label_ops
from tmlibrary_tpu_torch.ops import threshold as threshold_ops
from tmlibrary_tpu_torch.ops.segment_secondary import watershed_from_seeds
from tmlibrary_tpu_torch.ops.smooth import gaussian_smooth


def distance_transform_approx(mask: torch.Tensor, max_distance: int = 64) -> torch.Tensor:
    """Chessboard distance to the background of ``(B, H, W)`` masks by
    erosion counting, capped at ``max_distance + 1`` (reference
    ``distance_transform_approx``)."""
    return kernels.distance_transform(mask.to(torch.bool), max_distance)


def local_maxima_seeds(
    surface: torch.Tensor,
    mask: torch.Tensor,
    min_distance: int = 5,
    smooth_sigma: float = 0.0,
) -> torch.Tensor:
    """Labeled seeds at the peaks of ``surface`` inside ``mask``: pixels
    equal to the max of their ``2 * min_distance + 1`` window (pixels
    beyond the image never win), after an optional Gaussian pre-blur,
    8-connected and numbered in scan order."""
    surface = surface.to(torch.float32)
    if smooth_sigma > 0:
        surface = gaussian_smooth(surface, smooth_sigma)
    size = 2 * min_distance + 1
    neigh_max = F.max_pool2d(surface[:, None], size, stride=1, padding=min_distance)[:, 0]
    is_max = (surface >= neigh_max) & mask.to(torch.bool)
    return label_ops.connected_components(is_max, connectivity=8)[0]


def segment_primary(
    intensity_image: torch.Tensor,
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
    with_found: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Segment primary objects of ``(B, H, W)`` sites; returns
    ``(labels, count)`` with ``(B,)`` counts, and with ``with_found`` also
    the ``(B,)`` number of objects found before the capacity clip (the
    area filter runs after the clip, so ``count < max_objects`` does not
    show that none were dropped; ``found > max_objects`` does)."""
    img = intensity_image.to(torch.float32)
    if smooth_sigma > 0:
        img = gaussian_smooth(img, smooth_sigma)
    if threshold_method == "otsu":
        mask = threshold_ops.threshold_otsu(img, correction_factor=correction_factor)
    elif threshold_method == "manual":
        mask = threshold_ops.threshold_manual(img, threshold_value)
    elif threshold_method == "adaptive":
        mask = threshold_ops.threshold_adaptive(img, kernel_size=kernel_size, constant=constant)
    else:
        raise ValueError(f"unknown threshold method '{threshold_method}'")
    if fill:
        mask = label_ops.fill_holes(mask)
    if declump:
        # split touching objects: watershed on the distance transform from
        # its local maxima; the 8-connected labeling the other branch
        # takes would be overwritten, so it is not computed (XLA drops it
        # from the reference's jitted program too)
        dist = distance_transform_approx(mask)
        seeds = local_maxima_seeds(
            dist, mask, min_distance=declump_min_distance,
            smooth_sigma=declump_min_distance / 2.0,
        )
        labels = watershed_from_seeds(dist, seeds, mask)
        found = labels.reshape(labels.shape[0], -1).amax(dim=1)
        # seed ids follow peak scan order: clip (ids beyond capacity drop),
        # then renumber by each region's first pixel (scipy order)
        labels = label_ops.clip_label_count(labels, max_objects)
        labels = label_ops.relabel_by_scan_order(labels, max_objects)
    else:
        labels, found = label_ops.connected_components(mask, connectivity=8)
    labels = label_ops.clip_label_count(labels, max_objects)
    if min_area > 0 or max_area is not None:
        labels = label_ops.filter_by_area(
            labels, max_objects=max_objects, min_area=min_area, max_area=max_area
        )
    count = labels.reshape(labels.shape[0], -1).amax(dim=1)
    if with_found:
        return labels.to(torch.int32), count.to(torch.int32), found.to(torch.int32)
    return labels.to(torch.int32), count.to(torch.int32)
