"""Primary object segmentation (nuclei).

Counterpart: ``tmlibrary_tpu/ops/segment_primary.py:117`` — the
non-declump path: optional smoothing → threshold → fill holes →
8-connected labeling → clip to capacity → area filter.  The declump path
(distance transform + seeded watershed) is not ported yet.
"""

from __future__ import annotations

import torch

from tmlibrary_tpu_torch.errors import NotSupportedError
from tmlibrary_tpu_torch.ops import label as label_ops
from tmlibrary_tpu_torch.ops import threshold as threshold_ops
from tmlibrary_tpu_torch.ops.smooth import gaussian_smooth


def segment_primary(
    intensity_image: torch.Tensor,
    threshold_method: str = "otsu",
    threshold_value: float = 0.0,
    correction_factor: float = 1.0,
    smooth_sigma: float = 1.0,
    fill: bool = True,
    min_area: int = 0,
    max_area: int | None = None,
    declump: bool = False,
    max_objects: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Segment primary objects of ``(B, H, W)`` sites; returns
    ``(labels, count)`` with ``(B,)`` counts."""
    if declump:
        raise NotSupportedError("segment_primary(declump=True) is not ported yet")
    img = intensity_image.to(torch.float32)
    if smooth_sigma > 0:
        img = gaussian_smooth(img, smooth_sigma)
    if threshold_method == "otsu":
        mask = threshold_ops.threshold_otsu(img, correction_factor=correction_factor)
    elif threshold_method == "manual":
        mask = threshold_ops.threshold_manual(img, threshold_value)
    else:
        raise NotSupportedError(
            f"threshold method '{threshold_method}' is not ported yet"
        )
    if fill:
        mask = label_ops.fill_holes(mask)
    labels, _ = label_ops.connected_components(mask, connectivity=8)
    labels = label_ops.clip_label_count(labels, max_objects)
    if min_area > 0 or max_area is not None:
        labels = label_ops.filter_by_area(
            labels, max_objects=max_objects, min_area=min_area, max_area=max_area
        )
    count = labels.reshape(labels.shape[0], -1).amax(dim=1)
    return labels.to(torch.int32), count.to(torch.int32)
