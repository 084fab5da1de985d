"""Per-object intensity features.

Counterpart: ``tmlibrary_tpu/ops/measure.py:397-457``
(``intensity_features``), on its fused path: count, sum, sum of squares,
min and max from ONE :func:`grouped_stats` pass over channels
``[1, v, v²]``, then the reference feature set of
``jtlib/features/intensity.py``.  Rows past a site's object count are
padding and must be masked by the caller using the object count.
"""

from __future__ import annotations

import torch

from tmlibrary_tpu_torch.ops.fused_measure import grouped_stats


def intensity_features(
    labels: torch.Tensor, intensity: torch.Tensor, max_objects: int
) -> dict[str, torch.Tensor]:
    """max, mean, min, sum, std per object → ``(B, max_objects)`` each."""
    img = intensity.to(torch.float32)
    sums, mns, mxs = grouped_stats(
        labels.to(torch.int32), [torch.ones_like(img), img, img * img], max_objects
    )
    count, total, sq = sums[..., 0], sums[..., 1], sums[..., 2]
    mn, mx = mns[..., 1], mxs[..., 1]
    safe_n = torch.clamp(count, min=1.0)
    mean = total / safe_n
    var = torch.clamp(sq / safe_n - mean * mean, min=0.0)
    present = count > 0
    zero = torch.zeros_like(mean)
    return {
        "Intensity_max": torch.where(present, mx, zero),
        "Intensity_mean": mean,
        "Intensity_min": torch.where(present, mn, zero),
        "Intensity_sum": total,
        "Intensity_std": torch.sqrt(var),
    }
