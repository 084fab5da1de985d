"""Blob (spot) detection by the Laplacian of Gaussian.

Counterpart: ``tmlibrary_tpu/ops/blobs.py:25-101`` (``log_response``,
``local_maxima``, ``detect_blobs``; reference ``jtmodules/detect_blobs.py``):
LoG spot detection for punctate structures (vesicles, speckles, FISH
dots), returning the blob regions and their centres.  Every function
takes a batch of sites ``(B, H, W)`` and works on each site alone.

The response is :func:`~tmlibrary_tpu_torch.ops.smooth.gaussian_smooth`
then a 5-point Laplacian, evaluated op by op in float32, so the card and
the CPU agree bit for bit; against the reference it differs where the
host-built gaussian taps differ from XLA-CPU's by an ulp (σ other than
1.5).  The regions are the 8-connected components of the thresholded
response (:func:`~tmlibrary_tpu_torch.ops.label.connected_components`,
the labeling kernel on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tmlibrary_tpu_torch.ops.label import clip_label_count, connected_components
from tmlibrary_tpu_torch.ops.smooth import _symmetric_index, gaussian_smooth

#: float32 holds every pixel index of a site up to here exactly, which
#: the scan-order tie-break of :func:`local_maxima` relies on
MAX_TIE_BREAK_PIXELS = 2**24


def log_response(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Scale-normalised negative LoG of ``(B, H, W)`` (bright blobs are
    positive): ``-σ² * Laplacian(Gaussian(img))``, the Laplacian the
    5-point stencil on a symmetric pad, summed up, down, left, right,
    then ``- 4 * centre``."""
    sm = gaussian_smooth(img.to(torch.float32), sigma)
    h, w = sm.shape[-2:]
    dev = sm.device
    lap = (
        sm.index_select(-2, _symmetric_index(h, -1, dev))
        + sm.index_select(-2, _symmetric_index(h, 1, dev))
        + sm.index_select(-1, _symmetric_index(w, -1, dev))
        + sm.index_select(-1, _symmetric_index(w, 1, dev))
        - 4.0 * sm
    )
    return -(float(sigma) ** 2) * lap


def local_maxima(response: torch.Tensor, min_distance: int = 3) -> torch.Tensor:
    """Boolean ``(B, H, W)`` map of the pixels equal to the maximum of
    their ``(2 * min_distance + 1)²`` window (pixels beyond the image
    never win); of a plateau within one window only the first pixel in
    scan order is kept (peak_local_max's exclusion)."""
    h, w = response.shape[-2:]
    if h * w > MAX_TIE_BREAK_PIXELS:
        raise ValueError(f"local_maxima: {h}x{w} sites exceed the float32 tie-break")
    size = 2 * int(min_distance) + 1
    pad = int(min_distance)
    neigh_max = F.max_pool2d(response[:, None], size, stride=1, padding=pad)[:, 0]
    is_max = response >= neigh_max
    linear = torch.arange(h * w, dtype=torch.float32, device=response.device).reshape(h, w)
    marked = torch.where(is_max, -linear, torch.full_like(response, float("-inf")))
    tie_break = F.max_pool2d(marked[:, None], size, stride=1, padding=pad)[:, 0]
    return is_max & (tie_break.abs() == linear)


def detect_blobs(
    img: torch.Tensor,
    sigmas: tuple[float, ...] = (1.5, 2.5, 4.0),
    threshold: float = 10.0,
    min_distance: int = 3,
    max_objects: int = 256,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-scale LoG blob detection on ``(B, H, W)`` sites.

    Returns ``(blobs, centers, count)``: int32 labels of the regions
    where the largest response over ``sigmas`` exceeds ``threshold``
    (8-connected, scipy scan order, clipped to ``max_objects``), the
    blob's label at each of its local maxima (0 elsewhere), and the
    ``(B,)`` blob count of each site, at most ``max_objects``."""
    img = img.to(torch.float32)
    response = log_response(img, sigmas[0])
    for s in sigmas[1:]:
        response = torch.maximum(response, log_response(img, s))
    mask = response > threshold
    labels, count = connected_components(mask, connectivity=8)
    labels = clip_label_count(labels, max_objects)
    peaks = local_maxima(response, min_distance) & mask
    centers = torch.where(peaks, labels, torch.zeros_like(labels))
    return labels, centers, torch.clamp(count, max=max_objects)
