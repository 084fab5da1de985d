"""Connected-component labeling, hole filling and label filtering.

Counterpart: ``tmlibrary_tpu/ops/label.py`` (``connected_components``
with the scipy-order compaction at ``:182-188``, ``fill_holes``,
``areas_by_label``, ``remap_labels``, ``relabel_sequential``,
``filter_by_area``, ``clip_label_count``).  Every function takes a batch
of sites ``(B, H, W)``.  The fixpoints run in
:mod:`tmlibrary_tpu_torch.ops.kernels` (CUDA kernel on the card, plain
PyTorch on the CPU); everything around them is plain PyTorch.

Label order is bit-identical to ``scipy.ndimage.label``: a component's
converged label is its minimum linear index (its first pixel in
row-major scan order), and compaction ranks roots by that index.
"""

from __future__ import annotations

import torch

from tmlibrary_tpu_torch.ops import kernels


def connected_components(
    mask: torch.Tensor, connectivity: int = 8
) -> tuple[torch.Tensor, torch.Tensor]:
    """Label connected foreground components of ``(B, H, W)`` masks.

    Returns ``(labels, count)``: int32 labels (0 = background, 1..N in
    scipy scan order) and the ``(B,)`` int32 component counts."""
    mask = mask.to(torch.bool)
    b, h, w = mask.shape
    roots = kernels.cc_min_propagate(mask, connectivity)
    linear = torch.arange(h * w, dtype=torch.int32, device=mask.device)
    flat_mask = mask.reshape(b, -1)
    flat_roots = roots.reshape(b, -1)
    # compact to 1..N in row-major order of component roots (scipy order)
    is_root = flat_mask & (flat_roots == linear)
    ranks = torch.cumsum(is_root.to(torch.int32), dim=1, dtype=torch.int32)
    count = ranks[:, -1]
    root_rank = ranks.gather(1, torch.clamp(flat_roots, 0, h * w - 1).to(torch.int64))
    out = torch.where(flat_mask, root_rank, torch.zeros_like(root_rank))
    return out.reshape(b, h, w), count


def label(mask: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """Label image only (reference ``jtmodules/label.main``)."""
    return connected_components(mask, connectivity)[0]


def fill_holes(mask: torch.Tensor, connectivity: int = 4) -> torch.Tensor:
    """Fill background holes (scipy ``binary_fill_holes`` semantics:
    holes are ``connectivity``-connected background regions not
    reachable from the border)."""
    return kernels.fill_holes_flood(mask.to(torch.bool), connectivity)


def areas_by_label(labels: torch.Tensor, max_objects: int) -> torch.Tensor:
    """Pixel count per label id 1..max_objects → ``(B, max_objects)`` int32;
    ids outside that range count nowhere."""
    flat = labels.reshape(labels.shape[0], -1).to(torch.int64)
    valid = (flat >= 1) & (flat <= max_objects)
    counts = torch.zeros(
        (flat.shape[0], max_objects + 1), dtype=torch.int32, device=labels.device
    )
    counts.scatter_add_(
        1, torch.where(valid, flat, 0), valid.to(torch.int32)
    )
    return counts[:, 1:]


def remap_labels(labels: torch.Tensor, mapping: torch.Tensor) -> torch.Tensor:
    """``out[b, p] = mapping[b, labels[b, p]]`` with ``mapping`` of shape
    ``(B, max_objects + 1)`` (row 0 = background); out-of-range ids clamp
    into the table, as in the reference."""
    b = labels.shape[0]
    flat = torch.clamp(labels.reshape(b, -1), 0, mapping.shape[1] - 1)
    return mapping.to(torch.int32).gather(1, flat.to(torch.int64)).reshape(labels.shape)


def relabel_sequential(labels: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Keep labels where ``keep[b, label-1]``, renumbering 1..K densely in
    ascending original-label order."""
    keep = keep.to(torch.bool)
    new_ids = torch.cumsum(keep.to(torch.int32), dim=1, dtype=torch.int32)
    mapping = torch.cat(
        [torch.zeros_like(new_ids[:, :1]), torch.where(keep, new_ids, 0)], dim=1
    )
    return remap_labels(labels, mapping)


def clip_label_count(labels: torch.Tensor, max_objects: int) -> torch.Tensor:
    """Zero out labels beyond ``max_objects``."""
    return torch.where(labels <= max_objects, labels, torch.zeros_like(labels))


def filter_by_area(
    labels: torch.Tensor,
    max_objects: int,
    min_area: float = 0,
    max_area: float | None = None,
) -> torch.Tensor:
    """Remove objects outside [min_area, max_area]; labels beyond
    ``max_objects`` are dropped first (else the relabeling would clamp
    them onto object ``max_objects``'s id)."""
    labels = clip_label_count(labels, max_objects)
    areas = areas_by_label(labels, max_objects)
    keep = areas >= min_area
    if max_area is not None:
        keep = keep & (areas <= max_area)
    keep = keep & (areas > 0)
    return relabel_sequential(labels, keep)
