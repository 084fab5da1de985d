"""The flow-field -> label-image decoder, batched over sites.

Counterpart: ``tmlibrary_tpu/nn/decode.py``.  After the sign of the flow
and the probability threshold everything is integer work, so given the
same head the labels are bit-identical to the reference's on either
device:

1. foreground: ``cellprob >= prob_threshold`` (a float32 threshold);
2. every pixel steps ``flow_steps`` times one pixel along the sign of the
   flow where it stands, clipped to the site (a successor table raised
   to the ``flow_steps``-th power by repeated squaring);
3. sinks: an int32 scatter-add of the foreground pixels' end points;
   pixels where at least ``min_seed_hits`` trajectories end are seeds;
4. the seeds are labelled by
   :func:`~tmlibrary_tpu_torch.ops.label.connected_components` (the
   ``cc_min_propagate`` kernel on the card; scipy scan order), and each
   foreground pixel takes its end point's seed label;
5. the area filter and the compaction to 1..K use tables of ``H*W + 1``
   ids per site, never the routed capacity, so the labels do not depend
   on the bucket;
6. the capacity clip comes last.

Nothing here reads a value back to the host: a batch decodes without a
host sync.  Flows and probabilities are ``(B, 2, H, W)`` and ``(B, H,
W)``; the reference's ``(H, W, 2)`` flow of one site is this function's
``flow.permute(2, 0, 1)[None]``.
"""

from __future__ import annotations

import torch

from tmlibrary_tpu_torch.ops import kernels
from tmlibrary_tpu_torch.ops import label as label_ops


def follow_flows(flow: torch.Tensor, n_steps: int = 24) -> tuple[torch.Tensor, torch.Tensor]:
    """``(yy, xx)``: the ``(B, H, W)`` int32 position of every pixel after
    ``n_steps`` unit steps along the sign of the local flow, clipped to
    the site.  A NaN flow does not move a pixel.

    A step depends only on where a pixel stands, so it is a successor
    table over the site's pixels, and ``n_steps`` steps are that table's
    ``n_steps``-th power, composed by repeated squaring (one gather a
    squaring or a multiplication, about ``2 log2 n_steps`` in all): the
    same integer positions as the reference's step-by-step loop."""
    flow = flow.to(torch.float32)
    b, _, h, w = flow.shape
    sign = torch.sign(torch.nan_to_num(flow, nan=0.0)).to(torch.int64)
    yy = torch.arange(h, dtype=torch.int64, device=flow.device)[:, None]
    xx = torch.arange(w, dtype=torch.int64, device=flow.device)[None, :]
    step = (torch.clamp(yy + sign[:, 0], 0, h - 1) * w
            + torch.clamp(xx + sign[:, 1], 0, w - 1)).reshape(b, h * w)
    pos = torch.arange(h * w, dtype=torch.int64, device=flow.device).expand(b, h * w)
    while n_steps:
        if n_steps & 1:
            pos = step.gather(1, pos)
        n_steps >>= 1
        if n_steps:
            step = step.gather(1, step)
    pos = pos.reshape(b, h, w)
    return (pos // w).to(torch.int32), (pos % w).to(torch.int32)


def _threshold(cellprob: torch.Tensor, prob_threshold: float) -> torch.Tensor:
    # the float32 threshold filled on the device: no host-to-device copy
    thr = torch.full((), prob_threshold, dtype=torch.float32, device=cellprob.device)
    return cellprob.to(torch.float32) >= thr


def decode_flows(
    flow: torch.Tensor,
    cellprob: torch.Tensor,
    prob_threshold: float = 0.5,
    flow_steps: int = 24,
    min_seed_hits: int = 2,
    connectivity: int = 8,
    min_area: int = 0,
    max_objects: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(B, 2, H, W)`` flows and ``(B, H, W)`` probabilities -> ``(labels,
    count)``: int32 labels in scipy scan order, clipped to
    ``max_objects``, and the ``(B,)`` object counts."""
    mask = _threshold(cellprob, prob_threshold)
    yy, xx = follow_flows(flow, flow_steps)
    flat = sink_labels(mask, yy, xx, min_seed_hits, connectivity)
    labels = compact_labels(flat, min_area, max_objects).reshape(mask.shape)
    return labels, labels.reshape(labels.shape[0], -1).amax(dim=1)


def seed_mask(mask: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor,
              min_seed_hits: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """Step 3: the ``(B, H, W)`` seed mask (pixels where at least
    ``min_seed_hits`` foreground trajectories end) and the ``(B, H*W)``
    int64 end point of every pixel."""
    b, h, w = mask.shape
    end = (yy * w + xx).reshape(b, h * w).to(torch.int64)
    hits = torch.zeros((b, h * w), dtype=torch.int32, device=mask.device)
    hits.scatter_add_(1, end, mask.reshape(b, -1).to(torch.int32))
    return (hits >= min_seed_hits).reshape(b, h, w), end


def sink_labels(mask: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor,
                min_seed_hits: int = 2, connectivity: int = 8) -> torch.Tensor:
    """Steps 3-4: the ``(B, H*W)`` int64 seed label of every foreground
    pixel's end point (0 elsewhere), seeds in scipy scan order."""
    seeds, end = seed_mask(mask, yy, xx, min_seed_hits)
    seeds, _ = label_ops.connected_components(seeds, connectivity)
    flat = seeds.reshape(end.shape).gather(1, end)
    return torch.where(mask.reshape(end.shape), flat, 0).to(torch.int64)


def compact_labels(flat: torch.Tensor, min_area: int = 0, max_objects: int = 256) -> torch.Tensor:
    """Steps 5-6 on ``(B, H*W)`` int64 ids: the area filter, ids compacted
    to 1..K in their order, then the capacity clip; int32."""
    b, n = flat.shape
    # geometry-sized id tables (H*W + 1 ids), never capacity-sized
    n_ids = n + 1
    if min_area > 0:
        areas = torch.zeros((b, n_ids), dtype=torch.int32, device=flat.device)
        areas.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))
        flat = torch.where(areas.gather(1, flat) >= min_area, flat, 0)
    # every write to one id carries the same value (id > 0), so the plain
    # scatter is order-independent
    present = torch.zeros((b, n_ids), dtype=torch.int32, device=flat.device)
    present.scatter_(1, flat, (flat > 0).to(torch.int32))
    ranks = torch.cumsum(present, dim=1, dtype=torch.int32)
    labels = torch.where(flat > 0, ranks.gather(1, flat), 0)
    return label_ops.clip_label_count(labels, max_objects)


def decode_secondary(
    primary_labels: torch.Tensor,
    cellprob: torch.Tensor,
    prob_threshold: float = 0.5,
    connectivity: int = 8,
    max_objects: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Grow the primary objects across the foreground (the probability
    mask or the primary footprint), keeping their ids: the fixpoint of
    max-neighbour adoption (the reference's ``propagate_labels``), run as
    the watershed flood of one level over a flat intensity, which adopts
    the same way to the same fixpoint (``watershed_flood`` on the card;
    pinned against :func:`~tmlibrary_tpu_torch.ops.segment_secondary.propagate_labels`
    by the tests and the chip smoke)."""
    primary = primary_labels.to(torch.int32)
    mask = _threshold(cellprob, prob_threshold) | (primary > 0)
    flat = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
    labels = kernels.watershed_flood(flat, primary, mask, n_levels=1, connectivity=connectivity)
    labels = label_ops.clip_label_count(labels, max_objects)
    return labels, labels.reshape(labels.shape[0], -1).amax(dim=1)
