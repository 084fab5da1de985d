"""Per-object grouped statistics: CUDA kernel and plain version.

Counterpart: ``tmlibrary_tpu/ops/fused_measure.py:133-221``
(``grouped_stats``, TPU kernel ``_stats_kernel``): ONE pass emitting the
per-object sum, min and max of several pixel channels.  The Hopper
kernel is ``tmlibrary_tpu_torch/csrc/grouped_stats.cu``.

Both versions sum each object's pixels left to right in row-major pixel
order, in float32 — the order of the reference's scatter-add on the
CPU — so sums are bit-identical to it, identical between the kernel and
the plain version, and identical run to run (no float atomics).  Min and
max are exact in any order.  Rows ``0..n`` do not depend on
``max_objects`` (``ops/reduction.capacity_segments``).
"""

from __future__ import annotations

import torch

from tmlibrary_tpu_torch.ops import _cuda
from tmlibrary_tpu_torch.ops.reduction import capacity_segments

MAX_CHANNELS = 8


def _stack(labels: torch.Tensor, channels: list[torch.Tensor]):
    if labels.dim() != 3:
        raise ValueError(f"grouped_stats: expected (B, H, W) labels, got {tuple(labels.shape)}")
    if not 1 <= len(channels) <= MAX_CHANNELS:
        raise ValueError(f"grouped_stats: 1..{MAX_CHANNELS} channels, got {len(channels)}")
    for c in channels:
        if c.shape != labels.shape:
            raise ValueError("grouped_stats: channel shape differs from labels")
    values = torch.stack([c.to(torch.float32) for c in channels], dim=1)
    return labels.to(torch.int32), values


def grouped_stats_plain(
    labels: torch.Tensor, channels: list[torch.Tensor], max_objects: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable sort by object id, then one vectorised add per rank within
    the largest object: a sequential pixel-order sum for every object."""
    labels, values = _stack(labels, channels)
    b, n_ch = values.shape[:2]
    k = int(max_objects)
    flat = labels.reshape(b, -1).to(torch.int64)
    vals = values.reshape(b, n_ch, -1)
    n_pix = flat.shape[1]
    valid = (flat >= 1) & (flat <= k)
    segs = capacity_segments(k)  # rows 0..k; row `segs` collects dropped pixels
    key = torch.where(valid, flat, segs)  # dropped pixels sort last
    order = torch.argsort(key, dim=1, stable=True)
    sorted_vals = vals.gather(2, order[:, None, :].expand(-1, n_ch, -1))
    counts = torch.zeros((b, segs + 1), dtype=torch.int64, device=labels.device)
    counts.scatter_add_(1, key, torch.ones_like(key))
    starts = torch.cumsum(counts, dim=1) - counts
    obj_counts, obj_starts = counts[:, 1 : k + 1], starts[:, 1 : k + 1]
    sums = torch.zeros((b, n_ch, k), dtype=torch.float32, device=labels.device)
    longest = int(obj_counts.max()) if k else 0
    for j in range(longest):
        pos = torch.clamp(obj_starts + j, max=n_pix - 1)
        v = sorted_vals.gather(2, pos[:, None, :].expand(-1, n_ch, -1))
        sums = sums + torch.where((j < obj_counts)[:, None, :], v, 0.0)
    idx = key[:, None, :].expand(-1, n_ch, -1)
    mins = torch.full((b, n_ch, segs + 1), float("inf"), device=labels.device)
    maxs = torch.full((b, n_ch, segs + 1), float("-inf"), device=labels.device)
    mins = mins.scatter_reduce(2, idx, vals, "amin")[:, :, 1 : k + 1]
    maxs = maxs.scatter_reduce(2, idx, vals, "amax")[:, :, 1 : k + 1]
    return sums.transpose(1, 2), mins.transpose(1, 2), maxs.transpose(1, 2)


def grouped_stats(
    labels: torch.Tensor, channels: list[torch.Tensor], max_objects: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-object ``(sums, mins, maxs)`` of several pixel channels, each
    ``(B, max_objects, n_channels)`` float32, label ids 1..max_objects
    (background dropped), absent rows ``(0, +inf, -inf)``."""
    if labels.device.type == "cpu":
        return grouped_stats_plain(labels, channels, max_objects)
    labels, values = _stack(labels, channels)
    labels, values = labels.contiguous(), values.contiguous()
    b, n_ch, h, w = values.shape
    if 16 * max_objects > 48 * 1024:
        raise ValueError("grouped_stats: max_objects above 3072 is not supported")
    sums, mins, maxs = (
        torch.empty((b, max_objects, n_ch), dtype=torch.float32, device=labels.device)
        for _ in range(3)
    )
    _cuda.require_cuda("grouped_stats", labels, values, sums, mins, maxs)
    grouped_stats.launches += 1
    _cuda.check("tm_grouped_stats", _cuda.lib().tm_grouped_stats(
        labels.data_ptr(), values.data_ptr(), sums.data_ptr(), mins.data_ptr(),
        maxs.data_ptr(), b, h, w, n_ch, max_objects, _cuda.stream()))
    return sums, mins, maxs


grouped_stats.launches = 0
