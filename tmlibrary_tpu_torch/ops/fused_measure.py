"""Fused per-object reductions: CUDA kernels and their plain versions.

Counterpart: ``tmlibrary_tpu/ops/fused_measure.py`` — the TPU kernels of
the ``"fused"`` reduction strategy:

- :func:`grouped_stats` (``_stats_kernel``, ``:133-221``): ONE pass
  emitting the per-object sum, min and max of several pixel channels.
  Hopper kernel: ``csrc/grouped_stats.cu``.
- :func:`intensity_hist` (``_hist_kernel``, ``:225-326``): per-(object,
  bucket) counts with the bounds lookup and quantisation in the kernel.
  Hopper kernel: ``csrc/intensity_hist.cu``.
- :func:`glcm_all` (``_glcm_kernel``, ``:330-460``): all directions'
  per-object GLCM counts, quantisation in the kernel, symmetrised.
  Hopper kernel: ``csrc/glcm_all.cu``.

Every function takes a batch of sites ``(B, H, W)``; ``grouped_stats``
also takes volumes ``(B, Z, H, W)``.  The wrapper
dispatches on the tensor's device: a CPU tensor goes to the ``*_plain``
version, a CUDA tensor to the kernel, which launches or raises.  Each
wrapper counts its kernel launches in ``.launches``.

``grouped_stats`` sums each object's pixels left to right in row-major
pixel order, in float32 — the order of the reference's scatter-add on
the CPU — so sums are bit-identical to it, identical between the kernel
and the plain version, and identical run to run (no float atomics).  Min
and max, histogram and GLCM counts are exact in any order.  Rows ``0..n``
do not depend on ``max_objects`` (``ops/reduction.capacity_segments``).
Min and max propagate NaN.  The kernel takes any ``max_objects``: its
box pass widens the boxes in global memory.

The histogram and GLCM kernels count each site's table of uint32 in
shared memory, window by window, in a thread-block cluster of two
replicas (``csrc/count_table.cuh``); :func:`plan_hist` and
:func:`plan_glcm` cut the table into windows.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from tmlibrary_tpu_torch.ops import _cuda
from tmlibrary_tpu_torch.ops._cuda import bind_launch
from tmlibrary_tpu_torch.ops.kernels import shift_with_fill
from tmlibrary_tpu_torch.ops.reduction import capacity_segments

#: channels one ``grouped_stats`` kernel launch takes (one lane of the
#: chain's warp each); more are split into groups of at most this many
#: (each channel's row is independent)
MAX_CHANNELS = 32

#: dynamic shared memory one block may use on Hopper (227 KB)
SMEM_BYTES = 232448
#: shared memory a block's window may take: half of it leaves L1 for
#: the scan and still holds 86 histogram rows or 26 GLCM objects
HIST_SMEM = GLCM_SMEM = SMEM_BYTES // 2


def _check_sites(name: str, labels: torch.Tensor, *others: torch.Tensor) -> None:
    if labels.dim() != 3:
        raise ValueError(f"{name}: expected (B, H, W) labels, got {tuple(labels.shape)}")
    for t in others:
        if t.shape != labels.shape:
            raise ValueError(f"{name}: image shape differs from labels")


def _groups(channels: list) -> list[list]:
    if not channels:
        raise ValueError("grouped_stats: at least one channel")
    return [channels[i : i + MAX_CHANNELS] for i in range(0, len(channels), MAX_CHANNELS)]


def _concat(parts: list[tuple[torch.Tensor, ...]]):
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(cols, dim=-1) for cols in zip(*parts))


def _check_stats(labels: torch.Tensor, channels: list[torch.Tensor]) -> None:
    if labels.dim() not in (3, 4):
        raise ValueError("grouped_stats: expected (B, H, W) or (B, Z, H, W) labels, got "
                         f"{tuple(labels.shape)}")
    for c in channels:
        if c.shape != labels.shape:
            raise ValueError("grouped_stats: channel shape differs from labels")


def _stack(labels: torch.Tensor, channels: list[torch.Tensor]):
    _check_stats(labels, channels)
    values = torch.stack([c.to(torch.float32) for c in channels], dim=1)
    return labels.to(torch.int32), values


# ------------------------------------------------------------ grouped stats
def _grouped_stats_plain_group(labels, channels, max_objects):
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


def grouped_stats_plain(
    labels: torch.Tensor, channels: list[torch.Tensor], max_objects: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable sort by object id, then one vectorised add per rank within
    the largest object: a sequential pixel-order sum for every object.
    Channels go in the kernel's groups of :data:`MAX_CHANNELS`."""
    return _concat([_grouped_stats_plain_group(labels, g, max_objects)
                    for g in _groups(channels)])


#: blocks of 512 threads the box pass aims for (four an SM on 132 SMs)
STATS_BOX_BLOCKS = 528


@dataclass(frozen=True)
class StatsPlan:
    """How ``grouped_stats`` runs: ``bands``, the blocks of the box pass
    per site."""

    bands: int


def stats_plan(shape) -> StatsPlan:
    """The plan for ``(B, H, W)`` or ``(B, Z, H, W)`` labels: enough bands
    that the box pass has about :data:`STATS_BOX_BLOCKS` blocks, each at
    least 2048 pixels."""
    b, n = int(shape[0]), 1
    for d in shape[1:]:
        n *= int(d)
    return StatsPlan(max(1, min(-(-STATS_BOX_BLOCKS // max(b, 1)), -(-n // 2048))))


def _site_channels(channels: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each channel as float32 in which every site is one contiguous run,
    at any distance from the next site (0 for a channel broadcast over the
    batch, C sites for a view of a stacked tensor): the kernel reads these
    tensors where they lie, so only a channel that is not so is copied."""
    _cuda.require_cuda("grouped_stats", *channels, contiguous=False)
    out = []
    for c in channels:
        if c.dtype != torch.float32:
            c = c.to(torch.float32)
        if not c.is_contiguous() and not c[0].is_contiguous():
            c = c.contiguous()
        out.append(c)
    return out


def grouped_stats_launcher(labels, channels, max_objects,
                           plan: "StatsPlan | None" = None, counter=None):
    """``launch()`` of the kernel on ``(B, H, W)`` or ``(B, Z, H, W)``
    CUDA labels and at most :data:`MAX_CHANNELS` channels by ``plan``
    (default :func:`stats_plan`), returning ``(sums, mins, maxs)``; on
    volumes an object's box is 3-D.  The kernel gets each channel's
    pointer and site stride, and reads the caller's tensors.  It counts
    in ``counter``'s record."""
    if len(channels) > MAX_CHANNELS:
        raise ValueError(f"grouped_stats: at most {MAX_CHANNELS} channels a launch")
    _check_stats(labels, channels)
    plan = plan or stats_plan(labels.shape)
    b, z, h, w = labels.shape if labels.dim() == 4 else (labels.shape[0], 1, *labels.shape[1:])
    labels = labels.to(torch.int32).contiguous()
    chans = _site_channels(channels)
    out = torch.empty((3, b, max_objects, len(chans)), dtype=torch.float32,
                      device=labels.device)
    box = torch.empty((b, max_objects, 6), dtype=torch.int32, device=labels.device)
    tensors = (labels, box, *out)
    pointers = (ctypes.c_void_p * MAX_CHANNELS)(*(c.data_ptr() for c in chans))
    site_strides = (ctypes.c_longlong * MAX_CHANNELS)(*(c.stride(0) for c in chans))
    launch = bind_launch("grouped_stats", counter, tensors, pointers, site_strides, b, z, h,
                         w, len(chans), max_objects, plan.bands, held=chans)

    def run():
        launch()
        return out[0], out[1], out[2]

    return run


def grouped_stats(
    labels: torch.Tensor, channels: list[torch.Tensor], max_objects: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-object ``(sums, mins, maxs)`` of any number of pixel channels,
    each ``(B, max_objects, n_channels)`` float32, label ids
    1..max_objects (background dropped), absent rows ``(0, +inf, -inf)``,
    NaN propagating into min and max.  ``labels`` are ``(B, H, W)``
    sites or ``(B, Z, H, W)`` volumes (pixels in row-major order either
    way; on volumes the kernel walks 3-D boxes).  More than
    :data:`MAX_CHANNELS` channels take one launch per group; the result
    is bit-identical to one call per channel."""
    if labels.device.type == "cpu":
        return grouped_stats_plain(labels, channels, max_objects)
    return _concat([grouped_stats_launcher(labels, g, max_objects, counter=grouped_stats)()
                    for g in _groups(channels)])


grouped_stats.launches = 0


# ------------------------------------------------- bounds and quantisation
def masked_bounds(
    raw_lo: torch.Tensor, raw_hi: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw per-object ``(min, max)`` ``(B, M)`` (±inf for absent objects)
    → ``(lo_full, span_full)`` ``(B, M + 1)`` with the background row
    prepended: the expression tree of ``_masked_bounds``
    (``tmlibrary_tpu/ops/fused_measure.py:292``)."""
    present = raw_hi >= raw_lo
    lo = torch.where(present, raw_lo, 0.0)
    span = torch.where(present, raw_hi - lo, 1.0)
    b = lo.shape[0]
    lo_full = torch.cat([lo.new_zeros((b, 1)), lo], dim=1)
    span_full = torch.cat([span.new_ones((b, 1)), span], dim=1)
    return lo_full, span_full


def quantize(
    labels: torch.Tensor, img: torch.Tensor, lo_full: torch.Tensor,
    span_full: torch.Tensor, levels: int,
) -> torch.Tensor:
    """Per-pixel ``floor((v - lo) * (levels - 1) / max(span, 1e-6))``
    clipped to ``[0, levels - 1]``, with ``lo``/``span`` looked up by
    the pixel's label (ids clipped into the table, as
    ``lookup_by_label`` does) — ``quantize_per_object``'s expression,
    the same one the kernels evaluate with rounded intrinsics."""
    b = labels.shape[0]
    idx = labels.reshape(b, -1).to(torch.int64).clamp(0, lo_full.shape[1] - 1)
    lo_pix = lo_full.gather(1, idx).reshape(labels.shape)
    span_pix = torch.clamp(span_full.gather(1, idx).reshape(labels.shape), min=1e-6)
    q = torch.floor((img.to(torch.float32) - lo_pix) * float(levels - 1) / span_pix)
    return torch.clamp(q, 0, levels - 1).to(torch.int64)


# ------------------------------------------------------ count-table windows
@dataclass(frozen=True)
class TablePlan:
    """How a site's count table is cut into windows (``csrc/count_table.cuh``).
    The table has ``total`` rows (objects) of ``row_words`` uint32 words;
    ``windows`` windows of ``window`` rows each cover them, the last one
    maybe shorter.  Each block of the cluster that handles a site holds a
    replica of one window and the window's staged lo and span (two words
    a row) in shared memory.  ``flat``: one row exceeds a
    block's shared memory, so ``total`` counts cells and a window is a
    range of single cells (``row_words`` 1, nothing staged)."""

    total: int
    window: int
    windows: int
    row_words: int
    flat: bool = False

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one block: the replica (words rounded
        up to 4), then the staged bounds."""
        staged = 0 if self.flat else 2 * self.window
        return (-(-self.window * self.row_words // 4) * 4 + staged) * 4

    def ranges(self) -> list[tuple[int, int]]:
        """``[first, stop)`` rows (cells) of each window, the kernel's
        arithmetic (``first = w * window``)."""
        return [(min(self.total, w * self.window), min(self.total, (w + 1) * self.window))
                for w in range(self.windows)]


@functools.lru_cache(maxsize=None)
def plan_table(rows: int, row_words: int, cells: int, budget: int) -> TablePlan:
    """Windows of whole rows, as few as fit ``budget`` bytes a block and
    as even as they can be; where one row exceeds the budget, windows of
    ``cells`` single cells (in fours, for 16-byte stores)."""
    if rows < 1:
        raise ValueError(f"count table: {rows} rows")
    words = budget // 4 - 3  # room to round the replica up to 4 words
    per = words // (row_words + 2)
    if per >= 1:
        windows = -(-rows // per)
        return TablePlan(rows, -(-rows // windows), windows, row_words)
    words -= words % 4
    if words < 4:
        raise ValueError(f"count table: a budget of {budget} bytes holds no cells")
    windows = -(-cells // words)
    window = -(-cells // windows)
    return TablePlan(cells, -(-window // 4) * 4, windows, 1, flat=True)


def plan_hist(max_objects: int, bins: int, budget: int = HIST_SMEM) -> TablePlan:
    """Windows of whole histogram rows (one object's ``bins`` counts)."""
    return plan_table(max_objects, bins, max_objects * bins, budget)


def plan_glcm(max_objects: int, levels: int, n_dirs: int,
              budget: int = GLCM_SMEM) -> TablePlan:
    """Windows of whole objects: an object's row holds its ``levels x
    levels`` block for every direction, each padded to ``levels x (levels
    + 1)`` words."""
    return plan_table(max_objects, n_dirs * levels * (levels + 1),
                      n_dirs * max_objects * levels * levels, budget)


def _kernel_inputs(name, labels, intensity, max_objects, bounds):
    """Labels int32, image float32 and the raw per-object ``(min, max)``
    ``(B, max_objects)`` float32, contiguous: what the kernels read (they
    evaluate :func:`masked_bounds` per object themselves)."""
    _check_sites(name, labels, intensity)
    raw_lo, raw_hi = (t.to(torch.float32).contiguous() for t in bounds)
    if raw_lo.shape != (labels.shape[0], max_objects) or raw_hi.shape != raw_lo.shape:
        raise ValueError(f"{name}: bounds must be (B, max_objects)")
    return (labels.to(torch.int32).contiguous(), intensity.to(torch.float32).contiguous(),
            raw_lo, raw_hi)


def _bounds_inputs(name, labels, intensity, max_objects, bounds):
    _check_sites(name, labels, intensity)
    lo_full, span_full = masked_bounds(*bounds)
    if lo_full.shape != (labels.shape[0], max_objects + 1):
        raise ValueError(f"{name}: bounds must be (B, max_objects)")
    return (labels.to(torch.int32).contiguous(),
            intensity.to(torch.float32).contiguous(),
            lo_full.contiguous(), span_full.contiguous())


# ---------------------------------------------------------------- histogram
def intensity_hist_plain(
    labels: torch.Tensor, intensity: torch.Tensor, max_objects: int, bins: int,
    bounds: tuple[torch.Tensor, torch.Tensor],
) -> torch.Tensor:
    """Quantise every pixel, then one ``scatter_add_`` over the fused
    ``(site, label, bucket)`` index; pixels outside 1..M are dropped."""
    labels, img, lo_full, span_full = _bounds_inputs(
        "intensity_hist", labels, intensity, max_objects, bounds)
    b = labels.shape[0]
    q = quantize(labels, img, lo_full, span_full, bins).reshape(b, -1)
    lab = labels.reshape(b, -1).to(torch.int64)
    keep = (lab >= 1) & (lab <= max_objects)
    site = torch.arange(b, device=lab.device)[:, None].expand_as(lab)
    idx = ((site * max_objects + lab - 1) * bins + q)[keep]
    counts = torch.zeros(b * max_objects * bins, dtype=torch.float32, device=lab.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
    return counts.reshape(b, max_objects, bins)


def intensity_hist(
    labels: torch.Tensor, intensity: torch.Tensor, max_objects: int, bins: int,
    bounds: tuple[torch.Tensor, torch.Tensor],
) -> torch.Tensor:
    """Per-object intensity histogram ``(B, max_objects, bins)`` float32
    for ``intensity_quantiles``.  ``bounds`` is the raw per-object
    ``(min, max)`` of ``intensity`` (±inf for absent objects), normally
    :func:`grouped_stats`' min/max of the same image."""
    if labels.device.type == "cpu":
        return intensity_hist_plain(labels, intensity, max_objects, bins, bounds)
    return intensity_hist_launcher(labels, intensity, max_objects, bins, bounds)()


def intensity_hist_launcher(
    labels: torch.Tensor, intensity: torch.Tensor, max_objects: int, bins: int,
    bounds: tuple[torch.Tensor, torch.Tensor], plan: "TablePlan | None" = None,
):
    """Check the inputs, allocate the output and return ``launch()``,
    which runs the histogram kernel into it (every cell written) and
    returns it.  ``plan`` defaults to :func:`plan_hist`'s."""
    labels, img, raw_lo, raw_hi = _kernel_inputs(
        "intensity_hist", labels, intensity, max_objects, bounds)
    plan = plan or plan_hist(max_objects, bins)
    b, h, w = labels.shape
    out = torch.empty((b, max_objects, bins), dtype=torch.float32, device=labels.device)
    return bind_launch("intensity_hist", intensity_hist, (labels, img, raw_lo, raw_hi, out),
                       b, h, w, max_objects, bins, plan.window, plan.windows, int(plan.flat))


intensity_hist.launches = 0


# --------------------------------------------------------------------- GLCM
def _check_offsets(offsets) -> list[tuple[int, int]]:
    offsets = [(int(dy), int(dx)) for dy, dx in offsets]
    if not 1 <= len(offsets) <= 4:
        raise ValueError(f"glcm_all: 1..4 offsets, got {len(offsets)}")
    return offsets


def glcm_counts(
    labels: torch.Tensor, quantized: torch.Tensor, max_objects: int, levels: int,
    offsets: list[tuple[int, int]],
) -> list[torch.Tensor]:
    """Symmetrised per-object GLCMs of pre-quantised ``(B, H, W)`` sites,
    one ``(B, max_objects, levels, levels)`` float32 per offset: a pixel
    at ``(y, x)`` pairs with ``(y - dy, x - dx)`` when that pixel is in
    the image and has the same label (ids above ``max_objects`` count
    nowhere); one ``bincount`` over the fused ``(site, direction, label,
    q1, q2)`` index of the valid pairs, exact in any order."""
    b = labels.shape[0]
    n_dir = len(offsets)
    lab = labels.reshape(b, -1).to(torch.int64)
    q1 = quantized.reshape(b, -1).to(torch.int64)
    site = torch.arange(b, device=lab.device)[:, None]
    cells = levels * levels
    idx = []
    for d, (dy, dx) in enumerate(offsets):
        lab2 = shift_with_fill(labels, -dy, -dx, 0).reshape(b, -1)
        q2 = shift_with_fill(quantized, -dy, -dx, 0).reshape(b, -1)
        valid = (lab >= 1) & (lab <= max_objects) & (lab2 == lab)
        row = (site * n_dir + d) * max_objects + lab - 1
        idx.append((row * cells + q1 * levels + q2)[valid])
    counts = torch.bincount(torch.cat(idx), minlength=b * n_dir * max_objects * cells)
    glcm = counts.to(torch.float32).reshape(b, n_dir, max_objects, levels, levels)
    glcm = glcm + glcm.transpose(-1, -2)
    return [glcm[:, d] for d in range(n_dir)]


def glcm_all_plain(
    labels: torch.Tensor, intensity: torch.Tensor, max_objects: int, levels: int,
    offsets: list[tuple[int, int]], bounds: tuple[torch.Tensor, torch.Tensor],
) -> list[torch.Tensor]:
    """Quantise every pixel by its object's bounds, then count the pairs
    (:func:`glcm_counts`): a valid pair's partner has the same label, so
    its bucket is its own pixel's."""
    offsets = _check_offsets(offsets)
    labels, img, lo_full, span_full = _bounds_inputs(
        "glcm_all", labels, intensity, max_objects, bounds)
    q = quantize(labels, img, lo_full, span_full, levels)
    return glcm_counts(labels, q, max_objects, levels, offsets)


def glcm_all(
    labels: torch.Tensor, intensity: torch.Tensor, max_objects: int, levels: int,
    offsets: list[tuple[int, int]], bounds: tuple[torch.Tensor, torch.Tensor],
) -> list[torch.Tensor]:
    """All directions' symmetrised per-object GLCMs, one ``(B,
    max_objects, levels, levels)`` float32 per offset, quantisation
    included.  A pixel at ``(y, x)`` pairs with ``(y - dy, x - dx)`` when
    that pixel is in the image and has the same label.  ``bounds`` is the
    raw per-object ``(min, max)`` of ``intensity``."""
    if labels.device.type == "cpu":
        return glcm_all_plain(labels, intensity, max_objects, levels, offsets, bounds)
    out = glcm_all_launcher(labels, intensity, max_objects, levels, offsets, bounds)()
    return [out[:, d] for d in range(out.shape[1])]


def glcm_all_launcher(
    labels: torch.Tensor, intensity: torch.Tensor, max_objects: int, levels: int,
    offsets: list[tuple[int, int]], bounds: tuple[torch.Tensor, torch.Tensor],
    plan: "TablePlan | None" = None,
):
    """As :func:`intensity_hist_launcher`, for the GLCM kernel: ``launch()``
    returns the ``(B, D, max_objects, levels, levels)`` output; ``plan``
    defaults to :func:`plan_glcm`'s."""
    offsets = _check_offsets(offsets)
    labels, img, raw_lo, raw_hi = _kernel_inputs(
        "glcm_all", labels, intensity, max_objects, bounds)
    plan = plan or plan_glcm(max_objects, levels, len(offsets))
    b, h, w = labels.shape
    n_dir = len(offsets)
    out = torch.empty((b, n_dir, max_objects, levels, levels), dtype=torch.float32,
                      device=labels.device)
    return bind_launch("glcm_all", glcm_all, (labels, img, raw_lo, raw_hi, out),
                       b, h, w, max_objects, levels, n_dir, *padded_offsets(offsets),
                       plan.window, plan.windows, int(plan.flat))


def padded_offsets(offsets: list[tuple[int, int]]) -> list[int]:
    """``dy0, dx0, ..., dy3, dx3`` for the C entry points (unused slots 0)."""
    return [v for o in offsets + [(0, 0)] * (4 - len(offsets)) for v in o]


glcm_all.launches = 0
