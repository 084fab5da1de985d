"""Interleaved A/B of kernel variants on the card.

Counterpart of ``scripts/cc_kernel_shootout.py``.  That script's reason
holds on the card too: a single reading moves by up to ±25% between
calls, so two designs are compared only when they run in turns on one
batch in one process.  :func:`best_of` times each variant of a set with
CUDA events (``inner`` calls between two events, the best of ``reps``
rounds, the variants interleaved within every round) on inputs warm in
L2, as the main path finds them: each variant makes one untimed call
first, since the one before it (a yardstick's 16.8 MB table, say) may
have pushed its inputs out of L2.  A kernel variant is a ``launch()``
closure (``fm.bind_launch``) that holds its checked inputs and a
preallocated output, so a timed call is the launch alone, the card, not
the host, sets the pace, and every pointer it passes stays its own
while other variants allocate.

Variant sets, on the main path's inputs (:func:`main_path_inputs`: 64
sites of 256², ``max_objects=256``):

- ``cc``: row 2's union-find kernel (``kernel``, the launch) against the
  first design (``original``, the sweeping one, kept as
  ``tm_cc_min_propagate_original`` for this harness alone), the public
  wrapper (``wrapper``) and the port's plain labeling (``plain``) on the
  Otsu masks of the smoothed DAPI — the script's ``shipped`` against
  ``xla``.  Its ``chunk16``/``chunk4`` variants set the TPU kernel's
  tile (``CHUNK``) and have no CUDA counterpart.
- ``cc_split``: both designs on the Otsu masks (``*_real``), on an
  all-foreground batch (``*_full``) and on 45% noise (``*_noise``),
  each first-design launch also reporting its sweeps per site; and the
  kernel's first phase alone (``local_real``) and first two
  (``border_real``), so each phase's time follows by difference.
- ``distance`` (row 7 on path D's filled DAPI masks, ``max_distance``
  64): the two-pass kernel's launch (``kernel``), the first, sweeping design
  (``original``, kept as ``tm_distance_transform_original`` for this
  harness alone), the public wrapper and the plain version;
  ``distance_split``: on the real masks, all-foreground sites, one
  background pixel at the centre (``max_distance`` 254), 45% noise and
  empty sites, the first design with its sweeps per site, the column
  pass alone (``columns_*``) and both passes (``kernel_*``).
- ``hist`` (nuclei/DAPI, 256 buckets), ``hist_cells`` (cells/Actin, the
  quantile path's second launch) and ``glcm`` (cells/Actin, 16 levels, 4
  offsets): the shipped kernel (``kernel``); the kernel with windows of
  at most all, a half or a quarter of a block's shared memory
  (``smem_full``, ``smem_half``, ``smem_quarter``); the first design
  (``atomic``: one thread a pixel, float atomics into the
  memset output, kept as ``tm_*_atomic`` for this harness alone); the
  public wrapper (``wrapper``: input checks and the launch, what a caller
  pays); and two yardsticks, one PyTorch call each that counts indices
  already quantised (and, for the GLCM, paired): ``bincount`` and
  ``index_add``.
- ``watershed`` (cells/Actin from the nuclei, 16 levels),
  ``watershed_declump`` (the declumping path's distance image, local
  maxima seeds and filled DAPI masks, 32 levels) and ``fill`` (DAPI's
  Otsu masks): the shipped on-chip kernel (``kernel``); the first design
  on global planes (``global``); the public wrapper (``wrapper``); and
  the plain version (``plain``).
- ``watershed_split``/``fill_split``: the first design taken apart beside
  the kernel — the watershed on its real inputs (``*_real``), on the
  same sites with every mask pixel a seed (``*_labelled``: each level
  one quiet step, so the first design's time is 17 full scans) and with one level
  (``*_levels1``); the fill on the real masks (``*_real``) and on an
  all-foreground batch (``*_full``: no background, one sweep).
- ``hist_split``/``glcm_split``: the first design taken apart — the
  memset alone (``memset``), the counting kernel alone on an all-zero
  label batch (``atomic_zero``: a launch and a read of every pixel, no
  atomics), on the real labels (``atomic_real``) and on the real labels
  over a constant image (``atomic_flat``: each object's pixels in one
  bucket, the worst contention) — beside the shipped kernel on the same
  three inputs (``kernel_zero``, ``kernel_real``, ``kernel_flat``).
- ``grouped_stats_c3`` (config 3's 3-channel call on the nuclei),
  ``grouped_stats_c4_7`` and ``grouped_stats_c4_32`` (config 4's
  morphology call on the cells and Zernike call on the nuclei) and
  ``grouped_stats_v6`` (the volume path's 6-channel call on ``(B, Z, H,
  W)`` volumes): the kernel (``kernel``, every channel in one launch,
  read where the caller keeps it), the kernel on views of one stacked
  copy of the channels (``kernel_stacked``: the layout the wrapper once
  built, without building it), on the volumes also with 2-D
  boxes over the ``(B, Z*H, W)`` view (``kernel_2d``), the first design
  (``original``, one launch a group of 8 channels, over that view), the
  public wrapper (``wrapper``: the kernel and what the call costs around
  it) and the yardstick ``library`` (``index_add_`` and two
  ``scatter_reduce_``).
- ``grouped_stats_split``: the first design taken apart on config 3's call --
  its box phase alone (``original_boxes_*``) and whole (``original_*``)
  on the real nuclei and on one object the size of the site (``*_site``)
  -- beside the kernel on both.
- ``watershed3d`` (the volume path's cells from its nuclei, 8 levels): the
  cluster kernel (``kernel``), the first design (``global``), the public
  wrapper and the plain version; ``watershed3d_split``: both designs on
  the real volumes, with every mask voxel a seed (``*_labelled``) and at
  one level (``*_levels1``).
- ``cc3d`` and ``cc3d_split``: the same variants as ``cc`` and
  ``cc_split`` for row 8 on the volume path's Otsu masks (noise at 30%),
  against the first 3-D design (``tm_cc3d_min_propagate_original``).  These
  four need the volume path's inputs (:func:`volume_inputs`).

Run on a card: ``python -m tmlibrary_tpu_torch.shootout [--reps N]``.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from tmlibrary_tpu_torch.errors import DeviceError
from tmlibrary_tpu_torch.ops import fused_measure as fm
from tmlibrary_tpu_torch.ops import kernels
from tmlibrary_tpu_torch.ops import volume
from tmlibrary_tpu_torch.ops._cuda import bind_launch
from tmlibrary_tpu_torch.ops.measure import grouped_minmax

#: HBM bandwidth by card (NVIDIA data sheets); the SXM part is the default
HBM_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H100", 3.35e12))
#: ``phases`` of the first designs' entry points
PHASE_MEMSET, PHASE_KERNEL = 1, 2
#: ``phases`` of the first grouped_stats design (the boxes, the walk) and its
#: channels a launch
GS_BOXES, GS_WALK, ORIGINAL_CHANNELS = 1, 2, 8
#: window budgets the harness sets against the shipped plan
SMEM_LEVERS = (("full", fm.SMEM_BYTES), ("half", fm.SMEM_BYTES // 2),
               ("quarter", fm.SMEM_BYTES // 4))
#: Haralick levels and offsets of config 4, buckets of the quantile path
LEVELS, OFFSETS, BINS = 16, [(0, 1), (1, 0), (1, 1), (1, -1)], 256


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S:
        if key in name:
            return rate
    return HBM_BYTES_PER_S[-1][1]


def best_of(variants: dict, reps: int = 7, inner: int = 10, warmup: int = 2) -> dict:
    """Milliseconds per call of each variant: the best over ``reps``
    rounds of ``inner`` calls between two CUDA events, after one untimed
    call, the variants taken in turns within each round."""
    if not torch.cuda.is_available():
        raise DeviceError("shootout: the A/B harness times a CUDA card")
    for fn in variants.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    best = {name: math.inf for name in variants}
    for _ in range(reps):
        for name, fn in variants.items():
            fn()  # untimed: the variant's own inputs in L2, not its predecessor's output
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            stop.record()
            stop.synchronize()
            best[name] = min(best[name], start.elapsed_time(stop) / inner)
    return best


# ------------------------------------------- the first designs (baselines)
def intensity_hist_atomic(labels, intensity, max_objects, bins, bounds,
                          phases=PHASE_MEMSET | PHASE_KERNEL):
    """The first histogram design, as :func:`fm.intensity_hist_launcher`
    returns a ``launch()``: a memset of the output, then one thread a
    pixel adding 1.0f with a global float atomic (``phases`` picks either
    or both)."""
    labels, img, lo_full, span_full = fm._bounds_inputs(
        "intensity_hist", labels, intensity, max_objects, bounds)
    b, h, w = labels.shape
    out = torch.empty((b, max_objects, bins), dtype=torch.float32, device=labels.device)
    return fm.bind_launch("intensity_hist_atomic", None,
                          (labels, img, lo_full, span_full, out),
                          b, h, w, max_objects, bins, phases)


def glcm_all_atomic(labels, intensity, max_objects, levels, offsets, bounds,
                    phases=PHASE_MEMSET | PHASE_KERNEL):
    """The first GLCM design: a memset, then one thread a pixel adding
    1.0f at ``[q1][q2]`` and ``[q2][q1]`` with global float atomics;
    ``launch()`` returns the ``(B, D, M, L, L)`` output."""
    offsets = fm._check_offsets(offsets)
    labels, img, lo_full, span_full = fm._bounds_inputs(
        "glcm_all", labels, intensity, max_objects, bounds)
    b, h, w = labels.shape
    n_dir = len(offsets)
    out = torch.empty((b, n_dir, max_objects, levels, levels), dtype=torch.float32,
                      device=labels.device)
    return fm.bind_launch("glcm_all_atomic", None, (labels, img, lo_full, span_full, out),
                          b, h, w, max_objects, levels, n_dir, *fm.padded_offsets(offsets),
                          phases)


# ------------------------------------------------------------- yardsticks
def grouped_stats_original(labels, channels, max_objects, phases=GS_BOXES | GS_WALK):
    """The first ``grouped_stats`` design as a ``launch()``: one block a site,
    boxes by shared atomics, then one thread an object walking its box;
    ``phases`` ``GS_BOXES`` alone stops after the boxes.  It took at most
    8 channels a launch, so more take one launch a group of 8, as its
    wrapper did."""
    launches = []
    for i in range(0, len(channels), ORIGINAL_CHANNELS):
        lab, values = fm._stack(labels, channels[i : i + ORIGINAL_CHANNELS])
        lab, values = lab.contiguous(), values.contiguous()
        b, c, h, w = values.shape
        out = torch.empty((3, b, max_objects, c), dtype=torch.float32, device=lab.device)
        launches.append(bind_launch("grouped_stats_original", None, (lab, values, *out),
                                    b, h, w, c, max_objects, phases))

    def launch():
        for one in launches:
            one()

    return launch


def grouped_stats_library(labels, channels, max_objects):
    """One ``index_add_`` and two ``scatter_reduce_`` calls over the
    pixels of every site at once: the same function from PyTorch's own
    kernels (not bit-identical: ``index_add_`` adds in any order)."""
    b, k, c = labels.shape[0], max_objects, len(channels)
    values = torch.stack([ch.to(torch.float32) for ch in channels], dim=-1).reshape(-1, c)
    flat = labels.reshape(b, -1).long()
    flat = torch.where((flat >= 1) & (flat <= k), flat, 0)
    seg = (flat + torch.arange(b, device=flat.device)[:, None] * (k + 1)).reshape(-1)
    idx = seg[:, None].expand(-1, c)

    def library():
        s = torch.zeros((b * (k + 1), c), device=values.device).index_add_(0, seg, values)
        lo = torch.full_like(s, float("inf")).scatter_reduce_(0, idx, values, "amin")
        hi = torch.full_like(s, float("-inf")).scatter_reduce_(0, idx, values, "amax")
        return s, lo, hi

    return library


def hist_index(labels, intensity, max_objects, bins, bounds) -> torch.Tensor:
    """The fused ``(site, object, bucket)`` index of every counted pixel:
    what ``torch.bincount`` counts in the histogram's yardstick."""
    lo_full, span_full = fm.masked_bounds(*bounds)
    b = labels.shape[0]
    lab = labels.reshape(b, -1).long()
    q = fm.quantize(labels, intensity, lo_full, span_full, bins).reshape(b, -1)
    keep = (lab >= 1) & (lab <= max_objects)
    site = torch.arange(b, device=lab.device)[:, None]
    return ((site * max_objects + lab - 1) * bins + q)[keep]


def glcm_index(labels, intensity, max_objects, levels, offsets, bounds) -> torch.Tensor:
    """The fused ``(site, direction, object, q1, q2)`` index of every
    valid pair: what ``torch.bincount`` counts in the GLCM's yardstick
    (unsymmetrised: the sum with its transpose is left out)."""
    lo_full, span_full = fm.masked_bounds(*bounds)
    b, n_dir = labels.shape[0], len(offsets)
    lab = labels.reshape(b, -1).long()
    q1 = fm.quantize(labels, intensity, lo_full, span_full, levels).reshape(b, -1)
    site = torch.arange(b, device=lab.device)[:, None]
    pairs = []
    for d, (dy, dx) in enumerate(offsets):
        lab2 = kernels.shift_with_fill(labels, -dy, -dx, 0)
        q2 = fm.quantize(lab2, kernels.shift_with_fill(intensity, -dy, -dx, 0.0), lo_full,
                         span_full, levels).reshape(b, -1)
        valid = (lab >= 1) & (lab <= max_objects) & (lab2.reshape(b, -1) == lab)
        row = (site * n_dir + d) * max_objects + lab - 1
        pairs.append(((row * levels + q1) * levels + q2)[valid])
    return torch.cat(pairs)


# ------------------------------------------------------------ bytes bounds
def hist_bytes(b: int, n: int, max_objects: int, bins: int) -> int:
    """Labels and values read once, bounds read once, the table written once."""
    return b * n * 8 + 2 * b * (max_objects + 1) * 4 + b * max_objects * bins * 4


def glcm_bytes(b: int, n: int, max_objects: int, levels: int, n_dir: int) -> int:
    return b * n * 8 + 2 * b * (max_objects + 1) * 4 + n_dir * b * max_objects * levels**2 * 4


# ---------------------------------------------------------- variant sets
def main_path_inputs(device="cuda", batch: int = 64, size: int = 256,
                     max_objects: int = 256, seed: int = 0) -> dict:
    """Config 3's batch segmented the main path's way: DAPI's Otsu mask
    of the smoothed image, the filled mask, the nuclei, Actin's mask and
    the cells grown from the nuclei."""
    from tmlibrary_tpu_torch import benchmarks
    from tmlibrary_tpu_torch.ops import label, smooth, threshold

    data = benchmarks.synthetic_cell_painting_batch(batch, size=size, seed=seed)
    dapi = torch.from_numpy(data["DAPI"]).to(device)
    actin = torch.from_numpy(data["Actin"]).to(device)
    dapi_mask = threshold.threshold_otsu(smooth.gaussian_smooth(dapi, 1.5))
    filled = label.fill_holes(dapi_mask)
    nuclei = label.filter_by_area(
        label.clip_label_count(label.connected_components(filled)[0], max_objects),
        max_objects, min_area=20)
    actin_mask = threshold.threshold_otsu(actin, correction_factor=0.8)
    cells = kernels.watershed_flood(actin, nuclei, actin_mask, n_levels=16)
    return dict(data=data, dapi=dapi, actin=actin, dapi_mask=dapi_mask, filled=filled,
                nuclei=nuclei, actin_mask=actin_mask, cells=cells)


def declump_inputs(filled) -> tuple:
    """The declumping path's watershed inputs on the filled DAPI masks:
    the distance image, its local-maxima seeds and the masks
    (``segment_primary(declump=True)``, 32 levels)."""
    from tmlibrary_tpu_torch.ops.segment_primary import (
        distance_transform_approx, local_maxima_seeds,
    )

    dist = distance_transform_approx(filled)
    return dist, local_maxima_seeds(dist, filled, min_distance=5, smooth_sigma=2.5), filled


def watershed_set(intensity, seeds, mask, n_levels) -> dict:
    args = (intensity, seeds, mask, n_levels)
    glob = kernels.FloodPlan("global")
    return {
        "kernel": kernels.watershed_flood_launcher(*args),
        "global": kernels.watershed_flood_launcher(*args, plan=glob),
        "wrapper": lambda: kernels.watershed_flood(*args),
        "plain": lambda: kernels.watershed_flood_plain(*args),
    }


def fill_set(masks) -> dict:
    glob = kernels.FloodPlan("global")
    return {
        "kernel": kernels.fill_holes_launcher(masks),
        "global": kernels.fill_holes_launcher(masks, plan=glob),
        "wrapper": lambda: kernels.fill_holes_flood(masks),
        "plain": lambda: kernels.fill_holes_flood_plain(masks),
    }


def flood_split_set(kind: str, inputs: dict) -> dict:
    """The first design (``global_*``) and the shipped kernel
    (``kernel_*``) on the inputs of :data:`run`'s ``watershed_split``/
    ``fill_split``."""
    glob = kernels.FloodPlan("global")
    if kind == "fill":
        masks = inputs["dapi_mask"]
        cases = {"real": masks, "full": torch.ones_like(masks)}
        return {f"{who}_{case}": kernels.fill_holes_launcher(
                    m, plan=glob if who == "global" else None)
                for case, m in cases.items() for who in ("global", "kernel")}
    actin, nuclei, mask = inputs["actin"], inputs["nuclei"], inputs["actin_mask"]
    everywhere = torch.where(mask, torch.where(nuclei > 0, nuclei, 1), nuclei)
    cases = {"real": (actin, nuclei, mask, 16), "labelled": (actin, everywhere, mask, 16),
             "levels1": (actin, nuclei, mask, 1)}
    return {f"{who}_{case}": kernels.watershed_flood_launcher(
                *a, plan=glob if who == "global" else None)
            for case, a in cases.items() for who in ("global", "kernel")}


def volume_inputs(device="cuda", batch: int = 16, size: int = 128, depth: int = 16,
                  max_objects: int = 256, seed: int = 0, n_levels: int = 8) -> dict:
    """Config 5's batch segmented the volume path's way: the focus-stacked
    volume, its Otsu mask, the 3-D nuclei, the cell mask (0.8 of the cut)
    and the cells flooded from the nuclei (``n_levels`` levels)."""
    from tmlibrary_tpu_torch import benchmarks
    from tmlibrary_tpu_torch.jterator.modules import get_module
    from tmlibrary_tpu_torch.ops import label, threshold

    data = benchmarks.synthetic_volume_batch(batch, size=size, depth=depth, seed=seed)
    vol = get_module("generate_volume_image")(
        torch.from_numpy(data["DAPI"]).to(device), mode="focus")["volume_image"]
    cut = threshold.otsu_value(vol)[:, None, None, None]
    vmask = vol > cut
    nuclei = label.clip_label_count(volume.connected_components_3d(vmask)[0], max_objects)
    cmask = vol > cut * 0.8
    cells = volume.watershed3d_flood(vol, nuclei, cmask, n_levels)
    return dict(data=data, vol=vol, vmask=vmask, nuclei=nuclei, cmask=cmask, cells=cells,
                n_levels=n_levels)


def feature_channel_calls(labels, max_objects: int, degree: int = 6) -> dict:
    """``{n_channels: (labels, channels)}`` of the ``grouped_stats`` calls
    that ``morphology_features`` (7 channels) and ``zernike_features``
    (32 at degree 6) make on ``labels``."""
    from tmlibrary_tpu_torch.ops import measure

    real, seen = measure.grouped_stats, {}

    def record(lab, channels, m):
        seen.setdefault(len(channels), (lab, channels))
        return real(lab, channels, m)

    measure.grouped_stats = record
    try:
        measure.morphology_features(labels, max_objects)
        measure.zernike_features(labels, max_objects, degree=degree)
    finally:
        measure.grouped_stats = real
    return seen


def grouped_stats_inputs(inputs: dict, max_objects: int, vol_inputs=None) -> dict:
    """The A/B's inputs, ``{name: (labels, channels)}``: config 3's
    3-channel call (nuclei/DAPI), config 4's 7-channel morphology call
    (cells) and 32-channel Zernike call (nuclei), and with ``vol_inputs``
    the volume path's 6-channel call on ``(B, Z, H, W)`` volumes."""
    nuclei, dapi = inputs["nuclei"], inputs["dapi"]
    out = {"c3": (nuclei, [torch.ones_like(dapi), dapi, dapi * dapi]),
           "c4_7": feature_channel_calls(inputs["cells"], max_objects)[7],
           "c4_32": feature_channel_calls(nuclei, max_objects)[32]}
    if vol_inputs is not None:
        out["v6"] = volume.volume_stat_channels(vol_inputs["cells"], vol_inputs["vol"])
    return out


def grouped_stats_set(labels, channels, max_objects) -> dict:
    """The kernel (one launch, every channel) on the caller's channels and
    on views of one stacked copy of them, the first design
    (``original``), the public wrapper and the library yardstick; on
    volumes also the kernel with 2-D boxes over the ``(B, Z*H, W)`` view
    (``kernel_2d``), the view the first design takes."""
    stacked = torch.stack([c.to(torch.float32) for c in channels], dim=1).unbind(1)
    out = {"kernel": fm.grouped_stats_launcher(labels, channels, max_objects),
           "kernel_stacked": fm.grouped_stats_launcher(labels, list(stacked), max_objects)}
    flat_lab, flat_chans = labels, channels
    if labels.dim() == 4:
        b, z, h, w = labels.shape
        flat_lab = labels.reshape(b, z * h, w)
        flat_chans = [c.reshape(b, z * h, w) for c in channels]
        out["kernel_2d"] = fm.grouped_stats_launcher(flat_lab, flat_chans, max_objects)
    out.update({
        "original": grouped_stats_original(flat_lab, flat_chans, max_objects),
        "wrapper": lambda: fm.grouped_stats(labels, channels, max_objects),
        "library": grouped_stats_library(labels, channels, max_objects),
    })
    return out


def grouped_stats_split_set(inputs: dict, max_objects: int) -> dict:
    """The first design taken apart on config 3's 3-channel call: its box
    phase alone (``original_boxes_*``) and whole (``original_*``) on the
    real nuclei and on one object as large as the site (``*_site``: the
    box phase on one shared address, the walk one thread's chain of every
    pixel) -- beside the kernel on the same inputs."""
    nuclei, dapi = inputs["nuclei"], inputs["dapi"]
    chans = [torch.ones_like(dapi), dapi, dapi * dapi]
    cases = {"real": nuclei, "site": torch.ones_like(nuclei)}
    out = {}
    for case, lab in cases.items():
        out[f"original_boxes_{case}"] = grouped_stats_original(lab, chans, max_objects, GS_BOXES)
        out[f"original_{case}"] = grouped_stats_original(lab, chans, max_objects)
        out[f"kernel_{case}"] = fm.grouped_stats_launcher(lab, chans, max_objects)
    return out


def grouped_stats_bytes(labels, n_channels: int, max_objects: int) -> int:
    """What the function must move on these labels: every label, the
    channels of the pixels with an id in 1..``max_objects`` (no other
    value enters a result) and the three outputs."""
    kept = int(((labels >= 1) & (labels <= max_objects)).sum())
    return labels.numel() * 4 + kept * n_channels * 4 + 3 * labels.shape[0] * max_objects * n_channels * 4


def watershed3d_set(vol_inputs: dict) -> dict:
    args = (vol_inputs["vol"], vol_inputs["nuclei"], vol_inputs["cmask"], vol_inputs["n_levels"])
    return {
        "kernel": volume.watershed3d_flood_launcher(*args),
        "global": volume.watershed3d_flood_launcher(*args, plan=kernels.FloodPlan("global")),
        "wrapper": lambda: volume.watershed3d_flood(*args),
        "plain": lambda: volume.watershed3d_flood_plain(*args),
    }


def watershed3d_split_set(vol_inputs: dict) -> dict:
    """The first design (``global_*``) and the cluster kernel
    (``kernel_*``) on the volume path's inputs (``real``), with every
    voxel of the mask a seed (``labelled``: each level one quiet step, so
    the first design's time is 9 full scans) and at one level
    (``levels1``)."""
    vol, nuclei, cmask, n = (vol_inputs[k] for k in ("vol", "nuclei", "cmask", "n_levels"))
    everywhere = torch.where(cmask, torch.where(nuclei > 0, nuclei, 1), nuclei)
    cases = {"real": (vol, nuclei, cmask, n), "labelled": (vol, everywhere, cmask, n),
             "levels1": (vol, nuclei, cmask, 1)}
    glob = kernels.FloodPlan("global")
    return {f"{who}_{case}": volume.watershed3d_flood_launcher(
                *a, plan=glob if who == "global" else None)
            for case, a in cases.items() for who in ("global", "kernel")}


def cc_original(masks, connectivity: "int | None" = None):
    """The first CC design as a ``launch()``: the 2-D one on ``(B, H, W)``
    sites (connectivity 8 unless given), the 3-D one on ``(B, Z, H, W)`` volumes
    (26): one block a site or volume sweeping it in global memory until a
    sweep changes nothing; ``launch.sweeps`` holds each one's sweep count
    after a launch."""
    mask = masks.to(torch.bool).contiguous()
    three_d = mask.dim() == 4
    sweeps = torch.empty(mask.shape[0], dtype=torch.int32, device=mask.device)
    out = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    launch = bind_launch("cc3d_min_propagate_original" if three_d else "cc_min_propagate_original",
                         None, (mask, sweeps, out), *mask.shape,
                         connectivity or (26 if three_d else 8))
    launch.sweeps = sweeps
    return launch


def _cc_kind(masks):
    """The wrapper, launcher and plain version of the 2-D or the 3-D
    labeling, by the masks' rank."""
    if masks.dim() == 4:
        return (volume.cc3d_min_propagate, volume.cc3d_min_propagate_launcher,
                volume.cc3d_min_propagate_plain)
    return kernels.cc_min_propagate, kernels.cc_min_propagate_launcher, kernels.cc_min_propagate_plain


def cc_bytes(masks) -> int:
    """What the labeling must move: the 1-byte mask read once and the
    4-byte labels written once."""
    return masks.numel() * (1 + 4)


def cc_set(masks) -> dict:
    """The union-find kernel's launch (``kernel``), the first design
    (``original``), the public wrapper and the plain labeling, on ``(B,
    H, W)`` sites or ``(B, Z, H, W)`` volumes."""
    wrapper, launcher, plain = _cc_kind(masks)
    return {"kernel": launcher(masks), "original": cc_original(masks),
            "wrapper": lambda: wrapper(masks), "plain": lambda: plain(masks)}


def cc_cases(masks, seed: int = 0) -> dict:
    """The split's inputs: the real masks, all foreground, and seeded
    noise (45% of the pixels in 2-D, 30% of the voxels in 3-D, near the
    percolation thresholds of 8- and 26-connectivity)."""
    g = torch.Generator().manual_seed(seed)
    share = 0.3 if masks.dim() == 4 else 0.45
    noise = (torch.rand(masks.shape, generator=g) < share).to(masks.device)
    return {"real": masks, "full": torch.ones_like(masks, dtype=torch.bool), "noise": noise}


def cc_split_set(masks) -> dict:
    """The first design (``original_*``) and the union-find kernel
    (``kernel_*``) on :func:`cc_cases`; on the real masks also the
    kernel's first phase alone (``local_real``) and its first two
    (``border_real``), so the three phases' times follow by difference."""
    launcher = _cc_kind(masks)[1]
    out = {}
    for case, m in cc_cases(masks).items():
        out[f"original_{case}"] = cc_original(m)
        out[f"kernel_{case}"] = launcher(m)
    out["local_real"] = launcher(masks, phases=kernels.CC_LOCAL)
    out["border_real"] = launcher(masks, phases=kernels.CC_LOCAL | kernels.CC_BORDER)
    return out


# -------------------------------------------------- the distance transform
#: the first distance design holds a distance in a byte, up to the cap 255
ORIGINAL_MAX_DISTANCE = 254


def distance_original_takes(shape, max_distance: int) -> bool:
    """Whether the first design takes ``(B, H, W)`` sites at ``max_distance``:
    caps up to 254 (a byte a pixel), a site's byte plane in one block."""
    h, w = shape[-2:]
    return 0 <= max_distance <= ORIGINAL_MAX_DISTANCE and h * w <= kernels.SMEM_BYTES


def distance_original(masks, max_distance: int = 64):
    """the first distance design as a ``launch()``: one block of 1024 threads
    a site, a byte plane in shared memory swept until a sweep changes
    nothing; ``launch.sweeps`` holds each site's sweep count after a
    launch.  It takes ``max_distance`` up to 254 and sites of at most
    ``kernels.SMEM_BYTES`` pixels."""
    mask = masks.to(torch.bool).contiguous()
    b, h, w = mask.shape
    if not distance_original_takes(mask.shape, max_distance):
        raise ValueError(f"distance_original: max_distance {max_distance} on {h}x{w} sites")
    sweeps = torch.empty(b, dtype=torch.int32, device=mask.device)
    out = torch.empty(mask.shape, dtype=torch.float32, device=mask.device)
    launch = bind_launch("distance_transform_original", None, (mask, sweeps, out), b, h, w,
                         max_distance)
    launch.sweeps = sweeps
    return launch


def distance_cases(filled, seed: int = 0) -> dict:
    """``{name: (masks, max_distance)}``: path D's filled DAPI masks, all
    foreground (every pixel at the cap), one background pixel at the
    centre of a full site at ``max_distance`` 254 (D up to half the
    side), seeded 45% noise and empty sites."""
    g = torch.Generator().manual_seed(seed)
    b, h, w = filled.shape
    full = torch.ones_like(filled, dtype=torch.bool)
    centre = full.clone()
    centre[:, h // 2, w // 2] = False
    noise = (torch.rand(filled.shape, generator=g) < 0.45).to(filled.device)
    return {"real": (filled, 64), "full": (full, 64), "centre": (centre, 254),
            "noise": (noise, 64), "empty": (torch.zeros_like(full), 64)}


def distance_set(masks, max_distance: int = 64) -> dict:
    """The two-pass kernel's launch (``kernel``), the first design
    (``original``), the public wrapper and the plain version."""
    return {"kernel": kernels.distance_transform_launcher(masks, max_distance),
            "original": distance_original(masks, max_distance),
            "wrapper": lambda: kernels.distance_transform(masks, max_distance),
            "plain": lambda: kernels.distance_transform_plain(masks, max_distance)}


def distance_split_set(filled) -> dict:
    """On each of :func:`distance_cases`: the first design (``original_*``,
    with its sweeps), the column pass alone (``columns_*``) and both
    passes (``kernel_*``; the row pass by difference)."""
    out = {}
    for case, (m, cap) in distance_cases(filled).items():
        out[f"original_{case}"] = distance_original(m, cap)
        out[f"columns_{case}"] = kernels.distance_transform_launcher(
            m, cap, phases=kernels.DT_COLUMNS)
        out[f"kernel_{case}"] = kernels.distance_transform_launcher(m, cap)
    return out


def yardsticks(idx: torch.Tensor, cells: int) -> dict:
    """One PyTorch call that counts ready-made indices: ``bincount`` (the
    yardstick of PRs 2-3; it reads the largest index back to the host)
    and ``index_add_`` into a zeroed table (no read-back)."""
    ones = torch.ones_like(idx, dtype=torch.float32)
    table = torch.empty(cells, device=idx.device)
    return {"bincount": lambda: torch.bincount(idx, minlength=cells),
            "index_add": lambda: table.zero_().index_add_(0, idx, ones)}


def hist_set(labels, img, max_objects, bins) -> dict:
    bounds = grouped_minmax(labels, img, max_objects)
    args = (labels, img, max_objects, bins, bounds)
    return {
        "kernel": fm.intensity_hist_launcher(*args),
        **{f"smem_{k}": fm.intensity_hist_launcher(
            *args, fm.plan_hist(max_objects, bins, budget)) for k, budget in SMEM_LEVERS},
        "atomic": intensity_hist_atomic(*args),
        "wrapper": lambda: fm.intensity_hist(*args),
        **yardsticks(hist_index(*args), labels.shape[0] * max_objects * bins),
    }


def glcm_set(labels, img, max_objects, levels, offsets) -> dict:
    bounds = grouped_minmax(labels, img, max_objects)
    args = (labels, img, max_objects, levels, offsets, bounds)
    return {
        "kernel": fm.glcm_all_launcher(*args),
        **{f"smem_{k}": fm.glcm_all_launcher(
            *args, fm.plan_glcm(max_objects, levels, len(offsets), budget))
           for k, budget in SMEM_LEVERS},
        "atomic": glcm_all_atomic(*args),
        "wrapper": lambda: fm.glcm_all(*args),
        **yardsticks(glcm_index(*args), len(offsets) * labels.shape[0] * max_objects * levels**2),
    }


def split_set(kind: str, labels, img, max_objects: int) -> dict:
    """The first design's memset alone and its counting kernel alone on
    zero labels, real labels and real labels over a flat image, the whole
    first design on the real labels, and the shipped kernel on the same
    three inputs."""
    inputs = {"zero": (torch.zeros_like(labels), img), "real": (labels, img),
              "flat": (labels, torch.full_like(img, 777.0))}
    args = {k: (lab, im, max_objects, *((BINS,) if kind == "hist" else (LEVELS, OFFSETS)),
                grouped_minmax(lab, im, max_objects)) for k, (lab, im) in inputs.items()}
    atomic = intensity_hist_atomic if kind == "hist" else glcm_all_atomic
    shipped = fm.intensity_hist_launcher if kind == "hist" else fm.glcm_all_launcher
    variants = {"memset": atomic(*args["real"], PHASE_MEMSET)}
    variants.update({f"atomic_{k}": atomic(*a, PHASE_KERNEL) for k, a in args.items()})
    variants["atomic_full"] = atomic(*args["real"])
    variants.update({f"kernel_{k}": shipped(*a) for k, a in args.items()})
    return variants


def run(inputs: dict, max_objects: int = 256, reps: int = 7, bytes_per_s: float = 3.35e12,
        echo=print, vol_inputs: "dict | None" = None) -> dict:
    """Every variant set on the main path's inputs (and, with
    ``vol_inputs``, the volume path's sets); returns ``{set:
    {"ms": {variant: ms}, "bound_ms": ms or None}}`` and echoes one line
    a set with each variant's bound share (bound ms / ms)."""
    nuclei, cells, dapi, actin = (inputs[k] for k in ("nuclei", "cells", "dapi", "actin"))
    b, h, w = nuclei.shape
    n = h * w
    ws_bytes, fill_bytes = b * n * (4 + 4 + 1 + 4), b * n * (1 + 1)
    sets = {
        "watershed": (watershed_set(actin, nuclei, inputs["actin_mask"], 16), ws_bytes),
        "watershed_declump": (watershed_set(*declump_inputs(inputs["filled"]), 32), ws_bytes),
        "fill": (fill_set(inputs["dapi_mask"]), fill_bytes),
        "watershed_split": (flood_split_set("watershed", inputs), ws_bytes),
        "fill_split": (flood_split_set("fill", inputs), fill_bytes),
        "cc": (cc_set(inputs["dapi_mask"]), cc_bytes(inputs["dapi_mask"])),
        "cc_split": (cc_split_set(inputs["dapi_mask"]), cc_bytes(inputs["dapi_mask"])),
        # a mask byte in and 4 bytes out a pixel, as the labeling
        "distance": (distance_set(inputs["filled"]), cc_bytes(inputs["filled"])),
        "distance_split": (distance_split_set(inputs["filled"]), cc_bytes(inputs["filled"])),
        "hist": (hist_set(nuclei, dapi, max_objects, BINS),
                 hist_bytes(b, n, max_objects, BINS)),
        "hist_cells": (hist_set(cells, actin, max_objects, BINS),
                       hist_bytes(b, n, max_objects, BINS)),
        "glcm": (glcm_set(cells, actin, max_objects, LEVELS, OFFSETS),
                 glcm_bytes(b, n, max_objects, LEVELS, len(OFFSETS))),
        "hist_split": (split_set("hist", nuclei, dapi, max_objects),
                       hist_bytes(b, n, max_objects, BINS)),
        "glcm_split": (split_set("glcm", cells, actin, max_objects),
                       glcm_bytes(b, n, max_objects, LEVELS, len(OFFSETS))),
    }
    for name, (lab, chans) in grouped_stats_inputs(inputs, max_objects, vol_inputs).items():
        sets[f"grouped_stats_{name}"] = (grouped_stats_set(lab, chans, max_objects),
                                         grouped_stats_bytes(lab, len(chans), max_objects))
    sets["grouped_stats_split"] = (grouped_stats_split_set(inputs, max_objects),
                                   grouped_stats_bytes(nuclei, 3, max_objects))
    if vol_inputs is not None:
        vox_bytes = vol_inputs["vol"].numel() * (4 + 4 + 1 + 4)
        sets["watershed3d"] = (watershed3d_set(vol_inputs), vox_bytes)
        sets["watershed3d_split"] = (watershed3d_split_set(vol_inputs), vox_bytes)
        sets["cc3d"] = (cc_set(vol_inputs["vmask"]), cc_bytes(vol_inputs["vmask"]))
        sets["cc3d_split"] = (cc_split_set(vol_inputs["vmask"]), cc_bytes(vol_inputs["vmask"]))
    results = {}
    for name, (variants, nbytes) in sets.items():
        ms = best_of(variants, reps=reps)
        bound = nbytes / bytes_per_s * 1e3
        results[name] = {"ms": ms, "bound_ms": bound}
        echo(f"  shootout {name} (bound {bound:.4f} ms): " + ", ".join(
            f"{v} {t:.4f} ms ({bound / t:.2f} of bound)" for v, t in ms.items()))
        sweeps = {v: fn.sweeps for v, fn in variants.items() if hasattr(fn, "sweeps")}
        if sweeps:
            results[name]["sweeps"] = {v: t.tolist() for v, t in sweeps.items()}
            echo(f"  shootout {name} sweeps per site (min/mean/max): " + ", ".join(
                f"{v} {int(t.min())}/{t.float().mean():.1f}/{int(t.max())}"
                for v, t in sweeps.items()))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise DeviceError("shootout: needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    results = run(main_path_inputs(), reps=args.reps, bytes_per_s=hbm_rate(name),
                  vol_inputs=volume_inputs())
    print(json.dumps({"device": name, "shootout": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
