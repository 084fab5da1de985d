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

- ``cc``: row 2's kernel (``kernel``) against the port's plain labeling
  (``plain``) on the Otsu masks of the smoothed DAPI — the script's
  ``shipped`` against ``xla``.  Its ``chunk16``/``chunk4`` variants set
  the TPU kernel's tile (``CHUNK``) and have no CUDA counterpart.
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
- ``hist_split``/``glcm_split``: the first design taken apart — the
  memset alone (``memset``), the counting kernel alone on an all-zero
  label batch (``atomic_zero``: a launch and a read of every pixel, no
  atomics), on the real labels (``atomic_real``) and on the real labels
  over a constant image (``atomic_flat``: each object's pixels in one
  bucket, the worst contention) — beside the shipped kernel on the same
  three inputs (``kernel_zero``, ``kernel_real``, ``kernel_flat``).

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
from tmlibrary_tpu_torch.ops.measure import grouped_minmax

#: HBM bandwidth by card (NVIDIA data sheets); the SXM part is the default
HBM_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H100", 3.35e12))
#: ``phases`` of the first designs' entry points
PHASE_MEMSET, PHASE_KERNEL = 1, 2
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


def cc_set(masks) -> dict:
    return {"kernel": lambda: kernels.cc_min_propagate(masks),
            "plain": lambda: kernels.cc_min_propagate_plain(masks)}


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
        echo=print) -> dict:
    """Every variant set on the main path's inputs; returns ``{set:
    {"ms": {variant: ms}, "bound_ms": ms or None}}`` and echoes one line
    a set with each variant's bound share (bound ms / ms)."""
    nuclei, cells, dapi, actin = (inputs[k] for k in ("nuclei", "cells", "dapi", "actin"))
    b, h, w = nuclei.shape
    n = h * w
    sets = {
        "cc": (cc_set(inputs["dapi_mask"]), b * n * (1 + 4)),
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
    results = {}
    for name, (variants, nbytes) in sets.items():
        ms = best_of(variants, reps=reps)
        bound = nbytes / bytes_per_s * 1e3
        results[name] = {"ms": ms, "bound_ms": bound}
        echo(f"  shootout {name} (bound {bound:.4f} ms): " + ", ".join(
            f"{v} {t:.4f} ms ({bound / t:.2f} of bound)" for v, t in ms.items()))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise DeviceError("shootout: needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    results = run(main_path_inputs(), reps=args.reps, bytes_per_s=hbm_rate(name))
    print(json.dumps({"device": name, "shootout": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
