#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (``tmlibrary_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):

1. Print the card's name and power limit (``nvidia-smi``); build the
   kernels from ``tmlibrary_tpu_torch/csrc`` with ``nvcc`` and print the
   build seconds.
2. At the main paths' shapes (64 sites of 256x256 and 16 z-stacks of
   16x128x128, ``max_objects=256``, synthetic data, plus edge cases),
   hold each of the nine kernels against its plain PyTorch version on
   the card — exact for labels, masks, counts, distances, min and max,
   ``rtol=1e-6`` for fractional sums; ``grouped_stats`` also on every
   channel list that morphology and Zernike hand it (1, 3, 7 and 32
   channels); the distance transform also at a cap of 2, the 3-D
   labeling at connectivity 6, 18 and 26, the 3-D flood on a tied
   plateau; the histogram (2, 16, 256 buckets) and GLCM (8, 16, 32
   levels, 1 and 4 offsets) kernels, and the first designs kept for the
   A/B harness, also on a site with all 256 object slots present, a
   site-sized object at one value, bounds that call present objects
   absent, M=255, planes that are not 16-byte aligned, and every window
   plan — and time the public wrapper (for these two also the launch
   alone), the plain version and, where one PyTorch call computes the
   same function, that call (a yardstick the port never calls) with CUDA
   events after warm-up.
   Then ``tmlibrary_tpu_torch/shootout.py``, the interleaved A/B
   harness: best-of-7 times of row 2's kernel against its plain labeling
   and of the histogram and GLCM kernels against their window sizes,
   their first designs (taken apart: memset, counting on zero, real and
   flat inputs) and the ``bincount``/``index_add_`` yardsticks.
3. Drive six paths through ``build_batch_fn`` on the card, each with
   every launch counter set to 0 just before it and read just after:
   (a) the Cell Painting pipeline (BASELINE config 3), (b) the full
   feature stack (config 4), (c) config 3 with
   ``measure_intensity(quantiles=True)``, (d) config 3 with declumping,
   (e) config 2 (smooth, adaptive threshold, label) and (f) config 5 (the
   3-D z-stack pipeline).  Each path must launch its kernels (paths d-f
   exactly as often as listed in ``main``); labels and counts of the
   first 8 sites equal the port's run on ``device="cpu"`` and every
   feature lies within its tier of ``CARD_TIERS``.  Print sites/sec and a
   stage breakdown, each time beside the card's name and power limit.
4. Print ``kernels: ...``, the per-kernel JSON record, and as the last
   line ``{"ok": true, "device": {...}}``.

The script imports nothing of JAX or of ``tmlibrary_tpu``.
"""

from __future__ import annotations

import fnmatch
import json
import subprocess
import sys
import time
from pathlib import Path

B, SIZE, MAX_OBJECTS, N_CPU_SITES = 64, 256, 256, 8
SEED = 0
#: the volume path (BASELINE config 5, bench.py:138-139, 824-826): 16
#: z-stacks of 16 planes of 128x128, 8 flooding levels
B_V, DEPTH_V, SIZE_V, N_LEVELS_V = 16, 16, 128, 8

#: float32 peak outside the tensor cores, H100 SXM (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12
#: Haralick quantisation levels, GLCM offsets and Zernike degree of
#: config 4, histogram buckets of the quantile path
LEVELS, OFFSETS, BINS = 16, [(0, 1), (1, 0), (1, 1), (1, -1)], 256
ZERNIKE_DEGREE = 6

_EXACT, _SUMS = (0.0, 0.0), (1e-6, 0.0)
#: feature -> (rtol, atol) of the port against the JAX package; (0, 0) is
#: bit-exact.  A pattern matches the name itself or the name with its
#: ``_<channel>`` suffix.  The tests (``tests/test_torch_*.py``) import
#: this table to hold the port's CPU run to the reference.
FEATURE_TIERS = {
    # pixel min/max and integer counts: exact on every route
    "Intensity_max": _EXACT,
    "Intensity_min": _EXACT,
    "Morphology_area": _EXACT,
    "Morphology_bbox_height": _EXACT,
    "Morphology_bbox_width": _EXACT,
    "Morphology_perimeter": _EXACT,
    # histogram buckets mapped back by IEEE + * / (divisions by a tensor)
    "Intensity_p25": _EXACT,
    "Intensity_median": _EXACT,
    "Intensity_p75": _EXACT,
    # fractional sums (another order on the Pallas kernel) and IEEE
    # + - * / sqrt of them
    "Intensity_sum": _SUMS,
    "Intensity_mean": _SUMS,
    "Morphology_centroid_y": _SUMS,
    "Morphology_centroid_x": _SUMS,
    "Morphology_extent": _SUMS,
    "Morphology_equivalent_diameter": _SUMS,
    "Morphology_form_factor": _SUMS,
    "Morphology_major_axis_length": _SUMS,
    "Morphology_minor_axis_length": _SUMS,
    "Morphology_eccentricity": _SUMS,
    # voxel counts exact; centroids, sums and means as fractional sums
    "Volume_voxels": _EXACT,
    "Volume_centroid_*": _SUMS,
    "Volume_intensity_sum": _SUMS,
    "Volume_intensity_mean": _SUMS,
    # sqrt of a difference of sums: cancellation (tests/test_parity_fuzz.py)
    "Intensity_std": (1e-3, 1e-4),
    "Volume_intensity_std": (1e-3, 1e-4),
    # atan2 differs by ulps between libraries and devices
    "Morphology_orientation": (1e-5, 1e-6),
    # log and exp over L*L terms, differing by ulps; info_measure_corr_1
    # is a difference of two entropies, hence the atol
    "Texture_*": (1e-4, 1e-5),
    # cos/sin per pixel; the reference's CPU route is a float64 host
    # twin, held at its own tests' tier (tests/test_measure.py:346)
    "Zernike_*": (2e-3, 2e-4),
}
#: feature -> (rtol, atol) of the card's run against the port's CPU run.
#: Both sides evaluate Zernike's float32 device formulation, so it is held
#: to the card-vs-CPU spread (largest |card - cpu| 1.19e-07, PERF.md) with
#: room for cos/sin ulps, not to the JAX float64 twin's tier.
CARD_TIERS = {**FEATURE_TIERS, "Zernike_*": (1e-5, 1e-6)}


class SmokeFailure(Exception):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    if not out:
        raise SmokeFailure("nvidia-smi printed nothing")
    return out[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(torch, a, b) -> float:
    """Largest |a - b| over entries that differ (equal infinities count 0)."""
    a, b = a.double(), b.double()
    same = a == b
    if bool(same.all()):
        return 0.0
    return float((a - b).abs()[~same].max())


def edge_sites(torch, device):
    """Empty, full, single-pixel, serpentine and checkerboard-noise sites."""
    m = torch.zeros((5, SIZE, SIZE), dtype=torch.bool)
    m[1] = True
    m[2, SIZE - 1, SIZE - 1] = True
    for r in range(0, SIZE, 4):  # a 1-px serpentine through the whole site
        m[3, r, :] = True
        if r + 4 < SIZE:
            col = SIZE - 1 if (r // 4) % 2 == 0 else 0
            m[3, r : r + 5, col] = True
    g = torch.Generator().manual_seed(SEED)
    m[4] = torch.rand((SIZE, SIZE), generator=g) < 0.45
    return m.to(device)


def feature_edge_sites(torch, device):
    """Label and image sites for the feature kernels: empty, full, one
    pixel, a constant object (span 0), objects on all four borders, two
    abutting objects beside an id above the capacity."""
    lab = torch.zeros((6, SIZE, SIZE), dtype=torch.int32)
    img = torch.rand((6, SIZE, SIZE), generator=torch.Generator().manual_seed(SEED)) * 4096
    lab[1] = 1
    lab[2, SIZE - 1, SIZE - 1] = 1
    lab[3, 64:192, 64:192] = 1
    img[3] = 777.0
    lab[4, :16], lab[4, -16:], lab[4, 16:-16, :16], lab[4, 16:-16, -16:] = 1, 2, 3, 4
    lab[5, 100:150, 50:100], lab[5, 100:150, 100:150] = 1, 2
    lab[5, 200:220, 200:220] = MAX_OBJECTS + 1
    return lab.to(device), img.to(device)


def phase_kernels(torch, pkg, inputs):
    """Phase 2, rows 1-6: each kernel against its plain version on the
    card at config 3's and config 4's shapes, edge sites included (rows
    5-6 in :func:`phase_table_kernels`)."""
    kernels, fm, measure = pkg["kernels"], pkg["fused_measure"], pkg["measure"]
    dapi_mask, filled, nuclei, actin, actin_mask, dapi, cells = (inputs[k] for k in (
        "dapi_mask", "filled", "nuclei", "actin", "actin_mask", "dapi", "cells"))
    edges = edge_sites(torch, dapi.device)
    px = B * SIZE * SIZE
    records = []
    compare = make_compare(torch)

    # fill_holes_flood: the Otsu masks of the main path, plus edge sites
    err = compare("fill_holes_flood", kernels.fill_holes_flood(dapi_mask),
                  kernels.fill_holes_flood_plain(dapi_mask))
    err = max(err, compare("fill_holes_flood[edge]", kernels.fill_holes_flood(edges),
                           kernels.fill_holes_flood_plain(edges)))
    records.append(dict(
        name="fill_holes_flood",
        source="tmlibrary_tpu_torch/csrc/fill_holes.cu",
        replaces="tmlibrary_tpu/ops/pallas_kernels.py:323",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: kernels.fill_holes_flood(dapi_mask), 20),
        plain_ms=cuda_ms(torch, lambda: kernels.fill_holes_flood_plain(dapi_mask), 3, 1),
        bytes=px * (1 + 1), ops=px * 4, library_ms=None,
    ))

    # cc_min_propagate: the filled masks, plus edge sites (serpentine, noise)
    err = compare("cc_min_propagate", kernels.cc_min_propagate(filled),
                  kernels.cc_min_propagate_plain(filled))
    for conn in (8, 4):
        err = max(err, compare(f"cc_min_propagate[edge,{conn}]",
                               kernels.cc_min_propagate(edges, conn),
                               kernels.cc_min_propagate_plain(edges, conn)))
    records.append(dict(
        name="cc_min_propagate",
        source="tmlibrary_tpu_torch/csrc/cc_min_propagate.cu",
        replaces="tmlibrary_tpu/ops/pallas_kernels.py:162",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: kernels.cc_min_propagate(filled), 20),
        plain_ms=cuda_ms(torch, lambda: kernels.cc_min_propagate_plain(filled), 3, 1),
        bytes=px * (1 + 4), ops=px * 8, library_ms=None,
    ))

    # watershed_flood: Actin through its Otsu mask from the nuclei seeds
    got = kernels.watershed_flood(actin, nuclei, actin_mask, n_levels=16)
    err = compare("watershed_flood", got,
                  kernels.watershed_flood_plain(actin, nuclei, actin_mask, 16))
    seeded = nuclei > 0
    if not torch.equal(got[seeded], nuclei[seeded]):
        raise SmokeFailure("watershed_flood: a seed lost its label")
    if bool((got[~(actin_mask | seeded)] != 0).any()):
        raise SmokeFailure("watershed_flood: label outside mask | seeds")
    records.append(dict(
        name="watershed_flood",
        source="tmlibrary_tpu_torch/csrc/watershed_flood.cu",
        replaces="tmlibrary_tpu/ops/pallas_kernels.py:244",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: kernels.watershed_flood(actin, nuclei, actin_mask, 16), 10),
        plain_ms=cuda_ms(
            torch, lambda: kernels.watershed_flood_plain(actin, nuclei, actin_mask, 16), 2, 1),
        bytes=px * (4 + 4 + 1 + 4), ops=px * 8, library_ms=None,
    ))

    # grouped_stats: intensity_features' channels [1, v, v^2] of DAPI
    # (timed below), then every call morphology and Zernike make on the
    # nuclei and the cells: 1, 3, 7 and 32 (four groups of 8) channels
    err = grouped_stats_on_feature_paths(torch, fm, measure, (nuclei, cells), compare)
    chans = [torch.ones_like(dapi), dapi, dapi * dapi]
    got = fm.grouped_stats(nuclei, chans, MAX_OBJECTS)
    want = fm.grouped_stats_plain(nuclei, chans, MAX_OBJECTS)
    err = max(err, compare_grouped_stats(torch, "grouped_stats", got, want, compare))
    if not torch.equal(got[0][..., 0], want[0][..., 0]):
        raise SmokeFailure("grouped_stats: counts differ")
    small = fm.grouped_stats(nuclei, chans, 32)  # capacity invariance
    n = int(nuclei.amax())
    if n <= 32 and not all(torch.equal(a[:, :n], b[:, :n]) for a, b in zip(small, got)):
        raise SmokeFailure("grouped_stats: rows depend on max_objects")
    values = torch.stack(chans, dim=-1).reshape(B, -1, 3)
    flat = nuclei.reshape(B, -1).long()
    seg = (flat + torch.arange(B, device=flat.device)[:, None] * (MAX_OBJECTS + 1)).reshape(-1)

    def library():
        v = values.reshape(-1, 3)
        idx = seg[:, None].expand(-1, 3)
        s = torch.zeros((B * (MAX_OBJECTS + 1), 3), device=v.device).index_add_(0, seg, v)
        lo = torch.full_like(s, float("inf")).scatter_reduce_(0, idx, v, "amin")
        hi = torch.full_like(s, float("-inf")).scatter_reduce_(0, idx, v, "amax")
        return s, lo, hi

    records.append(dict(
        name="grouped_stats",
        source="tmlibrary_tpu_torch/csrc/grouped_stats.cu",
        replaces="tmlibrary_tpu/ops/fused_measure.py:178",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: fm.grouped_stats(nuclei, chans, MAX_OBJECTS), 20),
        plain_ms=cuda_ms(torch, lambda: fm.grouped_stats_plain(nuclei, chans, MAX_OBJECTS), 3, 1),
        bytes=px * (4 + 3 * 4) + 3 * B * MAX_OBJECTS * 3 * 4, ops=px * 3 * 3,
        library_ms=cuda_ms(torch, library, 20),
    ))

    records += phase_table_kernels(torch, pkg, inputs, compare)
    return records


def table_edge_batches(torch, device) -> dict:
    """Label and image batches at the count tables' edges: a site with all
    256 object slots present (a 16x16 grid of 16x16 blocks, ids 1..256,
    so every window is live) beside one object covering the whole site at
    one value (a count of 65,536 in one cell), the feature edge sites, the
    first two cut to 255x253, and the first two as contiguous views that
    start one element into their storage (planes that are not 16-byte
    aligned)."""
    yy, xx = torch.meshgrid(torch.arange(SIZE), torch.arange(SIZE), indexing="ij")
    grid = ((yy // 16) * 16 + xx // 16 + 1).to(torch.int32)
    lab = torch.stack([grid, torch.ones_like(grid)])
    noise = torch.rand((SIZE, SIZE), generator=torch.Generator().manual_seed(SEED + 1)) * 4096
    img = torch.stack([noise, torch.full((SIZE, SIZE), 777.0)])
    e_lab, e_img = feature_edge_sites(torch, device)
    lab, img = lab.to(device), img.to(device)
    # an odd width and height: the kernels' one-pixel (not 16-byte) paths
    odd = (lab[:, 1:, 3:].contiguous(), img[:, 1:, 3:].contiguous())
    shifted = tuple(torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape)
                    for t in (lab, img))
    if shifted[0].data_ptr() % 16 == 0 or not shifted[0].is_contiguous():
        raise SmokeFailure("table_edge_batches: the shifted view is aligned")
    return {"capacity": (lab, img), "edge": (e_lab, e_img), "odd": odd, "shifted": shifted}


def absent_bounds(torch, bounds):
    """The raw bounds with every third object called absent (min +inf,
    max -inf) although its pixels are there: the kernels must count them
    with lo 0, span 1, as the reference does."""
    lo, hi = (t.clone() for t in bounds)
    lo[:, ::3], hi[:, ::3] = float("inf"), float("-inf")
    return lo, hi


def table_variants(fm, kind, m, size, n_dir=4) -> list[tuple[str, object, dict]]:
    """``(name, plan)`` of every way the count-table kernels can run: the
    wrapper's plan, 8 KB windows (window edges next to many labels) and a
    flat plan (a budget below one row: windows of single cells)."""
    plan = (lambda b: fm.plan_hist(m, size, b)) if kind == "hist" else (
        lambda b: fm.plan_glcm(m, size, n_dir, b))
    row = 4 * (size if kind == "hist" else n_dir * size * (size + 1))
    out = [("plan", None), ("8KB", plan(8192))]
    if row >= 64:  # a budget below one row that still holds 4 cells
        out.append(("flat", plan(max(row // 2, 32))))
    return out


def check_table_kernels(torch, fm, measure, batches, compare) -> tuple[float, float]:
    """``intensity_hist`` at 2, 16 and 256 buckets and ``glcm_all`` at 8,
    16 and 32 levels with 1 and 4 offsets, each exact against its plain
    version on every batch, at ``max_objects`` 256 and 255 (an M that is
    no multiple of the window), with the true bounds and with
    absent-called objects, under every variant of :func:`table_variants`.
    Returns the largest errors."""
    hist_err = glcm_err = 0.0
    for name, (lab, img) in batches.items():
        for m in (MAX_OBJECTS, MAX_OBJECTS - 1):
            true = measure.grouped_minmax(lab, img, m)
            for b_name, bounds in (("true", true), ("absent", absent_bounds(torch, true))):
                for bins in (2, 16, BINS):
                    want = fm.intensity_hist_plain(lab, img, m, bins, bounds)
                    for v_name, plan in table_variants(fm, "hist", m, bins):
                        got = fm.intensity_hist_launcher(lab, img, m, bins, bounds, plan)()
                        hist_err = max(hist_err, compare(
                            f"intensity_hist[{name},M={m},{b_name},bins={bins},{v_name}]",
                            got, want))
                for levels in (8, LEVELS, 32):
                    for offsets in (OFFSETS[:1], OFFSETS):
                        want = torch.stack(
                            fm.glcm_all_plain(lab, img, m, levels, offsets, bounds), dim=1)
                        for v_name, plan in table_variants(fm, "glcm", m, levels,
                                                           len(offsets)):
                            got = fm.glcm_all_launcher(lab, img, m, levels, offsets, bounds,
                                                       plan)()
                            glcm_err = max(glcm_err, compare(
                                f"glcm_all[{name},M={m},{b_name},L={levels},"
                                f"D={len(offsets)},{v_name}]", got, want))
    return hist_err, glcm_err


def phase_table_kernels(torch, pkg, inputs, compare) -> list[dict]:
    """Phase 2, rows 5-6: the count-table kernels and the first design
    kept for the A/B harness, each exact against the plain versions on the
    main path's inputs and on :func:`check_table_kernels`' matrix.  Like
    every row, ``ms`` times the public wrapper (input checks and the
    launch, what a path pays); ``launch_ms`` times the launch alone on a
    preallocated output, as the A/B harness does."""
    fm, measure, shootout = pkg["fused_measure"], pkg["measure"], pkg["shootout"]
    dapi, nuclei, actin, cells = (inputs[k] for k in ("dapi", "nuclei", "actin", "cells"))
    batches = table_edge_batches(torch, dapi.device)
    hist_err, glcm_err = check_table_kernels(torch, fm, measure, batches, compare)
    b, h, w = nuclei.shape
    records = []

    # intensity_hist: DAPI in the nuclei at 256 buckets (the quantile
    # path's first launch; cells/Actin is its second); bounds from
    # grouped_stats as on that path
    timed = {}
    for key, (lab, img) in {"nuclei": (nuclei, dapi), "cells": (cells, actin),
                            **batches}.items():
        args = (lab, img, MAX_OBJECTS, BINS, measure.grouped_minmax(lab, img, MAX_OBJECTS))
        want = fm.intensity_hist_plain(*args)
        launch = fm.intensity_hist_launcher(*args)
        hist_err = max(hist_err, compare(f"intensity_hist[{key}]", launch(), want))
        hist_err = max(hist_err, compare(f"intensity_hist_atomic[{key}]",
                                         shootout.intensity_hist_atomic(*args)(), want))
        if key in ("nuclei", "cells"):
            timed[key] = (args, launch)
    args, launch = timed["nuclei"]
    cells_args = timed["cells"][0]
    cells_ms = cuda_ms(torch, lambda: fm.intensity_hist(*cells_args), 20)
    idx = shootout.hist_index(*args)
    records.append(dict(
        name="intensity_hist",
        source="tmlibrary_tpu_torch/csrc/intensity_hist.cu",
        replaces="tmlibrary_tpu/ops/fused_measure.py:276",
        max_abs_err=hist_err,
        ms=cuda_ms(torch, lambda: fm.intensity_hist(*args), 20),
        launch_ms=cuda_ms(torch, launch, 20),
        plain_ms=cuda_ms(torch, lambda: fm.intensity_hist_plain(*args), 5, 1),
        bytes=shootout.hist_bytes(b, h * w, MAX_OBJECTS, BINS), ops=b * h * w * 6,
        # yardstick: counting already-quantised pixels (quantisation left out)
        library_ms=cuda_ms(torch, lambda: torch.bincount(
            idx, minlength=b * MAX_OBJECTS * BINS), 20),
    ))
    print(f"  intensity_hist: second call of the quantile path (cells/Actin) "
          f"{cells_ms:.4f} ms beside nuclei/DAPI {records[-1]['ms']:.4f} ms (the public "
          f"wrapper); the launch alone {records[-1]['launch_ms']:.4f} ms")

    # glcm_all: Actin in the cells at 16 levels, 4 directions (config 4's
    # texture)
    for key, (lab, img) in {"cells": (cells, actin), **batches}.items():
        args = (lab, img, MAX_OBJECTS, LEVELS, OFFSETS,
                measure.grouped_minmax(lab, img, MAX_OBJECTS))
        want = torch.stack(fm.glcm_all_plain(*args), dim=1)
        launch = fm.glcm_all_launcher(*args)
        glcm_err = max(glcm_err, compare(f"glcm_all[{key}]", launch(), want))
        glcm_err = max(glcm_err, compare(f"glcm_all_atomic[{key}]",
                                         shootout.glcm_all_atomic(*args)(), want))
        if key == "cells":
            timed = (args, launch)
    args, launch = timed
    idx = shootout.glcm_index(*args)
    records.append(dict(
        name="glcm_all",
        source="tmlibrary_tpu_torch/csrc/glcm_all.cu",
        replaces="tmlibrary_tpu/ops/fused_measure.py:412",
        max_abs_err=glcm_err,
        ms=cuda_ms(torch, lambda: fm.glcm_all(*args), 20),
        launch_ms=cuda_ms(torch, launch, 20),
        plain_ms=cuda_ms(torch, lambda: fm.glcm_all_plain(*args), 5, 1),
        bytes=shootout.glcm_bytes(b, h * w, MAX_OBJECTS, LEVELS, len(OFFSETS)),
        ops=b * h * w * 6 * (1 + len(OFFSETS)),
        # yardstick: counting already-formed pairs (quantisation, pairing
        # and symmetrisation left out)
        library_ms=cuda_ms(torch, lambda: torch.bincount(
            idx, minlength=len(OFFSETS) * b * MAX_OBJECTS * LEVELS * LEVELS), 20),
    ))
    print(f"  glcm_all: the public wrapper {records[-1]['ms']:.4f} ms; the launch alone "
          f"{records[-1]['launch_ms']:.4f} ms")
    return records


def make_compare(torch):
    """``compare(name, got, want, exact=True)``: raise unless the kernel's
    output equals its plain version's (``rtol=1e-6`` where not exact);
    return the largest difference."""
    def compare(name, got, want, exact=True):
        if exact:
            if not torch.equal(got, want):
                raise SmokeFailure(f"{name}: kernel differs from its plain version")
        else:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        return max_abs_err(torch, got, want)

    return compare


def edge_volumes(torch, device):
    """Empty, full, single-voxel and noise volumes at the volume path's
    shape."""
    m = torch.zeros((4, DEPTH_V, SIZE_V, SIZE_V), dtype=torch.bool)
    m[1] = True
    m[2, -1, -1, -1] = True
    m[3] = torch.rand(m[3].shape, generator=torch.Generator().manual_seed(SEED)) < 0.3
    return m.to(device)


def tied_plateau(torch, device):
    """A flat volume, full mask, two seeds at mirrored places: voxels
    equidistant from both are a tie the Jacobi flood must break the
    reference's way (the larger label)."""
    shape = (1, DEPTH_V, SIZE_V, SIZE_V)
    img = torch.ones(shape, device=device)
    seeds = torch.zeros(shape, dtype=torch.int32, device=device)
    seeds[0, DEPTH_V // 2, SIZE_V // 2, SIZE_V // 4] = 1
    seeds[0, DEPTH_V // 2, SIZE_V // 2, 3 * SIZE_V // 4] = 2
    return img, seeds, torch.ones(shape, dtype=torch.bool, device=device)


def phase_kernels_declump_volume(torch, pkg, filled, vol_inputs, compare) -> list[dict]:
    """Phase 2, rows 7-9: the distance transform on the filled DAPI masks
    (path D's input), the 3-D kernels on the volume path's masks and
    seeds; each exact against its plain version, edge cases included."""
    kernels, volume = pkg["kernels"], pkg["volume"]
    vol, vmask, nuclei3d, cmask = vol_inputs
    records = []
    edges = edge_sites(torch, filled.device)
    err = compare("distance_transform", kernels.distance_transform(filled),
                  kernels.distance_transform_plain(filled))
    for cap in (64, 2):  # 2: a cap every nucleus reaches
        for name, m in (("edge", edges), ("main", filled)):
            err = max(err, compare(f"distance_transform[{name},{cap}]",
                                   kernels.distance_transform(m, cap),
                                   kernels.distance_transform_plain(m, cap)))
    px = B * SIZE * SIZE
    records.append(dict(
        name="distance_transform",
        source="tmlibrary_tpu_torch/csrc/distance_transform.cu",
        replaces="tmlibrary_tpu/ops/pallas_kernels.py:581",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: kernels.distance_transform(filled), 20),
        plain_ms=cuda_ms(torch, lambda: kernels.distance_transform_plain(filled), 3, 1),
        bytes=px * (1 + 4), ops=px * 8, library_ms=None,
    ))

    vox = B_V * DEPTH_V * SIZE_V * SIZE_V
    e_vol = edge_volumes(torch, vol.device)
    err = 0.0
    for conn in (26, 18, 6):
        for name, m in (("main", vmask), ("edge", e_vol)):
            err = max(err, compare(f"cc3d_min_propagate[{name},{conn}]",
                                   volume.cc3d_min_propagate(m, conn),
                                   volume.cc3d_min_propagate_plain(m, conn)))
    records.append(dict(
        name="cc3d_min_propagate",
        source="tmlibrary_tpu_torch/csrc/cc3d_min_propagate.cu",
        replaces="tmlibrary_tpu/ops/pallas_kernels.py:424",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: volume.cc3d_min_propagate(vmask), 20),
        plain_ms=cuda_ms(torch, lambda: volume.cc3d_min_propagate_plain(vmask), 2, 1),
        bytes=vox * (1 + 4), ops=vox * 26, library_ms=None,
    ))

    args = (vol, nuclei3d, cmask, N_LEVELS_V)
    got = volume.watershed3d_flood(*args)
    err = compare("watershed3d_flood", got, volume.watershed3d_flood_plain(*args))
    seeded = nuclei3d > 0
    if not torch.equal(got[seeded], nuclei3d[seeded]):
        raise SmokeFailure("watershed3d_flood: a seed lost its label")
    t_img, t_seeds, t_mask = tied_plateau(torch, vol.device)
    zeros = torch.zeros_like(e_vol[:1], dtype=torch.int32)
    for name, a in (("tie", (t_img, t_seeds, t_mask)),
                    ("empty", (t_img, zeros, e_vol[:1])),
                    ("single", (t_img, zeros, e_vol[2:3]))):
        got_e = volume.watershed3d_flood(*a, N_LEVELS_V)
        err = max(err, compare(f"watershed3d_flood[{name}]", got_e,
                               volume.watershed3d_flood_plain(*a, N_LEVELS_V)))
        if name == "tie" and int(got_e[0, DEPTH_V // 2, SIZE_V // 2, SIZE_V // 2]) != 2:
            raise SmokeFailure("watershed3d_flood: the tie did not go to the larger label")
    records.append(dict(
        name="watershed3d_flood",
        source="tmlibrary_tpu_torch/csrc/watershed3d_flood.cu",
        replaces="tmlibrary_tpu/ops/pallas_kernels.py:506",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: volume.watershed3d_flood(*args), 10),
        plain_ms=cuda_ms(torch, lambda: volume.watershed3d_flood_plain(*args), 2, 1),
        bytes=vox * (4 + 4 + 1 + 4), ops=vox * 26, library_ms=None,
    ))
    return records


def finish_records(records, bw) -> None:
    """Route and bound of each record, then its phase-2 line."""
    for r in records:
        r["route"] = "cuda"
        t_bytes = r.pop("bytes") / bw * 1e3
        t_ops = r.pop("ops") / FP32_OPS_PER_S * 1e3
        r["bound_ms"], r["bound_by"] = (
            (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
              f"library {r['library_ms']}), max_abs_err {r['max_abs_err']}")


def compare_grouped_stats(torch, name, got, want, compare) -> float:
    """Sums at ``rtol=1e-6``, mins and maxs exact; the largest error."""
    err = 0.0
    for part, g_, w_ in zip(("sums", "mins", "maxs"), got, want):
        err = max(err, compare(f"{name}.{part}", g_, w_, exact=part != "sums"))
    return err


def grouped_stats_on_feature_paths(torch, fm, measure, label_sets, compare) -> float:
    """Hold ``grouped_stats`` against its plain version on the very
    channels that ``morphology_features`` and ``zernike_features`` (config
    4's degree) hand it for each label batch; fails unless the 1-, 3-, 7-
    and 32-channel calls were all seen.  Returns the largest error."""
    real, seen, err = measure.grouped_stats, set(), 0.0

    def checked(labels, channels, max_objects):
        nonlocal err
        got = real(labels, channels, max_objects)
        want = fm.grouped_stats_plain(labels, channels, max_objects)
        err = max(err, compare_grouped_stats(
            torch, f"grouped_stats[{len(channels)} channels]", got, want, compare))
        seen.add(len(channels))
        return got

    measure.grouped_stats = checked
    try:
        for labels in label_sets:
            measure.morphology_features(labels, MAX_OBJECTS)
            measure.zernike_features(labels, MAX_OBJECTS, degree=ZERNIKE_DEGREE)
    finally:
        measure.grouped_stats = real
    if not {1, 3, 7, 32} <= seen:
        raise SmokeFailure(f"grouped_stats: channel counts {sorted(seen)} checked, "
                           "expected 1, 3, 7 and 32")
    return err


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from tmlibrary_tpu_torch import benchmarks, shootout
        from tmlibrary_tpu_torch.jterator import pipeline
        from tmlibrary_tpu_torch.jterator.description import PipelineDescription
        from tmlibrary_tpu_torch.jterator.modules import get_module
        from tmlibrary_tpu_torch.ops import (
            _cuda, fused_measure, kernels, label, measure, smooth, threshold, volume,
        )
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2

    try:
        # ---------------------------------------------------------- phase 1
        card = card_line()
        print(f"card: {card}")
        name = torch.cuda.get_device_name(0)
        bw = shootout.hbm_rate(name)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        _cuda.lib()
        wall, nvcc_s = time.perf_counter() - t0, _cuda.last_build_seconds
        print(f"build: {wall:.2f} s wall (nvcc {nvcc_s:.2f} s) -> {_cuda.build().name}")

        # ---------------------------------------------------------- phase 2
        dev = torch.device("cuda")
        inputs = shootout.main_path_inputs(dev, B, SIZE, MAX_OBJECTS, SEED)
        data, dapi, actin, filled, nuclei, actin_mask = (inputs[k] for k in (
            "data", "dapi", "actin", "filled", "nuclei", "actin_mask"))
        data_v = benchmarks.synthetic_volume_batch(B_V, size=SIZE_V, depth=DEPTH_V, seed=SEED)
        vol = get_module("generate_volume_image")(
            torch.from_numpy(data_v["DAPI"]).to(dev), mode="focus")["volume_image"]
        t_v = threshold.otsu_value(vol)[:, None, None, None]
        vmask = vol > t_v
        nuclei3d = label.clip_label_count(volume.connected_components_3d(vmask)[0], MAX_OBJECTS)
        print(f"phase 2: kernels vs plain versions at B={B}, {SIZE}x{SIZE} and B={B_V}, "
              f"{DEPTH_V}x{SIZE_V}x{SIZE_V}, max_objects={MAX_OBJECTS} "
              f"({bw / 1e12:.2f} TB/s for the bound); times on {card}")
        records = phase_kernels(
            torch, {"kernels": kernels, "fused_measure": fused_measure, "measure": measure,
                    "shootout": shootout}, inputs)
        records += phase_kernels_declump_volume(
            torch, {"kernels": kernels, "volume": volume}, filled,
            (vol, vmask, nuclei3d, vol > t_v * 0.8), make_compare(torch))
        finish_records(records, bw)

        # ---------------------------------------------------------- shootout
        print(f"shootout: interleaved best-of-7 A/B on the main path's inputs; times on {card}")
        shootout.run(inputs, MAX_OBJECTS, bytes_per_s=bw)

        # ---------------------------------------------------------- phase 3
        wrappers = {
            "fill_holes_flood": kernels.fill_holes_flood,
            "cc_min_propagate": kernels.cc_min_propagate,
            "watershed_flood": kernels.watershed_flood,
            "grouped_stats": fused_measure.grouped_stats,
            "intensity_hist": fused_measure.intensity_hist,
            "glcm_all": fused_measure.glcm_all,
            "distance_transform": kernels.distance_transform,
            "cc3d_min_propagate": volume.cc3d_min_propagate,
            "watershed3d_flood": volume.watershed3d_flood,
        }
        segment = ["fill_holes_flood", "cc_min_propagate", "watershed_flood", "grouped_stats"]
        # (a) config 3
        desc3 = benchmarks.cell_painting_description()
        run3 = drive_path(torch, pipeline, "config 3", desc3, data, wrappers, need=segment,
                          card=card)
        kernel_ms = sum(r["ms"] * run3["launches"][r["name"]] for r in records)
        print(f"  the kernels: {kernel_ms:.2f} ms of a batch at their phase-2 times ({card})")
        print_stages(card, stage_breakdown(
            torch, pkg_ops={"smooth": smooth, "threshold": threshold, "label": label,
                            "kernels": kernels},
            dapi=dapi, actin=actin, nuclei=nuclei, actin_mask=actin_mask))

        # (b) config 4, the full feature stack
        data4 = benchmarks.synthetic_full_stack_batch(B, size=SIZE, seed=SEED)
        desc4 = benchmarks.full_feature_description()
        run4 = drive_path(torch, pipeline, "config 4", desc4, data4, wrappers,
                          need=segment + ["glcm_all"], card=card)
        print_stages(card, stage_breakdown_full(torch, data4, run4["objects"]))

        # (c) config 3 with measure_intensity(quantiles=True)
        pipe = dict(benchmarks.CELL_PAINTING_PIPE)
        pipe["pipeline"] = [
            {"handles": {**item["handles"], "input": item["handles"]["input"] + [
                {"name": "quantiles", "type": "Boolean", "value": True}]}}
            if item["handles"]["module"] == "measure_intensity" else item
            for item in pipe["pipeline"]
        ]
        desc_q = PipelineDescription.from_dict(pipe)
        run_q = drive_path(torch, pipeline, "quantiles", desc_q, data, wrappers,
                           need=segment + ["intensity_hist"], card=card)
        if run_q["launches"]["intensity_hist"] != 2:
            raise SmokeFailure("intensity_hist: expected 2 launches per batch, got "
                               f"{run_q['launches']['intensity_hist']}")

        # (d) config 3 with declumping, on config 3's batch
        run_d = drive_path(
            torch, pipeline, "declump", benchmarks.cell_painting_declump_description(), data,
            wrappers, need=[], card=card, expect={
                "fill_holes_flood": 1, "cc_min_propagate": 1, "distance_transform": 1,
                "watershed_flood": 2, "grouped_stats": 2})
        gained = int(run_d["counts"]["nuclei"].sum() - run3["counts"]["nuclei"].sum())
        print(f"  declumping finds {gained} more nuclei than config 3 in the batch of {B} "
              f"({int(run3['counts']['nuclei'].sum())} -> "
              f"{int(run_d['counts']['nuclei'].sum())})")
        print_stages(card, stage_breakdown_declump(torch, label, filled))

        # (e) config 2: smooth, adaptive threshold, label (DAPI only)
        data2 = benchmarks.synthetic_cell_painting_batch(B, size=SIZE, seed=SEED, dapi_only=True)
        drive_path(torch, pipeline, "config 2", benchmarks.smooth_threshold_description(),
                   data2, wrappers, need=[], card=card, expect={"cc_min_propagate": 1})

        # (f) config 5, the 3-D z-stack pipeline
        run_v = drive_path(
            torch, pipeline, "config 5 (volume)",
            benchmarks.volume_description(n_levels=N_LEVELS_V), data_v, wrappers, need=[],
            card=card, expect={"cc3d_min_propagate": 1, "watershed3d_flood": 1,
                               "grouped_stats": 1})
        print_stages(card, stage_breakdown_volume(torch, data_v, get_module))

        # each kernel's launches: the path that brought it to the port
        path_of = {"intensity_hist": run_q, "glcm_all": run4, "distance_transform": run_d,
                   "cc3d_min_propagate": run_v, "watershed3d_flood": run_v}
        for r in records:
            r["launches"] = path_of.get(r["name"], run3)["launches"][r["name"]]
        if "jax" in sys.modules or "tmlibrary_tpu" in sys.modules:
            raise SmokeFailure("JAX or the JAX package was imported")
    except Exception as e:  # the smoke's boundary: report and exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print("kernels: " + ", ".join(r["name"] for r in records))
    # rows 5-6 add the launch alone beside the wrapper's `ms`
    print(json.dumps({"kernels": [{k: r[k] for k in order + ["launch_ms"] if k in r}
                                  for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def stage_breakdown(torch, pkg_ops, dapi, actin, nuclei, actin_mask) -> dict:
    """CUDA-event time of each step of the main path at the batch's
    shapes, run one by one (a breakdown of where a batch's time goes)."""
    from tmlibrary_tpu_torch.ops.measure import intensity_features

    sm, th, lab, k = (pkg_ops[n] for n in ("smooth", "threshold", "label", "kernels"))
    dapi_sm = sm.gaussian_smooth(dapi, 1.5)
    dapi_mask = th.threshold_otsu(dapi_sm)
    filled = lab.fill_holes(dapi_mask)
    raw_labels = lab.connected_components(filled)[0]
    cells = k.watershed_flood(actin, nuclei, actin_mask, n_levels=16)
    steps = {
        "smooth": lambda: sm.gaussian_smooth(dapi, 1.5),
        "otsu_dapi": lambda: th.threshold_otsu(dapi_sm),
        "fill_holes": lambda: lab.fill_holes(dapi_mask),
        "connected_components": lambda: lab.connected_components(filled),
        "clip_filter_area": lambda: lab.filter_by_area(
            lab.clip_label_count(raw_labels, MAX_OBJECTS), MAX_OBJECTS, min_area=20),
        "otsu_actin": lambda: th.threshold_otsu(actin, correction_factor=0.8),
        "watershed": lambda: k.watershed_flood(actin, nuclei, actin_mask, n_levels=16),
        "measure_x2": lambda: (intensity_features(nuclei, dapi, MAX_OBJECTS),
                               intensity_features(cells, actin, MAX_OBJECTS)),
    }
    return {name: cuda_ms(torch, fn, 5) for name, fn in steps.items()}


def drive_path(torch, pipeline, title, desc, data, wrappers, need, card,
               expect=None) -> dict:
    """Drive one path through ``build_batch_fn`` on the card: a warm-up
    call, then every launch counter set to 0, one call, the counters read
    (each kernel in ``need`` must have launched, each in ``expect``
    exactly that often), the first sites held to the port's CPU run, and
    the batch timed over 5 calls."""
    n = next(iter(data.values())).shape[0]
    raw, stats, shifts = pipeline.from_jax_inputs(data, {}, [[0, 0]] * n, device="cuda")
    fn = pipeline.ImageAnalysisPipeline(desc, MAX_OBJECTS, device="cuda").build_batch_fn()
    fn(raw, stats, shifts)  # warm-up: allocator and first launches
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    result = fn(raw, stats, shifts)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"phase 3, {title}: launches {launches}")
    for k in need:
        if launches[k] < 1:
            raise SmokeFailure(f"{title}: {k} was not launched on this path")
    for k, count in (expect or {}).items():
        if launches[k] != count:
            raise SmokeFailure(f"{title}: {k} launched {launches[k]} times, expected {count}")

    card_res = pipeline.site_result_to_numpy(result)
    sub = {k: v[:N_CPU_SITES] for k, v in data.items()}
    craw, cstats, cshifts = pipeline.from_jax_inputs(
        sub, {}, [[0, 0]] * N_CPU_SITES, device="cpu")
    cpu_res = pipeline.site_result_to_numpy(
        pipeline.ImageAnalysisPipeline(desc, MAX_OBJECTS, device="cpu")
        .build_batch_fn()(craw, cstats, cshifts))
    worst = compare_with_cpu(card_res, cpu_res)
    print(f"  cpu check: labels, counts and {sum(len(f) for f in cpu_res.measurements.values())}"
          f" features of {N_CPU_SITES} sites agree; largest |card - cpu| by family "
          + ", ".join(f"{k} {d:.3g} ({f})" for k, (d, f) in sorted(worst.items())))

    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(raw, stats, shifts)
    torch.cuda.synchronize()
    batch_s = (time.perf_counter() - t0) / reps
    print(f"  pipeline: {n / batch_s:.1f} sites/s ({batch_s * 1e3:.2f} ms per batch "
          f"of {n}; main-path run {main_s * 1e3:.2f} ms) on {card}")
    print("  counts: " + " ".join(
        f"{obj} {c[:N_CPU_SITES].tolist()}" for obj, c in card_res.counts.items()))
    return {"launches": launches, "objects": result.objects, "counts": card_res.counts}


def print_stages(card: str, stages: dict) -> None:
    print("  stages (ms per batch): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"; sum {sum(stages.values()):.3f} on {card}")


def stage_breakdown_declump(torch, label, filled) -> dict:
    """CUDA-event time of each declumping step on the batch's filled DAPI
    masks (the steps ``segment_primary(declump=True)`` adds)."""
    from tmlibrary_tpu_torch.ops.segment_primary import (
        distance_transform_approx, local_maxima_seeds,
    )
    from tmlibrary_tpu_torch.ops.segment_secondary import watershed_from_seeds

    dist = distance_transform_approx(filled)
    seeds = local_maxima_seeds(dist, filled, min_distance=5, smooth_sigma=2.5)
    split = watershed_from_seeds(dist, seeds, filled)
    steps = {
        "distance_transform": lambda: distance_transform_approx(filled),
        "local_maxima_seeds": lambda: local_maxima_seeds(
            dist, filled, min_distance=5, smooth_sigma=2.5),
        "watershed_declump": lambda: watershed_from_seeds(dist, seeds, filled),
        "relabel_by_scan_order": lambda: label.relabel_by_scan_order(
            label.clip_label_count(split, MAX_OBJECTS), MAX_OBJECTS),
    }
    return {name: cuda_ms(torch, fn, 5) for name, fn in steps.items()}


def stage_breakdown_volume(torch, data, get_module) -> dict:
    """CUDA-event time of each module of the volume path at the batch's
    shapes, through the module functions the pipeline calls."""
    zstack = torch.from_numpy(data["DAPI"]).to("cuda")
    vol = get_module("generate_volume_image")(zstack, mode="focus")["volume_image"]
    nuc = get_module("segment_volume")(vol, max_objects=MAX_OBJECTS)["objects"]
    steps = {
        "generate_volume_image": lambda: get_module("generate_volume_image")(
            zstack, mode="focus"),
        "segment_volume": lambda: get_module("segment_volume")(vol, max_objects=MAX_OBJECTS),
        "segment_volume_secondary": lambda: get_module("segment_volume_secondary")(
            vol, nuc, correction_factor=0.8, n_levels=N_LEVELS_V, max_objects=MAX_OBJECTS),
        "measure_volume": lambda: get_module("measure_volume")(
            nuc, vol, max_objects=MAX_OBJECTS),
    }
    return {name: cuda_ms(torch, fn, 3, 1) for name, fn in steps.items()}


def stage_breakdown_full(torch, data, objects) -> dict:
    """CUDA-event time of each module group of config 4 at the batch's
    shapes, through the module functions the pipeline calls."""
    from tmlibrary_tpu_torch.jterator.modules import get_module

    img = {ch: torch.from_numpy(v).to("cuda") for ch, v in data.items()}
    nuclei, cells = objects["nuclei"], objects["cells"]
    m = MAX_OBJECTS

    def segmentation():
        sm = get_module("smooth")(img["DAPI"], sigma=1.5)["smoothed_image"]
        nuc = get_module("segment_primary")(sm, threshold_method="otsu", smooth_sigma=0.0,
                                            min_area=20, max_objects=m)["objects"]
        return get_module("segment_secondary")(nuc, img["Actin"], correction_factor=0.8,
                                               n_levels=16)

    steps = {
        "segmentation": segmentation,
        "intensity_x10": lambda: [get_module("measure_intensity")(o, img[ch], max_objects=m)
                                  for o in (nuclei, cells) for ch in img],
        "morphology_x2": lambda: [get_module("measure_morphology")(o, max_objects=m)
                                  for o in (nuclei, cells)],
        "texture": lambda: get_module("measure_texture")(cells, img["Actin"], levels=LEVELS,
                                                         max_objects=m),
        "zernike": lambda: get_module("measure_zernike")(nuclei, degree=ZERNIKE_DEGREE,
                                                         max_objects=m),
    }
    return {name: cuda_ms(torch, fn, 3, 1) for name, fn in steps.items()}


def feature_tier(name: str, tiers: dict = FEATURE_TIERS) -> tuple[float, float]:
    """The tolerance of a feature in ``tiers``; a name the table does not
    cover (or covers twice) raises ``KeyError``."""
    hits = [tier for pat, tier in tiers.items()
            if fnmatch.fnmatchcase(name, pat) or fnmatch.fnmatchcase(name, pat + "_*")]
    if len(hits) != 1:
        raise KeyError(f"feature '{name}' has {len(hits)} tolerance tiers")
    return hits[0]


def compare_with_cpu(card, cpu) -> dict:
    """Labels and counts exact; every feature within its tier of
    :data:`CARD_TIERS` on the defined rows of the first sites.  Returns
    the largest absolute difference of each feature family and the
    feature where it lies."""
    import numpy as np

    n = N_CPU_SITES
    for obj in cpu.objects:
        if not np.array_equal(card.objects[obj][:n], cpu.objects[obj]):
            raise SmokeFailure(f"{obj}: card labels differ from the CPU run")
        if not np.array_equal(card.counts[obj][:n], cpu.counts[obj]):
            raise SmokeFailure(f"{obj}: card counts differ from the CPU run")
    worst: dict[str, tuple[float, str]] = {}
    for obj, feats in cpu.measurements.items():
        counts = cpu.counts[obj]
        for feat, want in feats.items():
            got = card.measurements[obj][feat][:n]
            if got.shape != want.shape:
                raise SmokeFailure(f"{feat}: shape {got.shape} != {want.shape}")
            rtol, atol = feature_tier(feat, CARD_TIERS)
            family = feat.split("_")[0]
            for s in range(n):
                g, w = got[s, : counts[s]], want[s, : counts[s]]
                if not np.isfinite(g).all():
                    raise SmokeFailure(f"{obj}/{feat}: non-finite values")
                if g.size:
                    diff = float(np.abs(g.astype(np.float64) - w).max())
                    worst[family] = max(worst.get(family, (0.0, "")), (diff, feat))
                if rtol == atol == 0.0:
                    np.testing.assert_array_equal(g, w, err_msg=f"{obj}/{feat}")
                else:
                    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                               err_msg=f"{obj}/{feat}")
    return worst


if __name__ == "__main__":
    sys.exit(main())
