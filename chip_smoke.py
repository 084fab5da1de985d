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
   the card -- exact for labels, masks, counts, distances, sums, min and
   max (NaN where the plain version has NaN); the two 2-D floods on every
   route (on chip, on chip with frontier lists of 16, the first design as
   ``global``) on the main and declumping inputs, edge sites, a 1-px
   spiral, a tied plateau, seed ids beyond 16 bits and negative, NaN
   intensities, 1, 254 and 255 levels, connectivity 4 and 8, a 255x253
   crop and a 1024x1024 site, printing the routes taken;
   ``grouped_stats`` also on every channel list that morphology and
   Zernike hand it (1, 3, 7 and 32 channels), on NaN pixels, on more
   than 3072 objects at ``max_objects=4096``, at two band counts and on the
   volume path's call (3-D boxes, and 2-D over a ``(B, Z*H, W)`` view);
   the distance transform (two passes, and the first design kept for the
   A/B where it takes the input)
   at max_distance 0, 2, 64, 254 and 300 on path D's masks, edge,
   all-foreground, centre-pixel, noise and empty sites, 257x130,
   1x4096, 4096x1, 483x483 and 1024x1024 sites, at 100,000 on 1x70000
   and 70000x1 sites, on noise ten launches in a row, and inside
   ``segment_primary(declump=True)`` on 512x512 sites against the CPU;
   the 2-D labeling (union-find, and the first design kept for the A/B) at
   connectivity 8 and 4 on the main path's masks, edge sites at 256x256,
   257x130 and 1024x1024, a comb of 1-px lines on the tile edges (256x256
   and 1024x1024) and a 1-px spiral; the 3-D labeling (and its first
   design) at connectivity 26, 18 and 6 on the volume path's masks, edge
   volumes, a 64x256x256 volume, 17x100x37 noise and one plane; both on
   45% (30% in 3-D) noise ten launches in a row; the 3-D flood on every
   route (cluster, ``global``) on the volume
   path's inputs, a tied plateau, empty and single-voxel masks, id
   edges, NaN, 1, 254 and 255 levels, a 5x37x41 crop and one plane; the
   histogram (2, 16, 256 buckets) and GLCM (8, 16, 32 levels, 1 and 4
   offsets) kernels, and the first designs kept for the A/B harness,
   also on a site with all 256 object slots present, a site-sized object
   at one value, bounds that call present objects absent, M=255, planes
   that are not 16-byte aligned, and every window plan -- and time the
   public wrapper (for the floods, ``grouped_stats`` and the
   count-table kernels also the launch alone), the plain version and,
   where one PyTorch call computes the same function, that call (a
   yardstick the port never calls) with CUDA events after warm-up.
   Then ``tmlibrary_tpu_torch/shootout.py``, the interleaved A/B
   harness: best-of-7 times of the two 2-D floods, ``grouped_stats`` and
   the 3-D flood against their first designs (taken apart: fully
   labelled sites, one level, all-foreground masks, the box phase alone,
   a site-sized object), of row 7 against its first design (taken
   apart: the column pass alone, on all-foreground, centre-pixel, noise
   and empty sites, with the first design's sweep counts), of rows 2 and
   8 against their first
   designs, their wrappers and plain labelings (taken apart: real,
   all-foreground and noise masks with the first designs' sweep counts,
   the union-find's phases by prefix) and of the histogram and GLCM kernels against their window sizes,
   their first designs (taken apart: memset, counting on zero, real and
   flat inputs) and the ``bincount``/``index_add_`` yardsticks.
3. Drive six paths through ``build_batch_fn`` on the card, each with
   every launch counter set to 0 just before it and read just after:
   (a) the Cell Painting pipeline (BASELINE config 3), (b) the full
   feature stack (config 4), (c) config 3 with
   ``measure_intensity(quantiles=True)``, (d) config 3 with declumping,
   (e) config 2 (smooth, adaptive threshold, label) and (f) config 5 (the
   3-D z-stack pipeline).  Each path must launch its kernels (paths d-f
   exactly as often as listed in ``main``, paths a-e the 2-D labeling and
   f the 3-D labeling once; the floods on their main routes); labels and
   counts of the
   first 8 sites equal the port's run on ``device="cpu"`` and every
   feature lies within its tier of ``CARD_TIERS``.  Print sites/sec and a
   stage breakdown, each time beside the card's name and power limit;
   for the volume path split ``measure_volume``.
4. Print ``kernels: ...``, the per-kernel JSON record (the nine kernels
   and row 10, ``scripts/cc_kernel_shootout.py``, row 2's function timed
   in the A/B harness), and as the last line ``{"ok": true, "device": {...}}``.

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
    """Largest |a - b| over entries that differ (equal infinities and NaN
    against NaN count 0)."""
    a, b = a.double(), b.double()
    same = (a == b) | (a.isnan() & b.isnan())
    if bool(same.all()):
        return 0.0
    return float((a - b).abs()[~same].max())


def edge_sites(torch, device, h=SIZE, w=SIZE):
    """Empty, full, single-pixel, serpentine and checkerboard-noise sites."""
    m = torch.zeros((5, h, w), dtype=torch.bool)
    m[1] = True
    m[2, h - 1, w - 1] = True
    for r in range(0, h, 4):  # a 1-px serpentine through the whole site
        m[3, r, :] = True
        if r + 4 < h:
            col = w - 1 if (r // 4) % 2 == 0 else 0
            m[3, r : r + 5, col] = True
    g = torch.Generator().manual_seed(SEED)
    m[4] = torch.rand((h, w), generator=g) < 0.45
    return m.to(device)


def tile_comb(torch, device, size, tile=32):
    """A comb of 1-px lines on the union-find kernel's tile edges: a spine
    along the first row and a tooth down the last column of every tile,
    stepping to the next tile's first column at every tile row, so the
    tooth's halves touch only diagonally where four tiles meet."""
    m = torch.zeros((1, size, size), dtype=torch.bool)
    m[0, 0] = True
    for k in range(1, size // tile):
        for y0 in range(0, size, tile):
            col = tile * k - 1 if (y0 // tile) % 2 == 0 else tile * k
            m[0, max(y0, 1) : y0 + tile, col] = True
    return m.to(device)


def cc_cases_2d(torch, filled, dapi_mask) -> dict:
    """Inputs of the 2-D labeling's holds: the main path's filled masks and
    Otsu masks, edge sites at 256x256 and at a ragged 257x130, the tile
    comb at 256x256 and 1024x1024, edge sites at 1024x1024 (the
    serpentine left out: the plain propagation would walk its 262,144
    pixels one step each) and a 1-px spiral corridor in a 256x256 site."""
    dev = filled.device
    big = edge_sites(torch, dev, 1024, 1024)
    spiral = torch.zeros((1, SIZE, SIZE), dtype=torch.bool)
    spiral[0, : SIZE - 1, : SIZE - 1] = ~spiral_site(torch, (SIZE - 1) // 2)
    return {"main": filled, "otsu": dapi_mask, "edge": edge_sites(torch, dev),
            "edge257x130": edge_sites(torch, dev, 257, 130),
            "comb": tile_comb(torch, dev, SIZE), "comb1024": tile_comb(torch, dev, 1024),
            "edge1024": big[[0, 1, 2, 4]], "spiral": spiral.to(dev)}


def repeat_hold(torch, name, compare, run, want, times: int = 10) -> float:
    """``run()`` exact against ``want`` ``times`` times over: the union-find
    kernels' blocks meet in another order every launch, and a race that
    loses a union shows on some launches only."""
    err = 0.0
    for i in range(times):
        err = max(err, compare(f"{name}, launch {i + 1} of {times}", run(), want))
    print(f"  {name}: {tuple(want.shape)}, exact on {times} launches in a row")
    return err


def cc_record(torch, kernels, shootout, filled, dapi_mask, compare) -> dict:
    """Row 2: the union-find kernel (the wrapper) and the first design kept
    for the A/B harness, each exact against the plain version at
    connectivity 8 and 4 on every input of :func:`cc_cases_2d`."""
    err = 0.0
    for name, m in cc_cases_2d(torch, filled, dapi_mask).items():
        for conn in (8, 4):
            want = kernels.cc_min_propagate_plain(m, conn)
            err = max(err, compare(f"cc_min_propagate[{name},{conn}]",
                                   kernels.cc_min_propagate(m, conn), want))
            original = shootout.cc_original(m, conn)
            err = max(err, compare(f"cc_min_propagate[{name},{conn},original]", original(), want))
        print(f"  cc_min_propagate[{name}]: {tuple(m.shape)}, connectivity 8 and 4: exact on the "
              f"kernel and the first design (its sweeps per site up to {int(original.sweeps.max())})")
    noise = shootout.cc_cases(dapi_mask)["noise"]
    for conn in (8, 4):
        err = max(err, repeat_hold(torch, f"cc_min_propagate[noise,{conn}]", compare,
                                   lambda: kernels.cc_min_propagate(noise, conn),
                                   kernels.cc_min_propagate_plain(noise, conn)))
    px = B * SIZE * SIZE
    return dict(
        name="cc_min_propagate",
        source="tmlibrary_tpu_torch/csrc/cc_min_propagate.cu",
        replaces="tmlibrary_tpu/ops/pallas_kernels.py:162",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: kernels.cc_min_propagate(filled), 20),
        launch_ms=cuda_ms(torch, kernels.cc_min_propagate_launcher(filled), 20),
        plain_ms=cuda_ms(torch, lambda: kernels.cc_min_propagate_plain(filled), 3, 1),
        bytes=px * (1 + 4), ops=px * 8, library_ms=None,
    )


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
    filled, nuclei, dapi, cells = (inputs[k] for k in ("filled", "nuclei", "dapi", "cells"))
    px = B * SIZE * SIZE
    records = []
    compare = make_compare(torch)

    records += phase_floods(torch, kernels, pkg["shootout"], inputs, compare)

    records.append(cc_record(torch, kernels, pkg["shootout"], filled, inputs["dapi_mask"],
                             compare))

    # grouped_stats: intensity_features' channels [1, v, v^2] of DAPI
    # (timed below), then every call morphology and Zernike make on the
    # nuclei and the cells: 1, 3, 7 and 32 (one launch) channels; then
    # NaN pixels, 4096 objects and ids above the capacity
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
    err = max(err, grouped_stats_edges(torch, fm, nuclei, dapi, compare))
    library = pkg["shootout"].grouped_stats_library(nuclei, chans, MAX_OBJECTS)

    records.append(dict(
        name="grouped_stats",
        source="tmlibrary_tpu_torch/csrc/grouped_stats.cu",
        replaces="tmlibrary_tpu/ops/fused_measure.py:178",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: fm.grouped_stats(nuclei, chans, MAX_OBJECTS), 20),
        launch_ms=cuda_ms(torch, fm.grouped_stats_launcher(nuclei, chans, MAX_OBJECTS), 20),
        plain_ms=cuda_ms(torch, lambda: fm.grouped_stats_plain(nuclei, chans, MAX_OBJECTS), 3, 1),
        bytes=pkg["shootout"].grouped_stats_bytes(nuclei, 3, MAX_OBJECTS), ops=px * 3 * 3,
        library_ms=cuda_ms(torch, library, 20),
    ))

    records += phase_table_kernels(torch, pkg, inputs, compare)
    return records


def spiral_site(torch, cells):
    """A one-pixel background corridor carved through foreground from a
    door on the border to the centre, in a rectangular spiral over
    ``cells`` x ``cells`` cells (``2 * cells + 1`` pixels a side), its
    last cell cut off (a hole): every turn costs the on-chip fill a pass."""
    m = torch.ones((2 * cells + 1, 2 * cells + 1), dtype=torch.bool)
    top, left, bottom, right = 0, 0, cells - 1, cells - 1
    order = []
    while top <= bottom and left <= right:
        order += [(top, j) for j in range(left, right + 1)]
        order += [(i, right) for i in range(top + 1, bottom + 1)]
        if top < bottom:
            order += [(bottom, j) for j in range(right - 1, left - 1, -1)]
        if left < right:
            order += [(i, left) for i in range(bottom - 1, top, -1)]
        top, left, bottom, right = top + 1, left + 1, bottom - 1, right - 1
    m[0, 1] = False
    for i, j in order:
        m[2 * i + 1, 2 * j + 1] = False
    for (a, b), (c, d) in zip(order[:-2], order[1:-1]):
        m[a + c + 1, b + d + 1] = False
    return m


def flood_cases(torch, shootout, inputs):
    """Inputs of the edge checks for the two floods.  Watershed: name ->
    (intensity, seeds, mask, n_levels, connectivity); fill: name ->
    (masks, connectivity).  The main path's and the declumping path's
    inputs, edge sites, a 2-D tied plateau, seed ids at and beyond 16 bits
    and negative, NaN intensities (in the mask, outside it, at a seed,
    everywhere), 1, 254 (the most on chip) and 255 levels, both
    connectivities, a 255x253 crop
    and one 1024x1024 site (too large for the on-chip routes)."""
    actin, nuclei, am, dapi_mask = (inputs[k] for k in ("actin", "nuclei", "actin_mask",
                                                        "dapi_mask"))
    dev = actin.device
    edges = edge_sites(torch, dev)
    g = torch.Generator().manual_seed(SEED + 2)
    e_img = torch.rand(edges.shape, generator=g).to(dev)
    e_seeds = torch.zeros(edges.shape, dtype=torch.int32, device=dev)
    e_seeds[:, 0, 0], e_seeds[:, SIZE // 2, SIZE // 3], e_seeds[:, -1, -1] = 1, 2, 3
    flat = torch.ones((1, SIZE, SIZE), device=dev)
    tie = torch.zeros((1, SIZE, SIZE), dtype=torch.int32, device=dev)
    tie[0, SIZE // 2, SIZE // 4], tie[0, SIZE // 2, 3 * SIZE // 4] = 1, 3
    tie[0, SIZE // 4, SIZE // 2] = 2
    ids = nuclei[:4].clone()
    ids[0][ids[0] == 1] = 70000          # beyond 16 bits: the global loop, same launch
    ids[0][ids[0] == 2] = 2**31 - 1
    ids[1][ids[1] == 1] = 65534          # the largest id on chip
    ids[2, 10:20, 10:20] = -5            # negative: keeps its value, never spreads
    ids[3][ids[3] == 1] = -1
    nan = actin[:4].clone()  # NaN in the mask, outside it only, at a seed, everywhere
    y, x = (am[0] & (nuclei[0] == 0)).nonzero()[7].tolist()
    nan[0, y, x] = float("nan")
    nan[1][~(am[1] | (nuclei[1] > 0))] = float("nan")
    nan[2][nuclei[2] == 1] = float("nan")
    nan[3][am[3]] = float("nan")
    crop = tuple(t[:8, 1:, 3:].contiguous() for t in (actin, nuclei, am))
    large = tuple(t[:1].repeat(1, 4, 4) for t in (actin, nuclei, am))
    ws = {
        "main": (actin, nuclei, am, 16, 8),
        "main,4": (actin, nuclei, am, 16, 4),
        "declump": (*shootout.declump_inputs(inputs["filled"]), 32, 8),
        "edge": (e_img, e_seeds, edges, 16, 8),
        "edge,4": (e_img, e_seeds, edges, 16, 4),
        "plateau": (flat, tie, torch.ones_like(flat, dtype=torch.bool), 16, 8),
        "plateau,4": (flat, tie, torch.ones_like(flat, dtype=torch.bool), 16, 4),
        "ids": (actin[:4], ids, am[:4], 16, 8),
        "nan": (nan, nuclei[:4], am[:4], 16, 8),
        "nan,4": (nan, nuclei[:4], am[:4], 16, 4),
        "levels1": (actin, nuclei, am, 1, 8),
        "levels254": (actin[:8], nuclei[:8], am[:8], 254, 8),
        "levels255": (actin[:8], nuclei[:8], am[:8], 255, 8),
        "crop": (*crop, 16, 8),
        "1024": (*large, 16, 8),
    }
    spiral = torch.zeros((1, SIZE, SIZE), dtype=torch.bool)
    spiral[0, : SIZE - 1, : SIZE - 1] = spiral_site(torch, (SIZE - 1) // 2)
    fill = {}
    for conn in (4, 8):
        fill.update({f"main,{conn}": (dapi_mask, conn), f"edge,{conn}": (edges, conn),
                     f"spiral,{conn}": (spiral.to(dev), conn),
                     f"crop,{conn}": (dapi_mask[:8, 1:, 3:].contiguous(), conn),
                     f"1024,{conn}": (dapi_mask[:1].repeat(1, 4, 4), conn)})
    return ws, fill


def phase_floods(torch, kernels, shootout, inputs, compare) -> list[dict]:
    """Phase 2, rows 1 and 3: ``fill_holes_flood`` and ``watershed_flood``
    on every route -- the public wrapper (the route its planner picks),
    the on-chip kernel with frontier lists of 16 (most steps overflow into
    scans) and the first design on global planes (``global``) -- each
    exact against the plain version on every input of
    :func:`flood_cases`; prints the routes each input took.
    ``ms`` times the public wrapper on the main path's inputs,
    ``launch_ms`` the launch alone."""
    ws_cases, fill_cases = flood_cases(torch, shootout, inputs)
    glob = kernels.FloodPlan("global")
    fill_err = 0.0
    for name, (masks, conn) in fill_cases.items():
        want = kernels.fill_holes_flood_plain(masks, conn)
        plan = kernels.fill_plan(masks.shape)
        runs = {f"wrapper({plan.route})": lambda: kernels.fill_holes_flood(masks, conn),
                "global": kernels.fill_holes_launcher(masks, conn, glob)}
        for who, run in runs.items():
            fill_err = max(fill_err, compare(f"fill_holes_flood[{name},{who}]", run(), want))
        print(f"  fill_holes_flood[{name}]: {tuple(masks.shape)}, exact on "
              + ", ".join(runs))
    ws_err = 0.0
    for name, (img, seeds, mask, levels, conn) in ws_cases.items():
        args = (img, seeds, mask, levels, conn)
        want = kernels.watershed_flood_plain(*args)
        plan = kernels.watershed_plan(img.shape, levels)
        got = kernels.watershed_flood(*args)
        ws_err = max(ws_err, compare(f"watershed_flood[{name},wrapper]", got, want))
        site = kernels.watershed_flood.site_routes.tolist()
        runs = {"global": kernels.watershed_flood_launcher(*args, plan=glob)}
        if plan.route == "onchip":
            runs["cap16"] = kernels.watershed_flood_launcher(
                *args, plan=kernels.watershed_plan(img.shape, levels, 16))
        for who, launch in runs.items():
            ws_err = max(ws_err, compare(f"watershed_flood[{name},{who}]", launch(), want))
        if name in ("main", "ids") and runs.get("cap16") is not None:
            if runs["cap16"].site_routes.tolist() != site:
                raise SmokeFailure(f"watershed_flood[{name}]: site routes differ with cap 16")
        seeded = seeds > 0
        if not torch.equal(got[seeded], seeds[seeded]):
            raise SmokeFailure(f"watershed_flood[{name}]: a seed lost its label")
        if bool((got[~(mask | seeded)] != 0).any()):
            raise SmokeFailure(f"watershed_flood[{name}]: label outside mask | seeds")
        if name.startswith("plateau") and int(got[0, SIZE // 2, SIZE // 2]) != 3:
            raise SmokeFailure(f"watershed_flood[{name}]: the tie did not go to the larger label")
        if name == "levels254" and plan.route != "onchip":
            raise SmokeFailure("watershed_flood[levels254]: 254 levels must run on chip")
        expect = [1] if plan.route == "global" else [0]
        if name == "ids":
            expect = [1, 0, 0, 0]
            neg = seeds < 0
            if not torch.equal(got[neg & mask], seeds[neg & mask]):
                raise SmokeFailure("watershed_flood[ids]: a negative seed changed")
        if set(site) != set(expect) or (name == "ids" and site != expect):
            raise SmokeFailure(f"watershed_flood[{name}]: site routes {site}, expected {expect}")
        print(f"  watershed_flood[{name}]: {tuple(img.shape)}, {levels} levels, "
              f"connectivity {conn}: wrapper route {plan.route}"
              f"{f' (cap {plan.cap})' if plan.cap else ''}, sites on chip {site.count(0)}, "
              f"global {site.count(1)}; exact on wrapper, " + ", ".join(runs))

    dapi_mask, actin, nuclei, am = (inputs[k] for k in ("dapi_mask", "actin", "nuclei",
                                                        "actin_mask"))
    px = B * SIZE * SIZE
    ws_args = (actin, nuclei, am, 16)
    return [
        dict(name="fill_holes_flood", source="tmlibrary_tpu_torch/csrc/fill_holes.cu",
             replaces="tmlibrary_tpu/ops/pallas_kernels.py:323", max_abs_err=fill_err,
             ms=cuda_ms(torch, lambda: kernels.fill_holes_flood(dapi_mask), 20),
             launch_ms=cuda_ms(torch, kernels.fill_holes_launcher(dapi_mask), 20),
             plain_ms=cuda_ms(torch, lambda: kernels.fill_holes_flood_plain(dapi_mask), 3, 1),
             bytes=px * (1 + 1), ops=px * 4, library_ms=None),
        dict(name="watershed_flood", source="tmlibrary_tpu_torch/csrc/watershed_flood.cu",
             replaces="tmlibrary_tpu/ops/pallas_kernels.py:244", max_abs_err=ws_err,
             ms=cuda_ms(torch, lambda: kernels.watershed_flood(*ws_args), 20),
             launch_ms=cuda_ms(torch, kernels.watershed_flood_launcher(*ws_args), 20),
             plain_ms=cuda_ms(torch, lambda: kernels.watershed_flood_plain(*ws_args), 2, 1),
             bytes=px * (4 + 4 + 1 + 4), ops=px * 8, library_ms=None),
    ]
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
    output equals its plain version's (NaN where it has NaN; ``rtol=1e-6``
    where not exact); return the largest difference."""
    def compare(name, got, want, exact=True):
        if exact:
            nan = want.isnan() if want.is_floating_point() else None
            if nan is not None and bool(nan.any()):
                same = torch.equal(got.isnan(), nan) and torch.equal(got[~nan], want[~nan])
            else:
                same = torch.equal(got, want)
            if not same:
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


def phase_kernels_declump_volume(torch, pkg, filled, vi, compare):
    """Phase 2, rows 7-9: the distance transform (:func:`distance_record`);
    the 3-D kernels on the volume path's
    masks and seeds, the 3-D flood on every route and on edge volumes,
    ``grouped_stats`` on the volume path's view; each exact against its
    plain version.  Returns the records of rows 7-9 and the largest
    ``grouped_stats`` error on the view."""
    kernels, volume, fm = pkg["kernels"], pkg["volume"], pkg["fused_measure"]
    vol, vmask, nuclei3d, cmask = (vi[k] for k in ("vol", "vmask", "nuclei", "cmask"))
    glob = kernels.FloodPlan("global")
    records = [distance_record(torch, kernels, pkg["shootout"], pkg["segment_primary"], filled,
                               compare)]

    vox = B_V * DEPTH_V * SIZE_V * SIZE_V
    e_vol = edge_volumes(torch, vol.device)
    records.append(cc3d_record(torch, volume, pkg["shootout"], vmask, e_vol, compare))

    args = (vol, nuclei3d, cmask, N_LEVELS_V)
    err = 0.0
    for name, (img, seeds, mask, levels) in flood3d_cases(torch, vi, e_vol).items():
        a = (img, seeds, mask, levels)
        want = volume.watershed3d_flood_plain(*a)
        plan = volume.watershed3d_plan(levels)
        got = volume.watershed3d_flood(*a)
        runs = {"wrapper": lambda: got, "global": volume.watershed3d_flood_launcher(*a, plan=glob)}
        for who, run in runs.items():
            err = max(err, compare(f"watershed3d_flood[{name},{who}]", run(), want))
        seeded = seeds > 0
        if not torch.equal(got[seeded], seeds[seeded]):
            raise SmokeFailure(f"watershed3d_flood[{name}]: a seed lost its label")
        if bool((got[~(mask | seeded)] != 0).any()):
            raise SmokeFailure(f"watershed3d_flood[{name}]: label outside mask | seeds")
        if name == "tie" and int(got[0, DEPTH_V // 2, SIZE_V // 2, SIZE_V // 2]) != 2:
            raise SmokeFailure("watershed3d_flood: the tie did not go to the larger label")
        if (levels > volume.W3_MAX_LEVELS) != (plan.route == "global"):
            raise SmokeFailure(f"watershed3d_flood[{name}]: route {plan.route}")
        print(f"  watershed3d_flood[{name}]: {tuple(img.shape)}, {levels} levels: wrapper "
              f"route {plan.route}; exact on " + ", ".join(runs))
    records.append(dict(
        name="watershed3d_flood",
        source="tmlibrary_tpu_torch/csrc/watershed3d_flood.cu",
        replaces="tmlibrary_tpu/ops/pallas_kernels.py:506",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: volume.watershed3d_flood(*args), 10),
        launch_ms=cuda_ms(torch, volume.watershed3d_flood_launcher(*args), 10),
        plain_ms=cuda_ms(torch, lambda: volume.watershed3d_flood_plain(*args), 2, 1),
        bytes=vox * (4 + 4 + 1 + 4), ops=vox * 26, library_ms=None,
    ))

    # grouped_stats on the volume path's call: 3-D boxes, and 2-D boxes
    # over the (B, Z*H, W) view
    lab, chans = volume.volume_stat_channels(vi["cells"], vol)
    want = fm.grouped_stats_plain(lab, chans, MAX_OBJECTS)
    flat = (B_V, DEPTH_V * SIZE_V, SIZE_V)
    g_err = 0.0
    for who, (lab_, chans_) in (("3-D", (lab, chans)),
                                ("2-D", (lab.reshape(flat), [c.reshape(flat) for c in chans]))):
        g_err = max(g_err, compare_grouped_stats(
            torch, f"grouped_stats[volume,{who}]",
            fm.grouped_stats(lab_, chans_, MAX_OBJECTS), want, compare))
    print(f"  grouped_stats[volume]: {tuple(lab.shape)}, 6 channels: "
          "exact with 3-D and 2-D boxes")
    return records, g_err


def distance_cases(torch, shootout, filled) -> dict:
    """Row 7's inputs, name -> masks: path D's filled masks, the edge
    sites, the A/B's all-foreground, centre-pixel, 45% noise and empty
    sites, a ragged 257x130 batch, 1x4096 and 4096x1 sites (16 chunks of
    the column pass; at max_distance 300 a band of 16-bit rows of g past
    48 KB of shared memory), a 483x483 site (past a byte plane in one
    block) and a 1024x1024 one."""
    dev = filled.device
    g = torch.Generator().manual_seed(SEED + 4)
    ragged = (torch.rand((3, 257, 130), generator=g) < 0.9).to(dev)
    ragged[0, :40, :3] = False
    wide = torch.ones((2, 1, 4096), dtype=torch.bool, device=dev)
    wide[0, 0, [7, 2000, 2001]] = False
    tall = torch.ones((2, 4096, 1), dtype=torch.bool, device=dev)
    tall[0, [0, 3000], 0] = False
    out = {"main": filled, "edge": edge_sites(torch, dev)}
    out.update({k: m for k, (m, _) in shootout.distance_cases(filled).items() if k != "real"})
    out.update({"257x130": ragged, "1x4096": wide, "4096x1": tall,
                "483": filled[:2].repeat(1, 2, 2)[:, :483, :483].contiguous(),
                "1024": filled[:1].repeat(1, 4, 4)})
    return out


def distance_record(torch, kernels, shootout, sp, filled, compare) -> dict:
    """Row 7: the two-pass kernel (the wrapper) exact against the plain
    version on every input of :func:`distance_cases` at max_distance 0,
    2, 64, 254 and 300 -- with the first design, kept for the A/B, where it
    takes the site and the cap -- on 1x70000 and
    70000x1 sites at 100,000 (32-bit g, rows read from L2), on noise ten
    launches in a row, and inside ``segment_primary(declump=True)`` on
    512x512 sites against the CPU."""
    err = 0.0
    for name, m in distance_cases(torch, shootout, filled).items():
        original = []
        for cap in (0, 2, 64, 254, 300):
            want = kernels.distance_transform_plain(m, cap)
            err = max(err, compare(f"distance_transform[{name},{cap}]",
                                   kernels.distance_transform(m, cap), want))
            if shootout.distance_original_takes(m.shape, cap):
                err = max(err, compare(f"distance_transform[{name},{cap},original]",
                                       shootout.distance_original(m, cap)(), want))
                original.append(cap)
        print(f"  distance_transform[{name}]: {tuple(m.shape)}, max_distance 0, 2, 64, 254, 300: "
              f"exact; the first design exact at {original or 'none (it does not take them)'}")
    for name, shape in (("1x70000", (1, 1, 70000)), ("70000x1", (1, 70000, 1))):
        m = torch.ones(shape, dtype=torch.bool, device=filled.device).reshape(-1)
        m[::997] = False
        m = m.reshape(shape)
        if kernels.distance_reach(shape, 100000).dtype != torch.int32:
            raise SmokeFailure(f"distance_transform[{name}]: expected a 32-bit g")
        err = max(err, compare(f"distance_transform[{name},100000]",
                               kernels.distance_transform(m, 100000),
                               kernels.distance_transform_plain(m, 100000)))
        print(f"  distance_transform[{name}]: max_distance 100000, 32-bit g: exact")
    noise = shootout.distance_cases(filled)["noise"][0]
    err = max(err, repeat_hold(torch, "distance_transform[noise,64]", compare,
                               lambda: kernels.distance_transform(noise, 64),
                               kernels.distance_transform_plain(noise, 64)))
    px = B * SIZE * SIZE
    record = dict(
        name="distance_transform",
        source="tmlibrary_tpu_torch/csrc/distance_transform.cu",
        replaces="tmlibrary_tpu/ops/pallas_kernels.py:581",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: kernels.distance_transform(filled), 20),
        launch_ms=cuda_ms(torch, kernels.distance_transform_launcher(filled), 20),
        plain_ms=cuda_ms(torch, lambda: kernels.distance_transform_plain(filled), 3, 1),
        bytes=px * (1 + 4), ops=px * 8, library_ms=None,
    )
    # after the timings: the wrapper is host-bound, and this hold's CPU run
    # can leave the host's cores busy (on one H100 at 700 W a reading
    # right after it gave 0.4251 ms against 0.0352 in the A/B of the call)
    declump_512(torch, sp, kernels)
    return record


def cc3d_cases(torch, vmask, e_vol) -> dict:
    """Inputs of the 3-D labeling's holds: the volume path's masks, the
    edge volumes, one 64x256x256 volume (16 MB of labels, larger than a
    cluster of the 3-D flood holds) tiled from the path's masks, two
    ragged 17x100x37 volumes of 30% noise and one plane of each path
    volume."""
    big = torch.cat(list(vmask[:4]), dim=0).repeat(1, 2, 2)[None].contiguous()
    g = torch.Generator().manual_seed(SEED + 3)
    ragged = (torch.rand((2, 17, 100, 37), generator=g) < 0.3).to(vmask.device)
    return {"main": vmask, "edge": e_vol, "64x256x256": big, "17x100x37": ragged,
            "z1": vmask[:, 7:8].contiguous()}


def cc3d_record(torch, volume, shootout, vmask, e_vol, compare) -> dict:
    """Row 8: the union-find kernel (the wrapper) and the first design kept
    for the A/B harness, each exact against the plain version at
    connectivity 26, 18 and 6 on every input of :func:`cc3d_cases`."""
    err = 0.0
    for name, m in cc3d_cases(torch, vmask, e_vol).items():
        for conn in (26, 18, 6):
            want = volume.cc3d_min_propagate_plain(m, conn)
            err = max(err, compare(f"cc3d_min_propagate[{name},{conn}]",
                                   volume.cc3d_min_propagate(m, conn), want))
            original = shootout.cc_original(m, conn)
            err = max(err, compare(f"cc3d_min_propagate[{name},{conn},original]", original(),
                                   want))
        print(f"  cc3d_min_propagate[{name}]: {tuple(m.shape)}, connectivity 26, 18 and 6: "
              f"exact on the kernel and the first design (its sweeps per volume up to "
              f"{int(original.sweeps.max())})")
    noise = shootout.cc_cases(vmask)["noise"]
    for conn in (26, 6):
        err = max(err, repeat_hold(torch, f"cc3d_min_propagate[noise,{conn}]", compare,
                                   lambda: volume.cc3d_min_propagate(noise, conn),
                                   volume.cc3d_min_propagate_plain(noise, conn)))
    vox = vmask.numel()
    return dict(
        name="cc3d_min_propagate",
        source="tmlibrary_tpu_torch/csrc/cc3d_min_propagate.cu",
        replaces="tmlibrary_tpu/ops/pallas_kernels.py:424",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: volume.cc3d_min_propagate(vmask), 20),
        launch_ms=cuda_ms(torch, volume.cc3d_min_propagate_launcher(vmask), 20),
        plain_ms=cuda_ms(torch, lambda: volume.cc3d_min_propagate_plain(vmask), 2, 1),
        bytes=vox * (1 + 4), ops=vox * 26, library_ms=None,
    )


def flood3d_cases(torch, vi, e_vol) -> dict:
    """Inputs of the 3-D flood's holds, name -> (intensity, seeds, mask,
    n_levels): the volume path's, a tied plateau, empty and single-voxel
    masks, seed ids beyond 16 bits, at 2**31 - 1 and negative, NaN
    intensities (in the mask, outside it, at a seed, everywhere), 1, 254
    (the most on the cluster route) and 255 levels, a 5x37x41 crop and
    one plane."""
    vol, nuclei, cmask = vi["vol"], vi["nuclei"], vi["cmask"]
    t_img, t_seeds, t_mask = tied_plateau(torch, vol.device)
    zeros = torch.zeros_like(e_vol[:1], dtype=torch.int32)
    ids = nuclei[:4].clone()
    ids[0][ids[0] == 1] = 70000
    ids[1][ids[1] == 2] = 2**31 - 1
    ids[2, 3, 10:20, 10:20] = -5
    ids[3][ids[3] == 1] = -1
    nan = vol[:4].clone()
    z, y, x = (cmask[0] & (nuclei[0] == 0)).nonzero()[7].tolist()
    nan[0, z, y, x] = float("nan")
    nan[1][~(cmask[1] | (nuclei[1] > 0))] = float("nan")
    nan[2][nuclei[2] == 1] = float("nan")
    nan[3][cmask[3]] = float("nan")
    crop = tuple(t[:4, 3:8, 5:42, 7:48].contiguous() for t in (vol, nuclei, cmask))
    one = tuple(t[:4, 7:8].contiguous() for t in (vol, nuclei, cmask))
    n = N_LEVELS_V
    return {
        "main": (vol, nuclei, cmask, n),
        "tie": (t_img, t_seeds, t_mask, n),
        "empty": (t_img, zeros, e_vol[:1], n),
        "single": (t_img, zeros, e_vol[2:3], n),
        "ids": (vol[:4], ids, cmask[:4], n),
        "nan": (nan, nuclei[:4], cmask[:4], n),
        "levels1": (vol[:4], nuclei[:4], cmask[:4], 1),
        "levels254": (vol[:2], nuclei[:2], cmask[:2], 254),
        "levels255": (vol[:2], nuclei[:2], cmask[:2], 255),
        "crop": (*crop, n),
        "z1": (*one, n),
    }


def declump_512(torch, sp, kernels) -> None:
    """``segment_primary(declump=True)`` on four 512x512 sites on the card
    (the watershed takes ``global``) against the same call on the CPU:
    labels and counts equal, and the distance kernel launched."""
    from tmlibrary_tpu_torch import benchmarks

    dapi = torch.from_numpy(benchmarks.synthetic_cell_painting_batch(
        4, size=512, seed=SEED)["DAPI"])
    before = kernels.distance_transform.launches
    card = sp.segment_primary(dapi.to("cuda"), declump=True, max_objects=MAX_OBJECTS)
    cpu = sp.segment_primary(dapi, declump=True, max_objects=MAX_OBJECTS)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu)):
        raise SmokeFailure("segment_primary(declump=True) at 512x512: card differs from CPU")
    if kernels.distance_transform.launches <= before:
        raise SmokeFailure("segment_primary(declump=True) at 512x512: distance not launched")
    print(f"  segment_primary(declump=True): 4 sites of 512x512, labels and counts equal the "
          f"CPU's ({cpu[1].tolist()} objects)")


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
    """Sums, mins and maxs all exact (the kernel adds each object's pixels
    in the plain version's order); the largest error."""
    err = 0.0
    for part, g_, w_ in zip(("sums", "mins", "maxs"), got, want):
        err = max(err, compare(f"{name}.{part}", g_, w_))
    return err


def grouped_stats_edges(torch, fm, nuclei, dapi, compare) -> float:
    """``grouped_stats`` against its plain version on NaN pixels (in one
    object, in the background, in every object of a site), on more than
    3072 objects at ``max_objects=4096`` and with ids above the capacity,
    each with the planner's bands and with 3 bands a site."""
    dev = dapi.device
    img = dapi[:4].clone()
    lab = nuclei[:4]
    img[0][lab[0] == 1] = float("nan")
    img[1][lab[1] == 0] = float("nan")
    for k in range(1, int(lab[2].amax()) + 1):
        where = (lab[2] == k).nonzero()
        if len(where):
            img[2, where[-1, 0], where[-1, 1]] = float("nan")
    cases = {"nan": (lab, [img, img * img], MAX_OBJECTS)}
    grid = torch.arange(SIZE * SIZE, device=dev).reshape(SIZE, SIZE)
    many = (grid // 4 % 64 + (grid // (4 * SIZE)) * 64 + 1).to(torch.int32)  # 4x4 tiles
    many = torch.stack([many, torch.where(many > 4000, 0, many), many.flip(1)])
    cases["4096"] = (many, [dapi[:3], dapi[:3] * dapi[:3]], 4096)
    over = nuclei[:4].clone()
    over[over == 1] = MAX_OBJECTS + 1
    cases["ids"] = (over, [dapi[:4]], MAX_OBJECTS)
    err = 0.0
    for name, (lab_, chans, m) in cases.items():
        want = fm.grouped_stats_plain(lab_, chans, m)
        plans = {"wrapper": None, "bands3": fm.StatsPlan(3)}
        for who, plan in plans.items():
            got = fm.grouped_stats_launcher(lab_, chans, m, plan=plan)()
            err = max(err, compare_grouped_stats(torch, f"grouped_stats[{name},{who}]", got,
                                                 want, compare))
        print(f"  grouped_stats[{name}]: {tuple(lab_.shape)}, {len(chans)} channels, "
              f"max_objects {m} (largest id {int(lab_.amax())}): exact on wrapper, bands3")
    if int(many[0].amax()) <= 3072:
        raise SmokeFailure("grouped_stats[4096]: the site must hold more than 3072 objects")
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
            _cuda, fused_measure, kernels, label, measure, segment_primary, smooth,
            threshold, volume,
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
        data, dapi, actin, filled, nuclei, actin_mask, dapi_mask = (inputs[k] for k in (
            "data", "dapi", "actin", "filled", "nuclei", "actin_mask", "dapi_mask"))
        vi = shootout.volume_inputs(dev, B_V, SIZE_V, DEPTH_V, MAX_OBJECTS, SEED, N_LEVELS_V)
        data_v = vi["data"]
        print(f"phase 2: kernels vs plain versions at B={B}, {SIZE}x{SIZE} and B={B_V}, "
              f"{DEPTH_V}x{SIZE_V}x{SIZE_V}, max_objects={MAX_OBJECTS} "
              f"({bw / 1e12:.2f} TB/s for the bound); times on {card}")
        records = phase_kernels(
            torch, {"kernels": kernels, "fused_measure": fused_measure, "measure": measure,
                    "shootout": shootout}, inputs)
        more, gs_err = phase_kernels_declump_volume(
            torch, {"kernels": kernels, "volume": volume, "fused_measure": fused_measure,
                    "segment_primary": segment_primary, "shootout": shootout}, filled, vi,
            make_compare(torch))
        records += more
        gs = next(r for r in records if r["name"] == "grouped_stats")
        gs["max_abs_err"] = max(gs["max_abs_err"], gs_err)
        finish_records(records, bw)

        # ---------------------------------------------------------- shootout
        print(f"shootout: interleaved best-of-7 A/B on the main path's inputs; times on {card}")
        ab = shootout.run(inputs, MAX_OBJECTS, bytes_per_s=bw, vol_inputs=vi)
        # row 10, scripts/cc_kernel_shootout.py: row 2's function in the A/B
        # harness, timed there on the Otsu masks
        row10 = dict(name="cc_kernel_shootout", wrapper="cc_min_propagate",
                     source="tmlibrary_tpu_torch/csrc/cc_min_propagate.cu",
                     replaces="scripts/cc_kernel_shootout.py:41",
                     max_abs_err=next(r for r in records
                                      if r["name"] == "cc_min_propagate")["max_abs_err"],
                     ms=ab["cc"]["ms"]["kernel"], plain_ms=ab["cc"]["ms"]["plain"],
                     bytes=shootout.cc_bytes(dapi_mask), ops=dapi_mask.numel() * 8,
                     library_ms=None)
        finish_records([row10], bw)
        records.append(row10)
        # row 7's A/B in the same call: the two-pass launch and the first
        # design on path D's masks
        row7 = next(r for r in records if r["name"] == "distance_transform")
        row7["ab_ms"] = {k: ab["distance"]["ms"][k] for k in ("kernel", "original")}

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
        # every launch of these on one route, and every watershed site on chip
        on_chip = {"fill_holes_flood": "onchip", "watershed_flood": "onchip"}
        # (a) config 3
        desc3 = benchmarks.cell_painting_description()
        run3 = drive_path(torch, pipeline, "config 3", desc3, data, wrappers, need=segment,
                          card=card, expect={"fill_holes_flood": 1, "watershed_flood": 1,
                                             "cc_min_propagate": 1},
                          only=on_chip)
        kernel_ms = sum(r["ms"] * run3["launches"][r["name"]] for r in records
                        if r["name"] in run3["launches"])
        print(f"  the kernels: {kernel_ms:.2f} ms of a batch at their phase-2 times ({card})")
        print_stages(card, stage_breakdown(
            torch, pkg_ops={"smooth": smooth, "threshold": threshold, "label": label,
                            "kernels": kernels},
            dapi=dapi, actin=actin, nuclei=nuclei, actin_mask=actin_mask))
        split = labeling_split(torch, kernels.cc_min_propagate_launcher, label.compact_roots,
                               filled)
        print("  connected_components split (ms per batch): " + ", ".join(
            f"{k} {v:.3f}" for k, v in split.items()) + f" on {card}")

        # (b) config 4, the full feature stack
        data4 = benchmarks.synthetic_full_stack_batch(B, size=SIZE, seed=SEED)
        desc4 = benchmarks.full_feature_description()
        run4 = drive_path(torch, pipeline, "config 4", desc4, data4, wrappers,
                          need=segment + ["glcm_all"], card=card,
                          expect={"cc_min_propagate": 1}, only=on_chip)
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
                           need=segment + ["intensity_hist"], card=card,
                           expect={"cc_min_propagate": 1}, only=on_chip)
        if run_q["launches"]["intensity_hist"] != 2:
            raise SmokeFailure("intensity_hist: expected 2 launches per batch, got "
                               f"{run_q['launches']['intensity_hist']}")

        # (d) config 3 with declumping, on config 3's batch
        run_d = drive_path(
            torch, pipeline, "declump", benchmarks.cell_painting_declump_description(), data,
            wrappers, need=[], card=card, expect={
                "fill_holes_flood": 1, "cc_min_propagate": 1, "distance_transform": 1,
                "watershed_flood": 2, "grouped_stats": 2},
            only=on_chip)
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
                               "grouped_stats": 1},
            only={"watershed3d_flood": "cluster"})
        print_stages(card, stage_breakdown_volume(torch, data_v, get_module))
        split = labeling_split(torch, volume.cc3d_min_propagate_launcher, label.compact_roots,
                               vi["vmask"])
        print("  connected_components_3d split (ms per batch): " + ", ".join(
            f"{k} {v:.3f}" for k, v in split.items()) + f" on {card}")
        split = measure_volume_split(torch, data_v, get_module)
        print("  measure_volume split (ms per batch): " + ", ".join(
            f"{k} {v:.3f}" for k, v in split.items()) + f" on {card}")

        # each kernel's launches: the path that brought it to the port
        path_of = {"intensity_hist": run_q, "glcm_all": run4, "distance_transform": run_d,
                   "cc3d_min_propagate": run_v, "watershed3d_flood": run_v}
        for r in records:
            wrapper = r.pop("wrapper", r["name"])
            r["launches"] = path_of.get(wrapper, run3)["launches"][wrapper]
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
    # rows 1-9 add the launch alone beside the wrapper's `ms`, row 7 its A/B
    print(json.dumps({"kernels": [{k: r[k] for k in order + ["launch_ms", "ab_ms"] if k in r}
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
               expect=None, only=None) -> dict:
    """Drive one path through ``build_batch_fn`` on the card: a warm-up
    call, then every launch counter set to 0, one call, the counters read
    (each kernel in ``need`` must have launched, each in ``expect``
    exactly that often, each kernel in ``only`` every time on the route
    named there, the watershed with every site of its last launch on chip),
    the first sites held to the port's CPU run, and the batch timed over 5
    calls."""
    n = next(iter(data.values())).shape[0]
    raw, stats, shifts = pipeline.from_jax_inputs(data, {}, [[0, 0]] * n, device="cuda")
    fn = pipeline.ImageAnalysisPipeline(desc, MAX_OBJECTS, device="cuda").build_batch_fn()
    fn(raw, stats, shifts)  # warm-up: allocator and first launches
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
        if hasattr(w, "routes"):
            w.routes = dict.fromkeys(w.routes, 0)
    t0 = time.perf_counter()
    result = fn(raw, stats, shifts)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    routes = {k: {r: c for r, c in w.routes.items() if c}
              for k, w in wrappers.items() if hasattr(w, "routes") and w.launches}
    print(f"phase 3, {title}: launches {launches}; routes {routes}")
    for k in need:
        if launches[k] < 1:
            raise SmokeFailure(f"{title}: {k} was not launched on this path")
    for k, count in (expect or {}).items():
        if launches[k] != count:
            raise SmokeFailure(f"{title}: {k} launched {launches[k]} times, expected {count}")
    for k, route in (only or {}).items():
        taken = {r: c for r, c in wrappers[k].routes.items() if c}
        if launches[k] < 1 or taken != {route: launches[k]}:
            raise SmokeFailure(f"{title}: {k} routes {wrappers[k].routes}, expected all "
                               f"{launches[k]} launches on {route}")
        site = getattr(wrappers[k], "site_routes", None)
        if k == "watershed_flood" and (site is None or bool((site != 0).any())):
            raise SmokeFailure(f"{title}: watershed_flood sites off chip: {site}")

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


def labeling_split(torch, launcher, compact_roots, masks) -> dict:
    """Where a labeling stage goes, CUDA events on the path's masks: the
    union-find kernel's launch and the compaction to scipy order
    (``compact_roots``, plain ops)."""
    launch = launcher(masks)
    roots = launch()
    return {"kernel": cuda_ms(torch, launch, 10),
            "compact_roots": cuda_ms(torch, lambda: compact_roots(masks, roots), 10)}


def measure_volume_split(torch, data, get_module) -> dict:
    """Where ``measure_volume`` goes, CUDA events at the batch's shapes:
    the module, building its six channels, its ``grouped_stats`` call (the
    wrapper) and the kernel's launch alone."""
    from tmlibrary_tpu_torch.ops import fused_measure as fm
    from tmlibrary_tpu_torch.ops.volume import volume_stat_channels

    zstack = torch.from_numpy(data["DAPI"]).to("cuda")
    vol = get_module("generate_volume_image")(zstack, mode="focus")["volume_image"]
    nuc = get_module("segment_volume")(vol, max_objects=MAX_OBJECTS)["objects"]
    lab, chans = volume_stat_channels(nuc, vol)
    steps = {
        "measure_volume": lambda: get_module("measure_volume")(nuc, vol, max_objects=MAX_OBJECTS),
        "channel_views": lambda: volume_stat_channels(nuc, vol),
        "grouped_stats_wrapper": lambda: fm.grouped_stats(lab, chans, MAX_OBJECTS),
        "grouped_stats_launch": fm.grouped_stats_launcher(lab, chans, MAX_OBJECTS),
    }
    return {name: cuda_ms(torch, fn, 5, 1) for name, fn in steps.items()}


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
