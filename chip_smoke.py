#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (``tmlibrary_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):

1. Print the card's name and power limit (``nvidia-smi``); build the
   kernels from ``tmlibrary_tpu_torch/csrc`` with ``nvcc`` and print the
   build seconds.
2. At the main paths' shapes (64 sites of 256x256, ``max_objects=256``,
   synthetic Cell Painting data, plus edge-case sites), hold each of the
   six kernels against its plain PyTorch version on the card — exact for
   labels, masks, counts, min and max, ``rtol=1e-6`` for fractional sums;
   ``grouped_stats`` also on every channel list that morphology and
   Zernike hand it (1, 3, 7 and 32 channels) — and time the kernel, the plain version and, where one PyTorch call
   computes the same function, that call (a yardstick the port never
   calls) with CUDA events after warm-up.
3. Drive three paths through ``build_batch_fn`` on the card, each with
   every launch counter set to 0 just before it and read just after:
   (a) the Cell Painting pipeline (BASELINE config 3), (b) the full
   feature stack (config 4: five channels, intensity, morphology,
   Haralick texture, Zernike moments) and (c) config 3 with
   ``measure_intensity(quantiles=True)``.  Each path must launch its
   kernels; labels and counts of the first 8 sites equal the port's run
   on ``device="cpu"`` and every feature lies within its tier of
   ``CARD_TIERS``.  Print sites/sec and a stage breakdown.
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

#: HBM bandwidth by card (NVIDIA data sheets); the SXM part is the default
HBM_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H100", 3.35e12))
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
    # sqrt of a difference of sums: cancellation (tests/test_parity_fuzz.py)
    "Intensity_std": (1e-3, 1e-4),
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


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S:
        if key in name:
            return rate
    return HBM_BYTES_PER_S[-1][1]


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


def phase_kernels(torch, pkg, inputs, bw):
    """Phase 2: every kernel against its plain version on the card."""
    kernels, fm, measure = pkg["kernels"], pkg["fused_measure"], pkg["measure"]
    dapi_mask, filled, nuclei, actin, actin_mask, dapi, cells = inputs
    edges = edge_sites(torch, dapi.device)
    px = B * SIZE * SIZE
    records = []

    def compare(name, got, want, exact=True):
        if exact:
            if not torch.equal(got, want):
                raise SmokeFailure(f"{name}: kernel differs from its plain version")
        else:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        return max_abs_err(torch, got, want)

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

    # intensity_hist: DAPI in the nuclei at 256 buckets (the quantile
    # path), plus edge sites; bounds from grouped_stats as on that path
    site = torch.arange(B, device=dapi.device)[:, None]
    e_lab, e_img = feature_edge_sites(torch, dapi.device)
    e_bounds = measure.grouped_minmax(e_lab, e_img, MAX_OBJECTS)
    h_args = (nuclei, dapi, MAX_OBJECTS, BINS, measure.grouped_minmax(nuclei, dapi, MAX_OBJECTS))
    err = compare("intensity_hist", fm.intensity_hist(*h_args), fm.intensity_hist_plain(*h_args))
    err = max(err, compare("intensity_hist[edge]",
                           fm.intensity_hist(e_lab, e_img, MAX_OBJECTS, BINS, e_bounds),
                           fm.intensity_hist_plain(e_lab, e_img, MAX_OBJECTS, BINS, e_bounds)))
    lo_full, span_full = fm.masked_bounds(*h_args[4])
    lab = nuclei.reshape(B, -1).long()
    q = fm.quantize(nuclei, dapi, lo_full, span_full, BINS).reshape(B, -1)
    keep = (lab >= 1) & (lab <= MAX_OBJECTS)
    h_idx = ((site * MAX_OBJECTS + lab - 1) * BINS + q)[keep]
    records.append(dict(
        name="intensity_hist",
        source="tmlibrary_tpu_torch/csrc/intensity_hist.cu",
        replaces="tmlibrary_tpu/ops/fused_measure.py:276",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: fm.intensity_hist(*h_args), 20),
        plain_ms=cuda_ms(torch, lambda: fm.intensity_hist_plain(*h_args), 5, 1),
        bytes=px * (4 + 4) + 2 * B * (MAX_OBJECTS + 1) * 4 + B * MAX_OBJECTS * BINS * 4,
        ops=px * 6,
        # yardstick: counting already-quantised pixels (quantisation left out)
        library_ms=cuda_ms(torch, lambda: torch.bincount(
            h_idx, minlength=B * MAX_OBJECTS * BINS), 20),
    ))

    # glcm_all: Actin in the cells at 16 levels, 4 directions (config 4's
    # texture), plus edge sites
    g_args = (cells, actin, MAX_OBJECTS, LEVELS, OFFSETS,
              measure.grouped_minmax(cells, actin, MAX_OBJECTS))
    got, want = fm.glcm_all(*g_args), fm.glcm_all_plain(*g_args)
    err = max(compare(f"glcm_all[{d}]", g_, w_) for d, (g_, w_) in enumerate(zip(got, want)))
    e_args = (e_lab, e_img, MAX_OBJECTS, LEVELS, OFFSETS, e_bounds)
    for d, (g_, w_) in enumerate(zip(fm.glcm_all(*e_args), fm.glcm_all_plain(*e_args))):
        err = max(err, compare(f"glcm_all[edge,{d}]", g_, w_))
    lo_full, span_full = fm.masked_bounds(*g_args[5])
    lab = cells.reshape(B, -1).long()
    q1 = fm.quantize(cells, actin, lo_full, span_full, LEVELS).reshape(B, -1)
    pairs = []
    for d, (dy, dx) in enumerate(OFFSETS):
        lab2 = kernels.shift_with_fill(cells, -dy, -dx, 0)
        q2 = fm.quantize(lab2, kernels.shift_with_fill(actin, -dy, -dx, 0.0), lo_full,
                         span_full, LEVELS).reshape(B, -1)
        valid = (lab >= 1) & (lab <= MAX_OBJECTS) & (lab2.reshape(B, -1) == lab)
        row = (site * len(OFFSETS) + d) * MAX_OBJECTS + lab - 1
        pairs.append(((row * LEVELS + q1) * LEVELS + q2)[valid])
    g_idx = torch.cat(pairs)
    records.append(dict(
        name="glcm_all",
        source="tmlibrary_tpu_torch/csrc/glcm_all.cu",
        replaces="tmlibrary_tpu/ops/fused_measure.py:412",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: fm.glcm_all(*g_args), 20),
        plain_ms=cuda_ms(torch, lambda: fm.glcm_all_plain(*g_args), 5, 1),
        bytes=(px * (4 + 4) + 2 * B * (MAX_OBJECTS + 1) * 4
               + len(OFFSETS) * B * MAX_OBJECTS * LEVELS * LEVELS * 4),
        ops=px * 6 * (1 + len(OFFSETS)),
        # yardstick: counting already-formed pairs (quantisation, pairing
        # and symmetrisation left out)
        library_ms=cuda_ms(torch, lambda: torch.bincount(
            g_idx, minlength=len(OFFSETS) * B * MAX_OBJECTS * LEVELS * LEVELS), 20),
    ))
    for r in records:
        r["route"] = "cuda"
        t_bytes = r.pop("bytes") / bw * 1e3
        t_ops = r.pop("ops") / FP32_OPS_PER_S * 1e3
        r["bound_ms"], r["bound_by"] = (
            (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
              f"library {r['library_ms']}), max_abs_err {r['max_abs_err']}")
    return records


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
        from tmlibrary_tpu_torch import benchmarks
        from tmlibrary_tpu_torch.jterator import pipeline
        from tmlibrary_tpu_torch.jterator.description import PipelineDescription
        from tmlibrary_tpu_torch.ops import (
            _cuda, fused_measure, kernels, label, measure, smooth, threshold,
        )
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2

    try:
        # ---------------------------------------------------------- phase 1
        card = card_line()
        print(f"card: {card}")
        name = torch.cuda.get_device_name(0)
        bw = hbm_rate(name)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        _cuda.lib()
        wall, nvcc_s = time.perf_counter() - t0, _cuda.last_build_seconds
        print(f"build: {wall:.2f} s wall (nvcc {nvcc_s:.2f} s) -> {_cuda.build().name}")

        # ---------------------------------------------------------- phase 2
        dev = torch.device("cuda")
        data = benchmarks.synthetic_cell_painting_batch(B, size=SIZE, seed=SEED)
        dapi = torch.from_numpy(data["DAPI"]).to(dev)
        actin = torch.from_numpy(data["Actin"]).to(dev)
        dapi_mask = threshold.threshold_otsu(smooth.gaussian_smooth(dapi, 1.5))
        filled = label.fill_holes(dapi_mask)
        nuclei = label.filter_by_area(
            label.clip_label_count(label.connected_components(filled)[0], MAX_OBJECTS),
            MAX_OBJECTS, min_area=20)
        actin_mask = threshold.threshold_otsu(actin, correction_factor=0.8)
        cells = kernels.watershed_flood(actin, nuclei, actin_mask, n_levels=16)
        print(f"phase 2: kernels vs plain versions at B={B}, {SIZE}x{SIZE}, "
              f"max_objects={MAX_OBJECTS} ({bw / 1e12:.2f} TB/s for the bound)")
        records = phase_kernels(
            torch, {"kernels": kernels, "fused_measure": fused_measure, "measure": measure},
            (dapi_mask, filled, nuclei, actin, actin_mask, dapi, cells), bw)

        # ---------------------------------------------------------- phase 3
        wrappers = {
            "fill_holes_flood": kernels.fill_holes_flood,
            "cc_min_propagate": kernels.cc_min_propagate,
            "watershed_flood": kernels.watershed_flood,
            "grouped_stats": fused_measure.grouped_stats,
            "intensity_hist": fused_measure.intensity_hist,
            "glcm_all": fused_measure.glcm_all,
        }
        segment = ["fill_holes_flood", "cc_min_propagate", "watershed_flood", "grouped_stats"]
        # (a) config 3
        desc3 = benchmarks.cell_painting_description()
        run3 = drive_path(torch, pipeline, "config 3", desc3, data, wrappers, need=segment)
        kernel_ms = sum(r["ms"] * run3["launches"][r["name"]] for r in records)
        print(f"  the kernels: {kernel_ms:.2f} ms of a batch at their phase-2 times")
        stages = stage_breakdown(
            torch, pkg_ops={"smooth": smooth, "threshold": threshold, "label": label,
                            "kernels": kernels},
            dapi=dapi, actin=actin, nuclei=nuclei, actin_mask=actin_mask)
        print("  stages (ms per batch): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
              + f"; sum {sum(stages.values()):.3f}")

        # (b) config 4, the full feature stack
        data4 = benchmarks.synthetic_full_stack_batch(B, size=SIZE, seed=SEED)
        desc4 = benchmarks.full_feature_description()
        run4 = drive_path(torch, pipeline, "config 4", desc4, data4, wrappers,
                          need=segment + ["glcm_all"])
        stages = stage_breakdown_full(torch, data4, run4["objects"])
        print("  stages (ms per batch): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
              + f"; sum {sum(stages.values()):.3f}")

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
                           need=segment + ["intensity_hist"])
        if run_q["launches"]["intensity_hist"] != 2:
            raise SmokeFailure("intensity_hist: expected 2 launches per batch, got "
                               f"{run_q['launches']['intensity_hist']}")
        # each kernel's launches: the path that brought it to the port
        path_of = {"intensity_hist": run_q, "glcm_all": run4}
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
    print(json.dumps({"kernels": [{k: r[k] for k in order} for r in records]}))
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


def drive_path(torch, pipeline, title, desc, data, wrappers, need) -> dict:
    """Drive one path through ``build_batch_fn`` on the card: a warm-up
    call, then every launch counter set to 0, one call, the counters read
    (each kernel in ``need`` must have launched), the first sites held to
    the port's CPU run, and the batch timed over 5 calls."""
    raw, stats, shifts = pipeline.from_jax_inputs(data, {}, [[0, 0]] * B, device="cuda")
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
    print(f"  pipeline: {B / batch_s:.1f} sites/s ({batch_s * 1e3:.2f} ms per batch "
          f"of {B}; main-path run {main_s * 1e3:.2f} ms)")
    print(f"  counts: nuclei {card_res.counts['nuclei'][:N_CPU_SITES].tolist()} "
          f"cells {card_res.counts['cells'][:N_CPU_SITES].tolist()}")
    return {"launches": launches, "objects": result.objects}


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
