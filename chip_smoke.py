#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (``tmlibrary_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):

1. Print the card's name and power limit (``nvidia-smi``); build the
   kernels from ``tmlibrary_tpu_torch/csrc`` with ``nvcc`` and print the
   build seconds.
2. At the main path's shapes (64 sites of 256x256, ``max_objects=256``,
   synthetic Cell Painting data, plus edge-case sites), hold each kernel
   against its plain PyTorch version on the card — exact for labels,
   masks, counts, min and max, ``rtol=1e-6`` for fractional sums — and
   time both with CUDA events after warm-up.  ``grouped_stats`` is also
   timed against one ``index_add_``/``scatter_reduce`` pass computing
   the same sums, min and max (a yardstick the port never calls).
3. Drive the Cell Painting pipeline (``build_batch_fn``) on the card with
   every launch counter set to 0, check that every kernel launched,
   compare labels and counts exactly (features within tier) with the
   port on ``device="cpu"`` for the first 8 sites, and time sites/sec.
4. Print ``kernels: ...``, the per-kernel JSON record, and as the last
   line ``{"ok": true, "device": {...}}``.

The script imports nothing of JAX or of ``tmlibrary_tpu``.
"""

from __future__ import annotations

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


def phase_kernels(torch, pkg, inputs, bw):
    """Phase 2: every kernel against its plain version on the card."""
    kernels, fm = pkg["kernels"], pkg["fused_measure"]
    dapi_mask, filled, nuclei, actin, actin_mask, dapi = inputs
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
    chans = [torch.ones_like(dapi), dapi, dapi * dapi]
    got = fm.grouped_stats(nuclei, chans, MAX_OBJECTS)
    want = fm.grouped_stats_plain(nuclei, chans, MAX_OBJECTS)
    err = 0.0
    for part, g_, w_ in zip(("sums", "mins", "maxs"), got, want):
        exact = part != "sums"
        err = max(err, compare(f"grouped_stats.{part}", g_, w_, exact=exact))
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
        from tmlibrary_tpu_torch.ops import (
            _cuda, fused_measure, kernels, label, smooth, threshold,
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
        print(f"phase 2: kernels vs plain versions at B={B}, {SIZE}x{SIZE}, "
              f"max_objects={MAX_OBJECTS} ({bw / 1e12:.2f} TB/s for the bound)")
        records = phase_kernels(
            torch, {"kernels": kernels, "fused_measure": fused_measure},
            (dapi_mask, filled, nuclei, actin, actin_mask, dapi), bw)

        # ---------------------------------------------------------- phase 3
        desc = benchmarks.cell_painting_description()
        raw, stats, shifts = pipeline.from_jax_inputs(
            data, {}, [[0, 0]] * B, device="cuda")
        fn = pipeline.ImageAnalysisPipeline(desc, MAX_OBJECTS, device="cuda").build_batch_fn()
        fn(raw, stats, shifts)  # warm-up: allocator and first launches
        torch.cuda.synchronize()
        wrappers = {
            "fill_holes_flood": kernels.fill_holes_flood,
            "cc_min_propagate": kernels.cc_min_propagate,
            "watershed_flood": kernels.watershed_flood,
            "grouped_stats": fused_measure.grouped_stats,
        }
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        result = fn(raw, stats, shifts)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        print(f"phase 3: main path launches {launches}")
        for r in records:
            r["launches"] = launches[r["name"]]
            if r["launches"] < 1:
                raise SmokeFailure(f"{r['name']} was not launched on the main path")

        card_res = pipeline.site_result_to_numpy(result)
        sub = {k: v[:N_CPU_SITES] for k, v in data.items()}
        craw, cstats, cshifts = pipeline.from_jax_inputs(
            sub, {}, [[0, 0]] * N_CPU_SITES, device="cpu")
        cpu_res = pipeline.site_result_to_numpy(
            pipeline.ImageAnalysisPipeline(desc, MAX_OBJECTS, device="cpu")
            .build_batch_fn()(craw, cstats, cshifts))
        compare_with_cpu(card_res, cpu_res)

        reps = 5
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(raw, stats, shifts)
        torch.cuda.synchronize()
        batch_s = (time.perf_counter() - t0) / reps
        kernel_ms = sum(r["ms"] * r["launches"] for r in records)
        print(f"pipeline: {B / batch_s:.1f} sites/s ({batch_s * 1e3:.2f} ms per batch "
              f"of {B}; main-path run {main_s * 1e3:.2f} ms; the four kernels "
              f"{kernel_ms:.2f} ms of it at their phase-2 times)")
        print(f"counts: nuclei {card_res.counts['nuclei'][:N_CPU_SITES].tolist()} "
              f"cells {card_res.counts['cells'][:N_CPU_SITES].tolist()}")
        stages = stage_breakdown(
            torch, pkg_ops={"smooth": smooth, "threshold": threshold, "label": label,
                            "kernels": kernels},
            dapi=dapi, actin=actin, nuclei=nuclei, actin_mask=actin_mask)
        print("stages (ms per batch): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
              + f"; sum {sum(stages.values()):.3f}")
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


def compare_with_cpu(card, cpu) -> None:
    """Labels and counts exact; features within the reference's tiers
    (sums rtol 1e-6, std rtol 1e-3 atol 1e-4, the rest exact) on the
    defined rows of the first sites."""
    import numpy as np

    n = N_CPU_SITES
    for obj in cpu.objects:
        if not np.array_equal(card.objects[obj][:n], cpu.objects[obj]):
            raise SmokeFailure(f"{obj}: card labels differ from the CPU run")
        if not np.array_equal(card.counts[obj][:n], cpu.counts[obj]):
            raise SmokeFailure(f"{obj}: card counts differ from the CPU run")
    for obj, feats in cpu.measurements.items():
        counts = cpu.counts[obj]
        for feat, want in feats.items():
            got = card.measurements[obj][feat][:n]
            if got.shape != want.shape:
                raise SmokeFailure(f"{feat}: shape {got.shape} != {want.shape}")
            for s in range(n):
                g, w = got[s, : counts[s]], want[s, : counts[s]]
                if not np.isfinite(g).all():
                    raise SmokeFailure(f"{obj}/{feat}: non-finite values")
                if "std" in feat:
                    np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-4)
                elif "sum" in feat or "mean" in feat:
                    np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
                else:
                    np.testing.assert_array_equal(g, w)
    print(f"cpu check: labels, counts and features of {n} sites agree")


if __name__ == "__main__":
    sys.exit(main())
