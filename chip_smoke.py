#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (``tmlibrary_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):

1. Print the card's name and power limit (``nvidia-smi``); build the
   kernels from ``tmlibrary_tpu_torch/csrc`` with ``nvcc`` and the host
   library (``csrc/host/hull.cpp``, solidity) with the host compiler,
   and print the build seconds.
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
3. Drive nine paths through ``build_batch_fn`` on the card, each with
   every launch counter set to 0 just before it and read just after:
   (a) the Cell Painting pipeline (BASELINE config 3), (b) the full
   feature stack (config 4), (c) config 3 with
   ``measure_intensity(quantiles=True)``, (d) config 3 with declumping,
   (e) config 2 (smooth, adaptive threshold, label), (f) config 5 (the
   3-D z-stack pipeline), (g) the ``dl`` configuration
   (``segment_dl_primary`` with ``seed:0`` weights, threshold 0.6,
   ``min_area`` 4, then ``measure_intensity``; 64 DAPI sites), (h) its
   primary + secondary form (``segment_dl_secondary``, both measured)
   and (i) spot counting (:func:`spots_pipe`, ``spots_b64_256``: config
   3's DAPI and Actin beside :func:`synthetic_fish_batch`'s 8-plane FISH
   stacks; ``mip``, ``clip``, bilateral ``smooth``, ``detect_blobs``,
   median ``smooth``, ``segment_primary``/``_secondary``, ``filter``,
   ``expand_or_shrink``, ``register_objects``, ``measure_point_pattern``
   and ``measure_intensity``).  Path (i) launches exactly rows 1-4 at
   1, 2, 1, 4 (:data:`SPOTS_LAUNCHES`), holds the spot mask's labeling
   and the point-pattern passes against their plain versions at its
   shapes, holds 8 sites to the CPU with the spots by the boundary rule
   (:func:`blob_flips`) and prints each module's stage time.  Then (j)
   the module sweep: every module and method path (i) does not run,
   alone at 64 sites of 256x256 (ms per batch), each held against the
   CPU on 8 sites (exact; Haralick's global quantisation with its GLCM
   counts exact and features by ``CARD_TIERS``).
   Paths g and h launch exactly rows 2 and 4 (and 3, the one-level flood,
   on h), hold those kernels against their plain versions at the path's
   shapes, hold the first 8 sites to the port's CPU run by the boundary
   rule (:func:`dl_flips`: the head within ``HEAD_TIER``, each flipped
   sign or mask pixel within the tier of its boundary; features by
   ``CARD_TIERS`` where labels agree), hold the heads bit-identical at
   batch 64, 8 and 1, and print the host syncs of a batch, the stage
   split and the U-Net's GFLOP/s beside ``unet_flops``/``unet_io_bytes``.  Each path must launch its kernels (paths d-f
   exactly as often as listed in ``main``, paths a-e the 2-D labeling and
   f the 3-D labeling once; the floods on their main routes); labels and
   counts of the
   first 8 sites equal the port's run on ``device="cpu"`` and every
   feature lies within its tier of ``CARD_TIERS``.  Print sites/sec and a
   stage breakdown, each time beside the card's name and power limit;
   for the volume path split ``measure_volume``.
4. The illumination and stitching path, held against the port's CPU
   run: corilla (BASELINE config 1) -- the channel-batched Welford scan
   and finalize over 8 channels x 96 sites of 256x256 (channels/sec, the
   ms and kernel launches of one update step), the corilla step's order
   (chunks of 32, merged) and a nearly flat channel; ``n``, the histogram
   and the percentiles exact, the log-domain fields within
   ``STATS_TIERS``.  Align: 64 pairs of config 3's sites rolled by known
   shifts within +-40 (shifts exact, quality within its tier) and an
   unrelated noise pair the filter must zero (ms per batch).  Illuminati:
   an 8x8 grid of DAPI sites corrected with corilla's statistics,
   stitched, four pyramid levels, uint8 and tiles (every level exact,
   Mpix/s and tiles/s).  QC: config 3 through ``build_batch_fn(qc=True)``
   (statistics within ``QC_TIERS``, outputs bit-identical to QC off).
   The production chain: corilla's statistics of config 3's DAPI and
   Actin, computed on the card, feed config 3 with ``correct: true``,
   launch counters as on path (a), labels and counts exact against the
   CPU pipeline run on the card's corrected images.
5. The store-bound workflow steps, run as a user runs them: one 96-well
   plate at 2x2 sites of 256x256 (384 sites, DAPI and Actin, 2 cycles,
   cycle 1 rolled within +-40) written to an experiment store under
   ``build/``; the ``corilla``, ``align`` and ``jterator`` steps on the
   card (config 3 with both channels corrected and aligned, from a
   ``.pipe.json``; batches of 64 through the pipelined executor; the
   bucket router from a cold start), the jterator step with the launch
   counters set to 0 before and read after (1, 1, 1, 2 per launched
   batch, escalation re-launches included, the floods on chip); step
   sites/s end to end, the executor's phase times, rungs and
   escalations, corilla channels/s and align ms per batch, the host
   syncs inside one launch, and a warm pass over a fresh root.  The CPU
   hold: corilla and align with ``device="cpu"`` (fields by
   ``STATS_TIERS``, ``n``, percentiles, shifts and window exact), then
   two jterator batches on the CPU over the card's statistics and
   shifts, held by site index (labels exact, features by
   ``CARD_TIERS``).  The store is removed at the end.
6. The ``Workflow`` engine through the CLI (``phase_engine``): config 4
   corrected and aligned over phase 5's plate, ``workflow submit
   --device cuda``, resume, status, and the same description on the CPU.
7. The canonical workflow from the microscope's files
   (``phase_canonical``, ``workflow_canonical_p96x4_256``): phase 5's
   plate as 768 TIFF files written by the port's ``ImageWriter``,
   ``create`` and ``workflow submit --device cuda`` of metaconfig ->
   imextract -> corilla -> illuminati -> jterator (config 3, both
   channels corrected), launch counters as in phase 5, ``workflow
   resume``; the ingested pixels exact, metaconfig's artifacts, every
   tile and ``layer.json`` against CPU runs, the static mapobject shards
   read back, the CPU's first jterator batch of 16 sites against the card.
8. The QC session (``phase_qc_session``, ``workflow_engine_qc_p96x4_256``):
   phase 5's plate, ``workflow submit --device cuda --qc`` of corilla ->
   align -> jterator (path h, DAPI corrected and aligned), launch
   counters as on path h per launched batch, and ``--no-qc``, in turns
   off, on, on, off, each on a fresh root: stores bit-identical,
   ``qc.json`` with the ``__model__`` streams
   (64 samples a stream a site), one ``qc_batch`` a batch, batch 0's QC
   summary and labels against the CPU, and the ``qc`` verb's exit code
   against the CPU's profile; engine sites/s with QC on and off.
9. The spatial layout (``phase_spatial``): whole wells segmented as one
   mosaic through the jterator step's ``layout: spatial`` on the card.
   ``spatial_8x8_256`` (the reference bench's ``BENCH_CONFIG=spatial``
   well, a 2048x2048 mosaic) with ``spatial_zernike_degree: 0`` (row 2
   once) and with degree 9 and a secondary family (row 2 once, row 3 once
   on its ``global`` route), each held to the port's CPU run of the step,
   the scipy chain's count and ``ndimage.label`` of the card's mask, rows
   2 and 3 held to their plain versions at the mosaic's shape and timed
   there; ``spatial_4x4_2048`` (an 8192x8192 mosaic) the primary alone,
   held to the scipy chain and ``ndimage.label``.  Mpix/s
   (``jterator_spatial_mosaic_megapixels_per_sec``) and the stage times
   of the step's batch summary, and a ``spatial: {...}`` line.
10. The analytics plane (``phase_analytics``; no kernel of its own: the
   reference leaves it to XLA and the port to PyTorch on the card).  (a)
   The reference bench's populations (``BENCH_CONFIG=analytics``,
   ``analytics_n1e4_f32`` and ``analytics_n1e5_f32``: N x 32 normal
   features, 64 sites, centroids on [0, 2048), seed 0): queries/s of knn
   (k 10), pca (2), embedding (k 15), spatial density (radius 2) and
   k-means (k 5), the mean of 3 warm calls ended by a sync, every repeat
   bit-identical; IVF build and self sweep against brute force with
   recall@10 on the clustered population; held to the port's CPU run:
   knn by ``knn_hold`` (every row at 10^4, 2000 strided rows at 10^5) and
   against a float64 brute force on 256 rows, pca by ``ANALYTICS_RTOL``,
   the embedding by ``EMBEDDING_MIN_COS`` (at 10^5 the CPU's spectral
   stage on the card's graph), spatial tables and density exactly,
   k-means seeds exactly and every Lloyd step of the CPU's trajectory on
   the card half by half (``decision_hold``, ``ANALYTICS_RTOL``), the IVF
   search over the card's cells by ``knn_hold`` and its cells by
   ``decision_hold``.  (b) Phase 6's plate (config 4's nuclei features):
   ``index build``, ``index list`` and ``tmx-torch query`` of knn, pca,
   embedding, spatial, clustering, heatmap and classification (logreg,
   knn) on the card, each a miss, a hit equal to it and a ``--no-cache``
   recompute bit-identical to it; then each with ``--device cpu`` over a
   copy keeping the card's indexes, held as in (a), spatial, heatmap and
   clustering exactly.  An ``analytics: {...}`` line carries the numbers.
11. A reference user's YAML project (``phase_project``,
   ``project_yaml_p96x4_256``; no kernel of its own): config 3 built
   through the ``project`` verbs, ``workflow template`` filled in as the
   store's ``workflow.yaml``, ``workflow submit --device cuda`` over phase
   5's plate with rows 1-4 launched, the store bit-identical to the JSON
   pipe's run, CPU batches held, every ``export``, the OME-NGFF plate
   re-ingested pixel-equal, ``workflow cleanup``; a ``project: {...}``
   line carries the submit's sites/s and step walls, each export's
   seconds and MiB/s, the NGFF write's MiB/s, the re-ingest's files/s and
   the card's name and power limit.
12. Microscope containers (``phase_containers``, ``containers_p96x4_256``;
   no kernel of its own): phase 5's plate as one ND2 a well (an XY loop
   over a 2x2 stage grid) through ``workflow submit --device cuda`` of
   metaconfig (``handler: auto`` must resolve ``nd2``), imextract and
   config 3 with rows 1-4 launched (1, 1, 1, 2 a launched batch); the
   store equal to the generator's pixels, ``file_mapping.json`` and
   ``experiment.ome.xml`` equal to a CPU metaconfig's, the first CPU
   batch of 16 held by ``CARD_TIERS``; one well of CZI (also a 2x2 mosaic
   scene), LIF, DV, STK, LSM, OIB, OIF and FLEX through metaconfig and
   imextract, every plane equal; ``inspect --json`` over each file and
   directory; an STK its reader declines read through the TIFF path; the
   ingest bench (``benchmarks.measure_ingest``); a ``containers: {...}``
   line.
13. The codecs the containers need (``phase_codecs``,
   ``czi_zstd_p96x4_256``; no kernel of its own): phase 5's plate as one
   CZI a well with zstd1 hi-lo subblocks (the port's Zstandard encoder)
   through ``workflow submit --device cuda`` of metaconfig (``handler:
   auto`` must resolve ``czi``), imextract and config 3 with rows 1-4
   launched; the store equal to the generator's pixels site by site, the
   first CPU batch of 16 held by ``CARD_TIERS``; one well each of a zstd0
   CZI, a Gray8 zstd0 CZI, a Gray8 JPEG CZI (its pixels hash to
   :data:`JPEG_DIGEST`), grey ``.jpg`` sites and Imaris files (contiguous;
   chunked and deflated) through metaconfig and imextract; corilla and
   ``export --illumstats 0`` read back equal to ``read_illumstats``; zstd
   decode MiB/s, JPEG decode Mpix/s and HDF5 chunked-gzip read MiB/s on
   one host thread; a ``codecs: {...}`` line.
14. The serving plane (``phase_serve``, ``serve_p24x4_256``): four
   experiments of 24 wells at 2x2 sites of 256x256 (96 sites, DAPI and
   Actin, one cycle) as YAML projects running config 3 in batches of
   :data:`SERVE_BATCH`, ``max_objects=256``; ``workflow submit --device
   cuda`` of each (rows 1-4 launched), telemetry on and off in 10 pairs
   of turns, the order alternating (stores equal bit for bit), the CPU's first batch of 8 held by
   ``CARD_TIERS``; then ``enqueue`` of the four jobs for tenants ``prod``
   (weight 3) and ``dev`` (weight 1) and ``serve run --device cuda`` in a
   subprocess, sent SIGTERM once a job has persisted a batch (exit 75,
   every job re-spooled), restarted with a burst of 40 jobs at
   ``--max-queue 16`` (28 shed) and 8 more once the queue drained (the
   hysteresis re-admits them), each burst job a fresh experiment of one
   well of 2x2 sites; every served store equal to the direct submit's
   (the burst's to one direct submit of the same well), rows 1-4 counted in the daemon's ``metrics.json``, its
   ``tmx_serve_*``/``tmx_slo_*`` counters equal to the serve ledger's
   replay, ``trace --export chrome`` with one flow a trace id; a job
   whose deadline expires mid-run; eight query jobs, two groups of which
   fuse, in turns with the same jobs unfused; two daemons ``h0``/``h1`` on the
   card, ``h0`` SIGKILLed mid-job (held there by an injected persist
   stall) with ``--lease 2`` and ``h1`` reaping and finishing the job.
   Prints jobs/s, served against direct sites/s, job latency, queue
   wait and scheduling delay p50/p95, admission us a decision, query
   p50/p95 fused and unfused, the telemetry overhead and the reclaim
   seconds beside the card, and a ``serve: {...}`` line.
15. The compile and profile plumbing (``phase_profile``,
   ``profile_p96x4_256``; phases 1-14 run with the kernel-library store
   off): phase 5's plate (one cycle) through ``workflow submit --device
   cuda``, once with ``--profile`` to count each program's first call,
   then plain and with ``--profile`` in turns (stores equal; the trace's
   kernel events of rows 1-4 equal to their launch counters; the step and
   batch ranges; the wall ratio), ``workflow/perf.json`` and ``perf
   --root --json``, ``perf history`` on a regressed record (exit 1), the
   cuda-scoped tuned batch and depth, the three submit options (the
   defaults' store), and the store on in a fresh directory: an ``nvcc``
   build exported, ``cache list``, a subprocess importing it with an
   empty build directory and ``nvcc`` off its PATH (its config 3 batch of 8 sites
   equal to this process's), ``cache gc`` dropping a planted stale
   entry; a ``profile: {...}`` line with the card.
16. The reduction strategies and the image model (``phase_strategies``):
   config 3 (64 sites of 256x256 on uint16-valued pixels,
   ``max_objects=256``) built with ``build_batch_fn(reduction_strategy=s)``
   for ``fused`` and for each of onehot, sort and scatter, and config 4
   with the quantiles for fused, onehot and scatter; each held against
   the fused build (``hold_strategy``: labels and counts exact, an
   integer image's ``Intensity_sum`` exact, the features whose value
   moves with the summation order (``ORDER_FEATURES``) object by object
   within what their sums' hold allows of their float64 value, the
   ellipse's angle and eccentricity on well-conditioned cells only, the
   rest by ``CARD_TIERS``), the raw sums of every strategy but fused
   object by object within 1e-6 of float64 (``hold_sums``), rows 1-3
   launched on every strategy and rows 4-6 on fused only, sort run twice
   bit for bit; each build's ms a batch, the median of 5 rounds in
   alternating order; one well through ``workflow submit --device cuda
   --reduction-strategy scatter`` (perf store keyed ``scatter``, row 4 at
   0 launches, the default run's labels exactly and features by
   ``CARD_TIERS``); the image model on the card (``ChannelImage``'s
   correct, align and smooth against the ops, ``SegmentationImage``'s
   ``n_objects`` and polygons, ``Image.join``, ``PyramidTile.encode_png``);
   a ``strategies: {...}`` line with the card.
17. Print ``kernels: ...``, the per-kernel JSON record (the nine kernels
   and row 10, ``scripts/cc_kernel_shootout.py``, row 2's function timed
   in the A/B harness; rows 2-4 add ``spatial_launches``, their launches
   on phase 9's secondary run, and rows 2-3 ``spatial``, the kernel at
   the mosaic's shape; rows 1-4 add ``serve_launches``, their launches in
   phase 14's restarted daemon, and ``profile_launches``, phase 15's
   traced submit's), and as the last line
   ``{"ok": true, "device": {...}}``.

The script imports nothing of JAX or of ``tmlibrary_tpu``.
"""

from __future__ import annotations

import fnmatch
import functools
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

B, SIZE, MAX_OBJECTS, N_CPU_SITES = 64, 256, 256, 8
SEED = 0
#: the volume path (BASELINE config 5, bench.py:138-139, 824-826): 16
#: z-stacks of 16 planes of 128x128, 8 flooding levels
B_V, DEPTH_V, SIZE_V, N_LEVELS_V = 16, 16, 128, 8
#: corilla (BASELINE config 1, bench.py:196-197): 8 channels of 96 sites;
#: illuminati's well (bench.py:199-200,1081-1084): an 8x8 grid of sites;
#: align: rolled targets within +-40 px
C_CORILLA, S_CORILLA, GRID, MAX_DRIFT = 8, 96, 8, 40
#: phase 5's store: one 96-well plate (8x12 wells) at 2x2 sites of 256x256,
#: DAPI and Actin, 2 cycles (384 sites); jterator batches of 64; the
#: batches the CPU reruns
PLATE, SITES_PER_WELL, STEP_BATCH, CPU_BATCHES = (8, 12), (2, 2), 64, (0, 5)

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
    # integer hull counts on the host, one float64 ratio cast to float32
    "Morphology_solidity": _EXACT,
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
    # point patterns: counts, and a count over an area, exact; means of
    # distances summed over the points in another order; their std the
    # sumsq envelope
    "PointPattern_count": _EXACT,
    "PointPattern_density": _EXACT,
    "PointPattern_*_mean": _SUMS,
    "PointPattern_clark_evans": _SUMS,
    "PointPattern_*_std": (1e-3, 1e-4),
}
#: feature -> (rtol, atol) of the card's run against the port's CPU run.
#: Both sides evaluate Zernike's float32 device formulation, so it is held
#: to the card-vs-CPU spread (largest |card - cpu| 1.19e-07, PERF.md) with
#: room for cos/sin ulps, not to the JAX float64 twin's tier.
CARD_TIERS = {**FEATURE_TIERS, "Zernike_*": (1e-5, 1e-6)}
#: (rtol, atol) of the port's corilla fields against the JAX package and of
#: the card's against the CPU's.  ``n``, ``hist`` and ``percentile_values``
#: are exact; the fields go through ``log10``, which differs by ulps between
#: libraries and devices (an ulp is 4.8e-7 at log10(65536)), then IEEE
#: + - * / and a correctly rounded root.  The atols are a few such ulps: a
#: nearly flat channel's std (4e-6) moves by 3% on one.
STATS_TIERS = {"mean_log": (0.0, 2e-6), "std_log": (1e-5, 1e-6), "var_log": (1e-4, 1e-11)}
#: (rtol, atol) of the nearly flat channel's fields against the float64
#: truth (``benchmarks.cpu_reference_channel``), as ``tests/test_stats.py``
#: holds the reference's scan: relative, since that channel's std (4e-6)
#: is below every atol of :data:`STATS_TIERS`
FLAT_TRUTH_TIERS = {"mean_log": (1e-6, 0.0), "std_log": (0.05, 1e-8)}
#: registration: shifts exact (rolled content has one peak); the peak's
#: height and the subpixel peak through the FFTs' rounding
REGISTRATION_TIERS = {"shift": _EXACT, "quality": (0.0, 1e-5), "subpixel": (0.0, 1e-6)}
#: per-site QC statistics: a count over the pixel count is exact; means
#: are summed in another order than XLA's or the other device's
QC_TIERS = {"saturation_frac": _EXACT, "background": (1e-5, 0.0),
            "focus_tenengrad": (1e-4, 0.0), "laplacian_var": (1e-4, 0.0)}
#: illumination correction (``image_ops.correct_illumination``): log10, pow
#: and the two field means
CORRECTION_TIER = (1e-5, 1e-3)


def corrected_tiers(tiers: dict) -> dict:
    """``tiers`` for features measured on illumination-corrected pixels,
    where each pixel lies within :data:`CORRECTION_TIER` of the other
    side's: the intensity families take the larger of their own tier and
    that one (labels, and so every shape feature, stay exact)."""
    return {k: (max(r, CORRECTION_TIER[0]), max(a, CORRECTION_TIER[1]))
            if k.startswith(("Intensity_", "Volume_intensity_")) else (r, a)
            for k, (r, a) in tiers.items()}


#: features of a corrected pipeline, the port against the JAX package (the
#: port corrects in float64, the same on the card and the CPU, so the card
#: is held to the CPU by :data:`CARD_TIERS`)
CORRECTED_FEATURE_TIERS = corrected_tiers(FEATURE_TIERS)

#: the DL U-Net's head (flows and logit) of one implementation against
#: another's on the same sites, per site: |got - want| <= HEAD_TIER *
#: max|want|.  XLA-CPU, PyTorch's CPU and cuDNN sum each convolution in
#: another order, and the site means of the standardization too; the port
#: against the JAX package measured 6.6e-7 (tests/test_torch_nn.py)
HEAD_TIER = 4e-6
#: the cell probability beside the head tier: PyTorch's and XLA's sigmoid
#: differ by up to 2 ulps at 0.6 on the same logit (an ulp is 6e-8 there)
CELLPROB_ULPS = 1.2e-7

#: the Laplacian of a gaussian (``ops.blobs.log_response``, ``filter_edges``
#: ``log``) of one implementation against another's, per site: |got -
#: want| <= LOG_TIER * sigma**2 * max|image| (sigma**2 only where the
#: response is scale-normalised).  The port builds the gaussian's taps on
#: the host, an ulp or two from XLA-CPU's at sigma other than 1.5
#: (ROADMAP C); the Laplacian's cancellation amplifies that, measured up
#: to 1.3e-6 (tests/test_torch_blobs.py)
LOG_TIER = 4e-6
#: the bilateral filter of the port (weights and sums in float64, one
#: rounding) against the reference's float32, per site: |got - want| <=
#: BILATERAL_TIER * max|image|; measured 4.4e-7 relative
#: (tests/test_torch_smoothing.py)
BILATERAL_TIER = 2e-6


def dl_flips(want, got, prob_threshold: float) -> dict:
    """The boundary rule for the DL decoder's inputs.  ``want``/``got``:
    ``{"head": (B, 3, H, W), "prob": (B, H, W)}`` numpy of the same sites
    from two implementations.  The head must lie within
    :data:`HEAD_TIER`; the decoder reads only the flows' signs and the
    mask ``prob >= prob_threshold``, and each pixel where those differ
    must lie within the tier of its boundary: a flow component with
    ``|want| <= HEAD_TIER * max|want|`` (the site's scale), a mask pixel
    with ``|want prob - threshold|`` within a quarter of that (sigmoid's
    largest slope) plus :data:`CELLPROB_ULPS`.  Raises
    :class:`SmokeFailure` otherwise; returns the largest head error
    relative to ``max|head|`` and the flips counted."""
    import numpy as np

    wh, gh = want["head"], got["head"]
    b = wh.shape[0]
    scale = np.abs(wh).reshape(b, -1).max(axis=1)
    err = np.abs(gh - wh).reshape(b, -1).max(axis=1)
    tau = (HEAD_TIER * scale)[:, None, None]
    if (err > tau[:, 0, 0]).any():
        raise SmokeFailure(f"dl head beyond HEAD_TIER: relative error "
                           f"{(err / scale).max():.3g} > {HEAD_TIER}")
    sign_flip = np.sign(wh[:, :2]) != np.sign(gh[:, :2])
    thr = np.float32(prob_threshold)
    mask_flip = (want["prob"] >= thr) != (got["prob"] >= thr)
    bad_sign = sign_flip & (np.abs(wh[:, :2]) > tau[:, None])
    bad_mask = mask_flip & (np.abs(want["prob"] - thr) > tau / 4 + CELLPROB_ULPS)
    if bad_sign.any() or bad_mask.any():
        raise SmokeFailure(f"dl decisions flipped away from a boundary: {int(bad_sign.sum())} "
                           f"flow signs, {int(bad_mask.sum())} mask pixels")
    return {"max_rel_err": float((err / np.maximum(scale, 1e-30)).max()),
            "sign_flips": int(sign_flip.sum()), "mask_flips": int(mask_flip.sum())}


#: the analytics plane (phase 10).  kNN: a squared distance of the matmul
#: expansion ``|q|^2 - 2 q.x + |x|^2`` carries float32 rounding of order
#: ``2^-24 * (|q|^2 + |x|^2)``; two implementations (XLA-CPU, PyTorch's CPU,
#: cuBLAS) sum the product in other orders, so distances agree within
#: KNN_EPS of that scale, and a neighbour slot may hold another row only
#: where the two rows' squared distances lie within it (a near tie).
KNN_EPS = 8 * 2.0 ** -24
#: PCA components, scores and explained ratio, k-means centroids and the
#: logistic regression's logits: |got - want| <= ANALYTICS_RTOL * max|want|
#: (the components after the sign convention); a k-means assignment, IVF
#: cell or class may differ only where the reference's two candidates lie
#: within this tier of the row's scale (the decision inherits the
#: centroids' and weights' tier)
ANALYTICS_RTOL = 1e-4
#: the embedding as a subspace: the cosines of the principal angles
#: between the two n-column spans
EMBEDDING_MIN_COS = 0.999


def knn_hold(x, queries, got, want) -> dict:
    """Hold a kNN answer ``got = (idx, dist)`` against ``want`` on the
    store ``x`` and its query rows (``x`` itself for self-kNN): every slot
    whose index differs must be a near tie (both rows' float64 squared
    distances within ``KNN_EPS * (|q|^2 + |x|^2)`` of each other) and every
    squared distance within that of the reference's.  Raises
    :class:`SmokeFailure`; returns the slots that differ and the largest
    error over its bound."""
    import numpy as np

    x = np.asarray(x, np.float64)
    q = np.asarray(queries, np.float64)
    gi, gd = (np.asarray(a) for a in got)
    wi, wd = (np.asarray(a) for a in want)
    if gi.shape != wi.shape:
        raise SmokeFailure(f"knn: shapes {gi.shape} vs {wi.shape}")
    qn = (q * q).sum(axis=1)[:, None]
    xn = (x * x).sum(axis=1)
    d2 = lambda idx: ((q[:, None, :] - x[idx]) ** 2).sum(axis=-1)  # noqa: E731
    tol = KNN_EPS * (qn + np.maximum(xn[gi], xn[wi]))
    flips = gi != wi
    bad = flips & (np.abs(d2(gi) - d2(wi)) > tol)
    err = np.abs(gd.astype(np.float64) ** 2 - wd.astype(np.float64) ** 2) / tol
    if bad.any() or (err > 1).any():
        raise SmokeFailure(f"knn: {int(bad.sum())} neighbour slots differ away from a tie, "
                           f"largest |d2 error| / bound {err.max():.3g}")
    return {"flips": int(flips.sum()), "max_err_over_bound": float(err.max(initial=0.0))}


def rel_hold(name, got, want, rtol=ANALYTICS_RTOL) -> float:
    """``|got - want| <= rtol * max|want|``; returns the relative error."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise SmokeFailure(f"{name}: shape {got.shape} vs {want.shape}")
    err = float(np.abs(got - want).max(initial=0.0) / max(np.abs(want).max(initial=0.0),
                                                          1e-30))
    if err > rtol:
        raise SmokeFailure(f"{name}: relative error {err:.3g} > {rtol}")
    return err


def decision_hold(name, got, want, scores, scale, rtol=ANALYTICS_RTOL) -> int:
    """Per-row decisions (cluster, cell or class) ``got`` against ``want``:
    a row may differ only where the reference's ``scores`` (N, C) of the
    two choices lie within ``rtol * scale`` (N,) of each other.  Raises
    :class:`SmokeFailure`; returns the rows that differ."""
    import numpy as np

    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    rows = np.nonzero(got != want)[0]
    gap = np.abs(scores[rows, got[rows]] - scores[rows, want[rows]])
    if (gap > rtol * np.asarray(scale)[rows]).any():
        raise SmokeFailure(f"{name}: {len(rows)} rows decided otherwise, some away from a tie")
    return int(len(rows))


def subspace_cos(a, b) -> float:
    """The smallest cosine of the principal angles between the column
    spans of ``a`` and ``b``."""
    import numpy as np

    qa, _ = np.linalg.qr(np.asarray(a, np.float64))
    qb, _ = np.linalg.qr(np.asarray(b, np.float64))
    return float(np.linalg.svd(qa.T @ qb, compute_uv=False).min())


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
    started = time.perf_counter()
    # phases 1-14 build the kernels from the sources, not from the
    # kernel-library store (phase 15 turns it on in a fresh directory)
    os.environ["TMX_AOT_STORE"] = "0"
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
        from tmlibrary_tpu_torch import benchmarks, native, nn, shootout
        from tmlibrary_tpu_torch.jterator import modules, pipeline
        from tmlibrary_tpu_torch.jterator.description import PipelineDescription
        from tmlibrary_tpu_torch.jterator.modules import get_module
        from tmlibrary_tpu_torch.ops import (
            _cuda, fused_measure, image_ops, kernels, label, measure, pyramid, qc,
            registration, segment_primary, segment_secondary, smooth, stats, threshold,
            volume,
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
        t0 = time.perf_counter()
        native.lib()
        print(f"build: host library {time.perf_counter() - t0:.2f} s -> {native.build().name}")

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

        # (g) the dl configuration and (h) its primary + secondary form
        data_dl = benchmarks.synthetic_cell_painting_batch(B, size=SIZE, seed=SEED,
                                                           dapi_only=True)
        dl_pkg = {"pipeline": pipeline, "nn": nn, "modules": modules, "label": label,
                  "kernels": kernels, "fused_measure": fused_measure, "measure": measure,
                  "segment_secondary": segment_secondary}
        drive_dl_path(torch, dl_pkg, "dl",
                      benchmarks.dl_description(DL_WEIGHTS, DL_THRESHOLD, DL_MIN_AREA),
                      data_dl, wrappers, {"cc_min_propagate": 1, "grouped_stats": 1}, card, bw)
        drive_dl_path(torch, dl_pkg, "dl secondary", PipelineDescription.from_dict(
                          benchmarks.dl_secondary_pipe(DL_WEIGHTS, DL_THRESHOLD, DL_MIN_AREA)),
                      data_dl, wrappers, {"cc_min_propagate": 1, "watershed_flood": 1,
                                          "grouped_stats": 2}, card, bw)

        # (i) the spot-counting path, and (j) the module sweep
        from tmlibrary_tpu_torch.ops import blobs

        drive_spots_path(torch, {
            "pipeline": pipeline, "modules": modules, "benchmarks": benchmarks,
            "blobs": blobs, "kernels": kernels, "fused_measure": fused_measure}, wrappers, card)
        phase_module_sweep(torch, {"modules": modules, "measure": measure}, inputs, card)

        # ---------------------------------------------------------- phase 4
        print(f"phase 4: corilla, align, illuminati, QC, corilla -> config 3; times on {card}")
        corilla_out = phase_corilla(torch, stats, benchmarks, bw, card)
        targets, shifts = phase_align(torch, registration, dapi, card)
        phase_illuminati(torch, {"image_ops": image_ops, "pyramid": pyramid,
                                 "benchmarks": benchmarks, "registration": registration},
                         targets, shifts, corilla_out, card)
        phase_qc(torch, pipeline, desc3, data, qc, card)
        chain_sps = phase_chain(torch, {"stats": stats, "image_ops": image_ops}, pipeline,
                                benchmarks, PipelineDescription, data, wrappers, card, on_chip)

        # ---------------------------------------------------------- phase 5
        phase_steps(torch, wrappers, card, on_chip, chain_sps)

        # ---------------------------------------------------------- phase 6
        analytics_root = Path(__file__).resolve().parent / "build" / f"phase10.{os.getpid()}"
        phase_engine(torch, wrappers, card, on_chip, keep_features=analytics_root)

        # ---------------------------------------------------------- phase 7
        phase_canonical(torch, wrappers, card, on_chip)

        # ---------------------------------------------------------- phase 8
        phase_qc_session(torch, wrappers, card)

        # ---------------------------------------------------------- phase 9
        print(f"phase 9: the spatial layout, whole wells on the card; times on {card}")
        spatial, spatial_launches = phase_spatial(
            torch, {"kernels": kernels, "smooth": smooth, "threshold": threshold}, wrappers,
            card, bw)

        # each kernel's launches: the path that brought it to the port
        path_of = {"intensity_hist": run_q, "glcm_all": run4, "distance_transform": run_d,
                   "cc3d_min_propagate": run_v, "watershed3d_flood": run_v}
        for r in records:
            wrapper = r.pop("wrapper", r["name"])
            r["launches"] = path_of.get(wrapper, run3)["launches"][wrapper]
            if r["name"] in SPATIAL_KERNELS:
                # the spatial path's launches (phase 9's secondary run) and,
                # for rows 2 and 3, the kernel at the mosaic's shape
                r["spatial_launches"] = spatial_launches[r["name"]]
                if r["name"] in spatial:
                    r["spatial"] = {k: spatial[r["name"]][k] for k in (
                        "shape", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
                    r["spatial"]["flood_route"] = spatial[r["name"]].get("flood_route")

        # ---------------------------------------------------------- phase 10
        try:
            phase_analytics(torch, analytics_root, card)
        finally:
            shutil.rmtree(analytics_root, ignore_errors=True)

        # ---------------------------------------------------------- phase 11
        phase_project(torch, wrappers, card)

        # ---------------------------------------------------------- phase 12
        phase_containers(torch, wrappers, card)

        # ---------------------------------------------------------- phase 13
        phase_codecs(torch, wrappers, card)

        # ---------------------------------------------------------- phase 14
        served = phase_serve(torch, wrappers, card)
        for r in records:
            if r["name"] in served["launches"]:
                r["serve_launches"] = served["launches"][r["name"]]

        # ---------------------------------------------------------- phase 15
        profiled = phase_profile(torch, wrappers, card)
        for r in records:
            if r["name"] in profiled["launches"]:
                r["profile_launches"] = profiled["launches"][r["name"]]

        # ---------------------------------------------------------- phase 16
        phase_strategies(torch, {"pipeline": pipeline, "desc3": desc3}, wrappers, card)
        if "jax" in sys.modules or "tmlibrary_tpu" in sys.modules:
            raise SmokeFailure("JAX or the JAX package was imported")
    except Exception as e:  # the smoke's boundary: report and exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    print(f"total: {time.perf_counter() - started:.1f} s of command")
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print("kernels: " + ", ".join(r["name"] for r in records))
    # rows 1-9 add the launch alone beside the wrapper's `ms`, row 7 its A/B
    print(json.dumps({"kernels": [{k: r[k] for k in order + ["launch_ms", "ab_ms",
                                                            "spatial_launches", "spatial",
                                                            "serve_launches",
                                                            "profile_launches"]
                                   if k in r}
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
               expect=None, only=None, stats=None, cpu_result=None, hold=None) -> dict:
    """Drive one path through ``build_batch_fn`` on the card: a warm-up
    call, then every launch counter set to 0, one call, the counters read
    (each kernel in ``need`` must have launched, each in ``expect``
    exactly that often, each kernel in ``only`` every time on the route
    named there, the watershed with every site of its last launch on chip),
    the first sites held to the port's CPU run (``cpu_result`` where
    given) by ``hold(card, cpu)`` (default :func:`compare_with_cpu`), and
    the batch timed over 5 calls.  ``stats`` are
    corilla's ``{channel: (mean_log, std_log)}`` numpy fields."""
    n = next(iter(data.values())).shape[0]
    raw, stats, shifts = pipeline.from_jax_inputs(data, stats or {}, [[0, 0]] * n,
                                                  device="cuda")
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
    cpu_res = cpu_result
    if cpu_res is None:
        sub = {k: v[:N_CPU_SITES] for k, v in data.items()}
        craw, cstats, cshifts = pipeline.from_jax_inputs(
            sub, {}, [[0, 0]] * N_CPU_SITES, device="cpu")
        cpu_res = pipeline.site_result_to_numpy(
            pipeline.ImageAnalysisPipeline(desc, MAX_OBJECTS, device="cpu")
            .build_batch_fn()(craw, cstats, cshifts))
    worst = (hold or compare_with_cpu)(card_res, cpu_res)
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
    return {"launches": launches, "objects": result.objects, "counts": card_res.counts,
            "sites_per_s": n / batch_s, "fn": fn, "inputs": (raw, stats, shifts)}


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


def hold_tier(name, got, want, tier) -> float:
    """``got`` within ``tier`` (rtol, atol) of ``want`` (exact where both
    are 0); returns the largest absolute difference."""
    rtol, atol = tier
    if rtol == atol == 0.0:
        if got.shape != want.shape or got.dtype != want.dtype:
            raise SmokeFailure(f"{name}: {got.dtype} {tuple(got.shape)} held exact against "
                               f"{want.dtype} {tuple(want.shape)}")
        if not got.equal(want):
            raise SmokeFailure(f"{name}: differs (held exact)")
    else:
        import numpy as np

        np.testing.assert_allclose(got.double().numpy(), want.double().numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)
    return float((got.double() - want.double()).abs().max()) if got.numel() else 0.0


def tier_share(got, want, tier) -> float:
    """The largest ``|got - want| / (atol + rtol * |want|)``: the share of
    its tier that a hold used (1 is the limit)."""
    rtol, atol = tier
    d = (got.double() - want.double()).abs()
    return float((d / (atol + rtol * want.double().abs())).max()) if got.numel() else 0.0


def hold_stats(title, card_out, cpu_out) -> dict:
    """corilla's output on the card against the CPU's: ``n``, ``hist``,
    ``percentile_keys`` and ``percentile_values`` exact, the log-domain
    fields within :data:`STATS_TIERS`.  Returns each field's largest
    difference."""
    errs = {}
    for k in ("n", "hist", "percentile_keys", "percentile_values"):
        errs[k] = hold_tier(f"{title}.{k}", card_out[k].cpu(), cpu_out[k], _EXACT)
    for k, tier in STATS_TIERS.items():
        errs[k] = hold_tier(f"{title}.{k}", card_out[k].cpu(), cpu_out[k], tier)
    return errs


def kernel_launches(torch, fn) -> int:
    """CUDA kernels that one call of ``fn`` launches, counted by
    ``torch.profiler`` (0 where the profiler sees no device activity)."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def host_ms(torch, fn, reps: int = 3) -> float:
    """Mean milliseconds per call on the host clock, after one call, each
    call ending in ``torch.cuda.synchronize()``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def phase_corilla(torch, stats, benchmarks, bw, card) -> dict:
    """BASELINE config 1: the channel-batched scan and finalize over
    ``synthetic_channel_stack(8, 96, 256)`` on the card, timed after a
    warm-up (channels/sec, the ms and launches of one update step), then
    the corilla step's order (chunks of 32, merged); both held against the
    port's run on the CPU, and both on one nearly flat channel.  Returns
    the card's statistics of the stack."""
    import numpy as np

    stack_np = benchmarks.synthetic_channel_stack(C_CORILLA, S_CORILLA, SIZE, seed=SEED)
    stack = torch.from_numpy(stack_np).to("cuda")
    def run():
        return stats.welford_finalize(stats.welford_scan(stack))

    run()
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        out = run()
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / reps
    state = stats.welford_init((SIZE, SIZE), "cuda", lead=(C_CORILLA,))

    def step():
        return stats.welford_update(state, stack[:, 0])

    step_ms = cuda_ms(torch, step, 20)
    idx = stack[:, 0].clamp(0, stats.HIST_BINS - 1).to(torch.int32)
    hist_ms = cuda_ms(torch, lambda: stats.histogram_fixed_bins(idx, stats.HIST_BINS), 20)
    launches = kernel_launches(torch, step)
    # per step and channel: x, mean, m2 and offset read, mean and m2 written
    byte_ms = C_CORILLA * S_CORILLA * SIZE * SIZE * 4 * 6 / bw * 1e3
    print(f"  corilla: {C_CORILLA} channels x {S_CORILLA} sites of {SIZE}x{SIZE}, scan and "
          f"finalize {sec * 1e3:.2f} ms = {C_CORILLA / sec:.1f} channels/s; one update step "
          f"(all {C_CORILLA} channels) {step_ms:.4f} ms, its histogram {hist_ms:.4f} ms, "
          f"device activities a step (profiler) {launches or 'not measured'}; "
          f"bound {byte_ms:.4f} ms by bytes, on {card}")

    cpu_stack = torch.from_numpy(stack_np)
    errs = hold_stats("corilla[scan]", out, stats.welford_finalize(stats.welford_scan(cpu_stack)))
    step_order = stats.corilla_statistics(stack)
    errs_step = hold_stats("corilla[step]", step_order, stats.corilla_statistics(cpu_stack))
    g = np.random.default_rng(SEED + 6)
    flat_np = (60000.0 + g.normal(0.0, 0.5, (48, SIZE, SIZE))).astype(np.float32)
    flat = torch.from_numpy(flat_np)
    card_flat = stats.welford_finalize(stats.welford_scan(flat.to("cuda")))
    errs_flat = hold_stats("corilla[flat,scan]", card_flat,
                           stats.welford_finalize(stats.welford_scan(flat)))
    hold_stats("corilla[flat,step]", stats.corilla_statistics(flat.to("cuda")),
               stats.corilla_statistics(flat))
    truth = benchmarks.cpu_reference_channel(flat_np)  # float64, unshifted
    hold_tier("corilla[flat,truth].hist", card_flat["hist"].cpu(),
              torch.from_numpy(truth["hist"].astype(np.float32)), _EXACT)
    share = {}
    for k, tier in FLAT_TRUTH_TIERS.items():
        got, want = card_flat[k].cpu(), torch.from_numpy(truth[k])
        hold_tier(f"corilla[flat,truth].{k}", got, want, tier)
        share[k] = tier_share(got, want, tier)
    print("  corilla: n, hist, percentiles exact against the CPU on the scan, the step's "
          "order (chunks of 32, merged) and a nearly flat channel; largest |card - cpu| "
          + ", ".join(f"{k} {errs[k]:.3g}/{errs_step[k]:.3g}/{errs_flat[k]:.3g}"
                      for k in STATS_TIERS) + " (scan/step/flat); the flat channel against "
          "its float64 truth: hist exact, share of tier used " + ", ".join(
              f"{k} {v:.3g} of (rtol, atol) {FLAT_TRUTH_TIERS[k]}" for k, v in share.items()))
    return out


def phase_align(torch, registration, dapi, card):
    """The align step on 64 pairs of config 3's 256x256 DAPI sites, each
    target rolled by a known shift within +-40: shifts exact against the
    known ones and the CPU's, quality within its tier; one pair of
    unrelated noise images, which the filter must zero at min_quality 0.5.
    Returns the targets and their filtered shifts, which illuminati
    applies."""
    import numpy as np

    drift = np.random.default_rng(SEED + 5).integers(-MAX_DRIFT, MAX_DRIFT + 1, (len(dapi), 2))
    target = torch.stack([torch.roll(s, tuple(int(v) for v in d), dims=(0, 1))
                          for s, d in zip(dapi, drift)])
    shifts, quality = registration.batch_phase_correlation_quality(dapi, target)
    known = torch.from_numpy(-drift).to(torch.int32)
    hold_tier("align.shifts[known]", shifts.cpu(), known, _EXACT)
    c_shifts, c_quality = registration.batch_phase_correlation_quality(dapi.cpu(), target.cpu())
    hold_tier("align.shifts[cpu]", shifts.cpu(), c_shifts, REGISTRATION_TIERS["shift"])
    q_err = hold_tier("align.quality", quality.cpu(), c_quality, REGISTRATION_TIERS["quality"])
    kept, bad = registration.filter_shifts(shifts, quality, max_shift=50, min_quality=0.5)
    if bool(bad.any()) or not torch.equal(kept, shifts):
        raise SmokeFailure("align: the filter zeroed a rolled pair")
    g = torch.Generator().manual_seed(SEED + 7)
    noise = (torch.rand((2, 1, SIZE, SIZE), generator=g) * 4096).to("cuda")
    n_shift, n_q = registration.batch_phase_correlation_quality(noise[0], noise[1])
    zeroed, n_bad = registration.filter_shifts(n_shift, n_q, max_shift=50, min_quality=0.5)
    if not bool(n_bad.all()) or bool(zeroed.any()):
        raise SmokeFailure(f"align: unrelated noise kept shift {n_shift.tolist()} "
                           f"at quality {n_q.tolist()}")
    ms = cuda_ms(torch, lambda: registration.batch_phase_correlation_quality(dapi, target), 10)
    print(f"  align: {len(dapi)} pairs of {SIZE}x{SIZE}, shifts within +-{MAX_DRIFT} exact "
          f"against the known ones and the CPU, quality {float(quality.min()):.6f}-"
          f"{float(quality.max()):.6f} (largest |card - cpu| {q_err:.3g}); unrelated noise "
          f"quality {float(n_q[0]):.4f}, zeroed at min_quality 0.5; "
          f"{ms:.4f} ms per batch of {len(dapi)} on {card}")
    return target, kept


def phase_illuminati(torch, ops, sites, shifts, corilla_out, card) -> None:
    """illuminati on an 8x8 grid of the align phase's 256x256 targets:
    ``make_batch_prep`` (the correction against corilla's channel-0
    statistics, each site's shift from the align step, the intersection
    crop), ``join_grid``, four pyramid levels, ``to_uint8`` with the 0.1
    and 99.9 percentiles and ``cut_tiles``.  The prepared sites are held
    against the CPU's within :data:`CORRECTION_TIER`; every float level and
    every uint8 level exact against the CPU chain on the card's prepared
    sites, and the uint8 levels against the numpy pyramid job
    (``benchmarks.cpu_reference_pyramid``: level 0 exact, the others
    within one display step, since numpy sums a window in its own order)."""
    image_ops, pyramid, benchmarks = ops["image_ops"], ops["pyramid"], ops["benchmarks"]
    registration = ops["registration"]
    mean_log, std_log = corilla_out["mean_log"][0], corilla_out["std_log"][0]
    pct = corilla_out["percentile_values"][0].tolist()
    lower, upper = pct[0], pct[-1]  # the 0.1 and 99.9 percentiles
    crop = registration.intersection_window(shifts)
    window = (crop["top"], crop["bottom"], crop["left"], crop["right"])
    prep = image_ops.make_batch_prep(mean_log, std_log, window)

    def device_chain():
        corrected = prep(sites, shifts)
        levels = pyramid.pyramid_levels(image_ops.join_grid(corrected, GRID, GRID))
        return corrected, levels, [pyramid.to_uint8(lv, lower, upper) for lv in levels]

    def chain():
        out = device_chain()
        return (*out, [pyramid.cut_tiles(u) for u in out[2]])

    chain()
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        corrected, levels, u8, tiles = chain()
    sec = (time.perf_counter() - t0) / reps
    device_ms = cuda_ms(torch, device_chain, 5)
    n_tiles = sum(len(t) for t in tiles)
    h, w = levels[0].shape
    want_shape = (GRID * (SIZE - window[0] - window[1]), GRID * (SIZE - window[2] - window[3]))
    want_levels = pyramid.n_pyramid_levels(h, w)  # 4 for any crop within +-40
    want_tiles = sum(-(-lv.shape[0] // pyramid.TILE_SIZE) * -(-lv.shape[1] // pyramid.TILE_SIZE)
                     for lv in levels)
    if (h, w) != want_shape or len(levels) != want_levels or n_tiles != want_tiles:
        raise SmokeFailure(f"illuminati: level 0 {(h, w)}, {len(levels)} levels, "
                           f"{n_tiles} tiles")

    c_prep = image_ops.make_batch_prep(mean_log.cpu(), std_log.cpu(), window)
    c_corr = c_prep(sites.cpu(), shifts.cpu())
    corr_err = hold_tier("illuminati.prep", corrected.cpu(), c_corr, CORRECTION_TIER)
    corr_share = tier_share(corrected.cpu(), c_corr, CORRECTION_TIER)
    c_levels = pyramid.pyramid_levels(image_ops.join_grid(corrected.cpu(), GRID, GRID))
    numpy_u8 = benchmarks.cpu_reference_pyramid(corrected.cpu().numpy(), (GRID, GRID),
                                                len(levels), lower, upper)
    for i, (lv, c_lv) in enumerate(zip(levels, c_levels)):
        hold_tier(f"illuminati.level{i}", lv.cpu(), c_lv, _EXACT)
        hold_tier(f"illuminati.uint8[{i}]", u8[i].cpu(), pyramid.to_uint8(c_lv, lower, upper),
                  _EXACT)
        hold_tier(f"illuminati.uint8[{i}] against numpy", u8[i].cpu().to(torch.int16),
                  torch.from_numpy(numpy_u8[i]).to(torch.int16), (0.0, 0.0 if i == 0 else 1.0))
    mosaic = image_ops.join_grid(corrected, GRID, GRID)
    stages = {
        "prep": cuda_ms(torch, lambda: prep(sites, shifts), 5),
        "join_grid": cuda_ms(torch, lambda: image_ops.join_grid(corrected, GRID, GRID), 5),
        "levels": cuda_ms(torch, lambda: pyramid.pyramid_levels(mosaic), 5),
        "to_uint8": cuda_ms(torch, lambda: [pyramid.to_uint8(lv, lower, upper)
                                            for lv in levels], 5),
        "tiles_on_host": host_ms(torch, lambda: [pyramid.cut_tiles(u) for u in u8]),
    }
    mpix = levels[0].numel() / 1e6
    print(f"  illuminati: {GRID}x{GRID} sites of {SIZE}x{SIZE} -> {tuple(levels[0].shape)}, "
          f"{len(levels)} levels, {n_tiles} tiles, display {lower:g}-{upper:g}, crop {window}; "
          f"prepared sites within their tier (largest |card - cpu| {corr_err:.3g}, "
          f"{corr_share:.3g} of the tier), every float and uint8 level exact, the uint8 "
          f"levels within a step of numpy's; {sec * 1e3:.2f} ms with tiles on the host = {mpix / sec:.1f} Mpix/s, "
          f"{n_tiles / sec:.1f} tiles/s (on the card alone {device_ms:.3f} ms) on {card}")
    print_stages(card, stages)


def phase_qc(torch, pipeline, desc3, data, qc_ops, card) -> None:
    """Config 3 through ``build_batch_fn(qc=True)`` on the card (a few DAPI
    pixels of two sites set to the sensor ceiling): the QC statistics of the
    first sites within :data:`QC_TIERS` of the CPU's, and every output of
    the run bit-identical to the ``qc=False`` run."""
    data = {k: v.copy() for k, v in data.items()}
    data["DAPI"][0, :5, :5] = qc_ops.SATURATION_LEVEL
    data["DAPI"][1, 7, :] = qc_ops.SATURATION_LEVEL + 1000.0
    n = next(iter(data.values())).shape[0]
    raw, st, sh = pipeline.from_jax_inputs(data, {}, [[0, 0]] * n, device="cuda")
    pipe = pipeline.ImageAnalysisPipeline(desc3, MAX_OBJECTS, device="cuda")
    fn_qc, fn = pipe.build_batch_fn(qc=True), pipe.build_batch_fn()
    result, qstats = fn_qc(raw, st, sh)
    plain = fn(raw, st, sh)
    for part in ("objects", "counts"):
        for k, v in getattr(plain, part).items():
            if not torch.equal(getattr(result, part)[k], v):
                raise SmokeFailure(f"qc: {part} {k} differ with QC on")
    for obj, feats in plain.measurements.items():
        for feat, v in feats.items():
            if not torch.equal(result.measurements[obj][feat], v):
                raise SmokeFailure(f"qc: {obj}/{feat} differs with QC on")
    sub = {k: v[:N_CPU_SITES] for k, v in data.items()}
    craw, cst, csh = pipeline.from_jax_inputs(sub, {}, [[0, 0]] * N_CPU_SITES, device="cpu")
    _, cstats = pipeline.ImageAnalysisPipeline(desc3, MAX_OBJECTS, device="cpu").build_batch_fn(
        qc=True)(craw, cst, csh)
    worst = {}
    for ch, metrics in cstats.items():
        for k, want in metrics.items():
            err = hold_tier(f"qc.{ch}.{k}", qstats[ch][k][:N_CPU_SITES].cpu(), want, QC_TIERS[k])
            worst[k] = max(worst.get(k, 0.0), err)
    if not float(qstats["DAPI"]["saturation_frac"][:2].min()) > 0:
        raise SmokeFailure("qc: the saturated pixels were not counted")

    def timed(f):
        f(raw, st, sh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            f(raw, st, sh)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 5 * 1e3

    off_ms, on_ms = timed(fn), timed(fn_qc)
    stats_ms = cuda_ms(torch, lambda: [qc_ops.site_qc_stats(raw[ch]) for ch in raw], 5)
    print(f"  qc: outputs bit-identical with QC on and off; statistics of {N_CPU_SITES} sites "
          "within their tiers of the CPU's (largest |card - cpu| "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f"); {on_ms:.2f} ms per batch of {n} with QC, {off_ms:.2f} without, the "
          f"statistics of both channels alone {stats_ms:.3f} ms, on {card}")


def phase_chain(torch, ops, pipeline, benchmarks, description, data, wrappers, card,
                on_chip) -> float:
    """corilla -> config 3 with ``correct: true``: corilla's statistics of
    config 3's 64 DAPI and Actin sites computed on the card (the step's
    order; held against the CPU's), config 3 with both channels corrected
    through ``build_batch_fn`` on the card with the launch counters as on
    path (a), labels, counts and features of the first sites against the
    port's CPU pipeline (``correct: false``) run on the card's corrected
    images (the pipeline's own preprocessing on the card), and those
    images within :data:`CORRECTION_TIER` of the CPU's correction.  The CPU
    pipeline with ``correct: true`` on the card's statistics is compared
    too, and how many label pixels differ is printed."""
    import numpy as np

    stats_mod, image_ops = ops["stats"], ops["image_ops"]
    stack = torch.stack([torch.from_numpy(data[ch]) for ch in ("DAPI", "Actin")])
    card_stats = stats_mod.corilla_statistics(stack.to("cuda"))
    errs = hold_stats("chain.corilla", card_stats, stats_mod.corilla_statistics(stack))
    if not bool(card_stats["mean_log"].isfinite().all() & card_stats["std_log"].isfinite().all()):
        raise SmokeFailure("chain: corilla's fields are not finite")
    stats = {ch: (card_stats["mean_log"][i].cpu().numpy(), card_stats["std_log"][i].cpu().numpy())
             for i, ch in enumerate(("DAPI", "Actin"))}
    desc_c = description.from_dict({**benchmarks.CELL_PAINTING_PIPE, "input": {"channels": [
        {"name": "DAPI", "correct": True}, {"name": "Actin", "correct": True}]}})

    n = next(iter(data.values())).shape[0]
    raw, st, sh = pipeline.from_jax_inputs(data, stats, [[0, 0]] * n, device="cuda")
    corrected = pipeline.ImageAnalysisPipeline(desc_c, MAX_OBJECTS, device="cuda") \
        .build_preprocess_fn()(raw, st, sh)
    images = {k: v[:N_CPU_SITES].cpu() for k, v in corrected.items()}
    cpu_result = pipeline.site_result_to_numpy(pipeline.ImageAnalysisPipeline(
        benchmarks.cell_painting_description(), MAX_OBJECTS, device="cpu").build_batch_fn()(
        images, {}, sh[:N_CPU_SITES].cpu()))
    run = drive_path(torch, pipeline, "corilla -> config 3 (correct: true)", desc_c, data,
                     wrappers, need=list(on_chip) + ["cc_min_propagate", "grouped_stats"],
                     card=card, expect={"fill_holes_flood": 1, "watershed_flood": 1,
                                        "cc_min_propagate": 1, "grouped_stats": 2},
                     only=on_chip, stats=stats, cpu_result=cpu_result)

    sub = {k: torch.from_numpy(v[:N_CPU_SITES]) for k, v in data.items()}
    corr_err = corr_share = 0.0
    for ch, (mean_log, std_log) in stats.items():
        want = image_ops.correct_illumination(sub[ch], torch.from_numpy(mean_log),
                                              torch.from_numpy(std_log))
        corr_err = max(corr_err, hold_tier(f"chain.correction.{ch}", images[ch], want,
                                           CORRECTION_TIER))
        corr_share = max(corr_share, tier_share(images[ch], want, CORRECTION_TIER))
    craw, cst, csh = pipeline.from_jax_inputs({k: v.numpy() for k, v in sub.items()}, stats,
                                              [[0, 0]] * N_CPU_SITES, device="cpu")
    cpu_corrected = pipeline.ImageAnalysisPipeline(desc_c, MAX_OBJECTS, device="cpu") \
        .build_batch_fn()(craw, cst, csh)
    differ = {obj: int((lab != run["objects"][obj][:N_CPU_SITES].cpu()).sum())
              for obj, lab in cpu_corrected.objects.items()}
    print("  chain: corilla's statistics of DAPI and Actin against the CPU's: n, hist, "
          "percentiles exact, largest |card - cpu| " + ", ".join(
              f"{k} {errs[k]:.3g}" for k in STATS_TIERS)
          + f"; corrected images within their tier of the CPU's correction (largest "
          f"|card - cpu| {corr_err:.3g}, {corr_share:.3g} of the tier); label pixels that "
          f"differ from the CPU pipeline corrected on the CPU with the card's statistics: {differ} "
          f"({'equal' if not any(differ.values()) else 'see ROADMAP C'})")
    return run["sites_per_s"]


def phase_steps(torch, wrappers, card, on_chip, chain_sps: float) -> None:
    """The store-bound steps on the card (BASELINE config 3 corrected and
    aligned, run as a user runs it): one 96-well plate at 2x2 sites of
    256x256 (384 sites, DAPI and Actin; cycle 1 is cycle 0 with each site
    rolled within +-40) written with ``ExperimentStore.write_sites`` under
    ``build/``; ``corilla``, ``align`` (ref_cycle 0) and ``jterator``
    (cycle 1, both channels ``correct: true`` and ``align: true`` from a
    ``.pipe.json``, batches of 64, ``max_objects=256``,
    ``object_buckets="auto"``) through their own verbs on ``cuda``, the
    jterator step (``init``, ``run_batches_pipelined`` at the default
    depth, ``collect``) with the launch counters set to 0 just before and
    read just after; a warm pass over a fresh root; then the CPU hold:
    corilla and align on ``device="cpu"`` over a copy of the images, and
    jterator batches :data:`CPU_BATCHES` on the CPU over the card's
    statistics and shifts, held by site index against the card's store.
    The directory is removed at the end."""
    import numpy as np

    from tmlibrary_tpu_torch import benchmarks, capacity
    from tmlibrary_tpu_torch.models.experiment import grid_experiment
    from tmlibrary_tpu_torch.models.mapobject import MapobjectTypeRegistry
    from tmlibrary_tpu_torch.models.store import ExperimentStore
    from tmlibrary_tpu_torch.workflow import get_step

    base = Path(__file__).resolve().parent / "build" / f"phase5.{os.getpid()}"
    shutil.rmtree(base, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        exp = grid_experiment("phase5", well_rows=PLATE[0], well_cols=PLATE[1],
                              sites_per_well=SITES_PER_WELL, channel_names=("DAPI", "Actin"),
                              site_shape=(SIZE, SIZE), n_cycles=2)
        n = exp.n_sites
        data = benchmarks.synthetic_cell_painting_batch(n, size=SIZE, seed=SEED)
        drift = np.random.default_rng(SEED + 8).integers(-MAX_DRIFT, MAX_DRIFT + 1, (n, 2))
        store = ExperimentStore.create(base / "card", exp)
        for c, ch in enumerate(("DAPI", "Actin")):
            px = data[ch].astype(np.uint16)
            store.write_sites(px, list(range(n)), cycle=0, channel=c)
            store.write_sites(np.stack([np.roll(s, tuple(d), axis=(0, 1))
                                        for s, d in zip(px, drift)]),
                              list(range(n)), cycle=1, channel=c)
        del data
        pipe = dict(benchmarks.CELL_PAINTING_PIPE)
        pipe["input"] = {"channels": [{"name": ch, "correct": True, "align": True}
                                      for ch in ("DAPI", "Actin")]}
        (store.root / "cp.pipe.json").write_text(json.dumps(pipe))
        setup_s = time.perf_counter() - t0
        print(f"phase 5: the steps over a store of {n} sites ({PLATE[0]}x{PLATE[1]} wells at "
              f"{SITES_PER_WELL[0]}x{SITES_PER_WELL[1]} sites of {SIZE}x{SIZE}, DAPI and Actin, "
              f"2 cycles; written in {setup_s:.2f} s) on {card}")

        # corilla and align on the card
        steps = {name: get_step(name)(store) for name in ("corilla", "align")}
        for name, step in steps.items():
            if step.device.type != "cuda":
                raise SmokeFailure(f"steps: {name} runs on {step.device}")
        corilla = steps["corilla"]
        corilla.init({})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in corilla.list_batches():
            corilla.run(i)
        corilla_s = time.perf_counter() - t0
        n_channels = len(corilla.list_batches())
        align = steps["align"]
        align.init({"ref_cycle": 0, "batch_size": STEP_BATCH})
        t0 = time.perf_counter()
        for i in align.list_batches():
            align.run(i)
        align_s = time.perf_counter() - t0
        n_align = len(align.list_batches())
        window = align.collect()["window"]
        if not np.array_equal(store.read_shifts(1), -drift):
            raise SmokeFailure("steps: align's shifts differ from the known drift")
        print(f"  corilla step: {n_channels} channels of {n} sites in {corilla_s:.3f} s = "
              f"{n_channels / corilla_s:.2f} channels/s; align step: {n_align} batches of "
              f"{STEP_BATCH} pairs in {align_s:.3f} s = {align_s / n_align * 1e3:.2f} ms per "
              f"batch, shifts exact against the known drift, window {window}; on {card}")

        # jterator on the card: the main path of this phase
        args = {"pipe": "cp.pipe.json", "cycle": 1, "batch_size": STEP_BATCH,
                "max_objects": MAX_OBJECTS, "object_buckets": "auto"}
        capacity.reset_routing_history()
        run = run_jterator_step(torch, get_step, store, args, wrappers)
        launches, results, collected = run["launches"], run["results"], run["collected"]
        jt = run["step"]
        n_launched = len(results) + sum(r.get("bucket_escalations", 0) for r in results)
        want = {"fill_holes_flood": n_launched, "cc_min_propagate": n_launched,
                "watershed_flood": n_launched, "grouped_stats": 2 * n_launched}
        print(f"  jterator step: launches {launches} over {len(results)} batches and "
              f"{n_launched - len(results)} escalation re-launches")
        for k, count in want.items():
            if launches[k] != count:
                raise SmokeFailure(f"steps: {k} launched {launches[k]} times, expected {count}")
        for k, route in on_chip.items():
            taken = {r: c for r, c in wrappers[k].routes.items() if c}
            if taken != {route: launches[k]}:
                raise SmokeFailure(f"steps: {k} routes {taken}, expected all on {route}")
        site = wrappers["watershed_flood"].site_routes
        if site is None or bool((site != 0).any()):
            raise SmokeFailure(f"steps: watershed_flood sites off chip: {site}")
        registry = MapobjectTypeRegistry(store.root).names()
        if registry != ["cells", "nuclei"]:
            raise SmokeFailure(f"steps: mapobject types {registry}")
        for name in ("nuclei", "cells"):
            persisted = sum(r["objects"][name] for r in results)
            rows = len(store.read_features(name)["label"])
            if not collected["objects_total"][name] == persisted == rows:
                raise SmokeFailure(f"steps: {name} objects_total "
                                   f"{collected['objects_total'][name]}, persisted {persisted}, "
                                   f"feature rows {rows}")
        labels = store.read_labels(None, "nuclei")
        top, left = window["top"], window["left"]
        if labels.max() < 1 or labels[:, :top].any() or labels[:, :, :left].any():
            raise SmokeFailure("steps: nuclei labels empty or outside the window")
        print_step_run(run, n, card, chain_sps, "cold router, fresh process history")
        reads_s = sum_reads(jt)
        persist_s = run["stats"]["phases"].get("persist", {}).get("total_s", 0.0)
        print(f"  jterator step IO: store reads timed alone {reads_s:.3f} s, persist (on the "
              f"worker) {persist_s:.3f} s = {(reads_s + persist_s) / run['seconds']:.1%} of the "
              f"step's {run['seconds']:.3f} s (they overlap the device; an upper bound)")
        print("  host syncs inside one launch_batch (torch.cuda sync debug mode): "
              + syncs_in_launch(torch, jt))

        # a warm pass over a fresh root (kernels built, the routing history
        # warm, so a packed plan), then object_buckets="off": both stores
        # must be the cold run's, bit for bit
        for title, run_args in (("warm pass, fresh root, packed plan", args),
                                ('object_buckets="off"', {**args, "object_buckets": "off"})):
            for name in ("images", "illumstats", "alignment"):
                copy_part(store.root, base / "again", name)
            again = ExperimentStore.open(base / "again")
            (again.root / "cp.pipe.json").write_text(json.dumps(pipe))
            print_step_run(run_jterator_step(torch, get_step, again, run_args, wrappers), n,
                           card, chain_sps, title)
            same_store(again, store, title)
            shutil.rmtree(base / "again")

        hold_steps_on_cpu(torch, store, base, pipe, args, card)
    finally:
        shutil.rmtree(base, ignore_errors=True)


def run_cli(cli, argv: list[str]) -> str:
    """``cli.main(argv)`` in this process (so the launch counters see its
    kernels), its standard output returned; a non-zero exit fails."""
    rc, out = run_cli_rc(cli, argv)
    if rc != 0:
        raise SmokeFailure(f"cli {' '.join(argv[:2])} exited {rc}: {out[-500:]}")
    return out


def ledger_sequence(engine, root: Path) -> list[tuple]:
    """A run ledger's (event, step, batch) sequence without its ``span``
    events, which time the run (telemetry on) and differ with the
    executor's depth."""
    return [(e.get("event"), e.get("step"), e.get("batch"))
            for e in engine.RunLedger(root / "workflow" / "ledger.jsonl").events()
            if e.get("event") != "span"]


def phase_engine(torch, wrappers, card, on_chip, keep_features: Path | None = None) -> None:
    """Phase 6, ``workflow_engine_p96x4_256_c4``: the ``Workflow`` engine
    through the port's CLI, as a user submits a workflow.  Phase 5's
    plate (96 wells at 2x2 sites of 256x256, 384 sites, 2 cycles, cycle 1
    rolled within +-40) with config 4's five stains, written under
    ``build/``; a JSON description of corilla -> align (ref_cycle 0,
    batches of 64) -> jterator (config 4 with every channel corrected and
    aligned, from a ``.pipe.json``; cycle 1, batches of 64,
    ``max_objects=256``) run by ``workflow submit --device cuda`` in this
    process with the launch counters set to 0 just before and read just
    after, then ``workflow resume`` on the finished ledger (nothing may
    re-run or launch) and ``workflow status``.  Holds: the shards read
    back equal the rows persisted; the same description through ``workflow
    submit --device cpu`` over a copy of the images gives the ledger's
    (event, step, batch) sequence, statistics by ``STATS_TIERS``, shifts
    exactly, and on jterator's batch 0 (64 sites) labels, counts and
    ``Morphology_solidity`` exactly, the other features by
    ``corrected_tiers(CARD_TIERS)``.  The directory is removed at the end; the
    card run's manifest and feature shards are copied to ``keep_features``
    first, where given (phase 10 queries them)."""
    import threading

    import numpy as np

    from tmlibrary_tpu_torch import benchmarks, capacity, cli
    from tmlibrary_tpu_torch.io import parquet
    from tmlibrary_tpu_torch.models.experiment import grid_experiment
    from tmlibrary_tpu_torch.models.store import ExperimentStore
    from tmlibrary_tpu_torch.workflow import engine
    from tmlibrary_tpu_torch.workflow.steps import jterator as jterator_step

    base = Path(__file__).resolve().parent / "build" / f"phase6.{os.getpid()}"
    shutil.rmtree(base, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        channels = benchmarks.FULL_STACK_CHANNELS
        exp = grid_experiment("phase6", well_rows=PLATE[0], well_cols=PLATE[1],
                              sites_per_well=SITES_PER_WELL, channel_names=channels,
                              site_shape=(SIZE, SIZE), n_cycles=2)
        n = exp.n_sites
        data = benchmarks.synthetic_full_stack_batch(n, size=SIZE, seed=SEED)
        drift = np.random.default_rng(SEED + 9).integers(-MAX_DRIFT, MAX_DRIFT + 1, (n, 2))
        store = ExperimentStore.create(base / "card", exp)
        for c, ch in enumerate(channels):
            px = data.pop(ch).astype(np.uint16)
            store.write_sites(px, list(range(n)), cycle=0, channel=c)
            store.write_sites(np.stack([np.roll(s, tuple(d), axis=(0, 1))
                                        for s, d in zip(px, drift)]),
                              list(range(n)), cycle=1, channel=c)
        pipe = benchmarks.full_feature_pipe(texture_levels=LEVELS, zernike_degree=ZERNIKE_DEGREE,
                                            correct=True, align=True)
        (store.root / "c4.pipe.json").write_text(json.dumps(pipe))
        desc_path = base / "workflow.json"
        engine.WorkflowDescription.canonical({
            "corilla": {},
            "align": {"ref_cycle": 0, "batch_size": STEP_BATCH},
            "jterator": {"pipe": "c4.pipe.json", "cycle": 1, "batch_size": STEP_BATCH,
                         "max_objects": MAX_OBJECTS},
        }).save(desc_path)
        root = str(store.root)
        print(f"phase 6, workflow_engine_p96x4_256_c4: corilla -> align -> jterator (config 4, "
              f"{len(channels)} channels corrected and aligned) through `workflow submit "
              f"--device cuda` over {n} sites ({PLATE[0]}x{PLATE[1]} wells at "
              f"{SITES_PER_WELL[0]}x{SITES_PER_WELL[1]} sites of {SIZE}x{SIZE}, 2 cycles; "
              f"written in {time.perf_counter() - t0:.2f} s) on {card}")

        # the persist worker's solidity and Parquet time, and every table
        # it hands the Parquet writer
        lock = threading.Lock()
        spent = {"solidity": 0.0, "parquet": 0.0}
        written: dict[str, dict] = {}
        solidity, write_table = jterator_step.solidity_batch, parquet.write_table

        def timed_solidity(*a, **kw):
            t = time.perf_counter()
            out = solidity(*a, **kw)
            with lock:
                spent["solidity"] += time.perf_counter() - t
            return out

        def timed_write(path, columns):
            t = time.perf_counter()
            out = write_table(path, columns)
            with lock:
                spent["parquet"] += time.perf_counter() - t
                written[str(path)] = columns
            return out

        submit = ["workflow", "submit", "--root", root, "--description", str(desc_path)]
        capacity.reset_routing_history()
        jterator_step.solidity_batch, parquet.write_table = timed_solidity, timed_write
        try:
            torch.cuda.synchronize()
            for w in wrappers.values():
                w.launches = 0
                if hasattr(w, "routes"):
                    w.routes = dict.fromkeys(w.routes, 0)
            t0 = time.perf_counter()
            summary = json.loads(run_cli(cli, submit + ["--device", "cuda"]))
            torch.cuda.synchronize()
            engine_s = time.perf_counter() - t0
            launches = {k: w.launches for k, w in wrappers.items()}
        finally:
            jterator_step.solidity_batch, parquet.write_table = solidity, write_table

        events = engine.RunLedger(store.workflow_dir / "ledger.jsonl").events()
        done = {e["step"]: e for e in events if e["event"] == "step_done"}
        steps = ["corilla", "align", "jterator"]
        if list(summary) != steps or sorted(done) != sorted(steps):
            raise SmokeFailure(f"engine: summary {list(summary)}, steps done {sorted(done)}")
        results = [e["result"] for e in events
                   if e["event"] == "batch_done" and e["step"] == "jterator"]
        n_launched = len(results) + sum(r.get("bucket_escalations", 0) for r in results)
        expected = {k: 0 for k in wrappers}
        expected.update({"fill_holes_flood": n_launched, "cc_min_propagate": n_launched,
                         "watershed_flood": n_launched, "grouped_stats": 16 * n_launched,
                         "glcm_all": n_launched})
        print(f"  launches {launches} over {len(results)} jterator batches and "
              f"{n_launched - len(results)} escalation re-launches")
        if launches != expected:
            raise SmokeFailure(f"engine: launches {launches}, expected {expected}")
        for k, route in on_chip.items():
            taken = {r: c for r, c in wrappers[k].routes.items() if c}
            if taken != {route: launches[k]}:
                raise SmokeFailure(f"engine: {k} routes {taken}, expected all on {route}")
        stats = done["jterator"]["pipeline_stats"]
        persist_s = stats["phases"]["persist"]["total_s"]
        walls = {s: done[s]["elapsed"] for s in steps}
        print(f"  engine: {n} sites in {engine_s:.3f} s = {n / engine_s:.1f} sites/s end to end "
              f"(CLI submit: corilla, align, jterator); step walls (s): "
              + ", ".join(f"{s} {walls[s]:.3f}" for s in steps)
              + f"; jterator {n / walls['jterator']:.1f} sites/s; on {card}")
        print(f"    executor at depth {stats['depth']} ({stats['source']}), totals (s): "
              + ", ".join(f"{k} {v['total_s']:.3f}" for k, v in stats["phases"].items())
              + f"; rungs routed {sorted({r['bucket_capacity'] for r in results})}")
        # the same solidity calls alone, the persist worker's neighbours idle
        alone = []
        for name in ("nuclei", "cells"):
            stack = store.read_labels(list(range(STEP_BATCH)), name)
            t0 = time.perf_counter()
            for _ in range(3):
                solidity(stack, MAX_OBJECTS)
            alone.append((time.perf_counter() - t0) / 3 / STEP_BATCH * 1e3)
        print(f"    persist {persist_s:.3f} s: solidity {spent['solidity']:.3f} s "
              f"({spent['solidity'] / persist_s:.1%}), Parquet writes {spent['parquet']:.3f} s "
              f"({spent['parquet'] / persist_s:.1%}) of it; solidity alone (a batch, nothing "
              f"else running) nuclei {alone[0]:.3f}, cells {alone[1]:.3f} ms a site; on {card}")

        # the shards read back equal the rows persisted
        nan_cells = {}
        for path, cols in written.items():
            back = parquet.read_table(path)
            if list(back) != list(cols):
                raise SmokeFailure(f"engine: {path} reads back columns {list(back)}")
            for k, v in cols.items():
                v = np.asarray(v)
                same = (back[k].tolist() == v.tolist() if v.dtype.kind in "UO" else
                        back[k].dtype == v.dtype and
                        np.array_equal(back[k], v, equal_nan=v.dtype.kind == "f"))
                if not same:
                    raise SmokeFailure(f"engine: {Path(path).name} column {k} reads back "
                                       "other values")
                if v.dtype.kind == "f":
                    family = Path(path).parent.name
                    nan_cells[family] = nan_cells.get(family, 0) + int(np.isnan(v).sum())
        for name in ("nuclei", "cells"):
            rows = len(store.read_features(name)["label"])
            persisted = sum(r["objects"][name] for r in results)
            total = summary["jterator"]["collected"]["objects_total"][name]
            if not rows == persisted == total:
                raise SmokeFailure(f"engine: {name} rows {rows}, persisted {persisted}, "
                                   f"objects_total {total}")
        solid = store.read_features("nuclei")["Morphology_solidity"]
        if not ((solid > 0) & (solid <= 1)).all():
            raise SmokeFailure("engine: Morphology_solidity outside (0, 1]")
        print(f"  shards: {len(written)} Parquet shards read back equal to the rows persisted; "
              f"NaN feature values per family {nan_cells}")

        # resume on the finished ledger: nothing re-runs, nothing launches
        before = ledger_sequence(engine, store.root)
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        resumed = json.loads(run_cli(cli, ["workflow", "resume", "--root", root, "--description",
                                           str(desc_path), "--device", "cuda"]))
        resume_s = time.perf_counter() - t0
        relaunched = {k: w.launches for k, w in wrappers.items() if w.launches}
        if resumed != {} or relaunched or \
                ledger_sequence(engine, store.root) != before + [("run_started", None, None)]:
            raise SmokeFailure(f"engine: resume re-ran {resumed} / launched {relaunched}")
        status = run_cli(cli, ["workflow", "status", "--root", root])
        states = [line.split()[:2] for line in status.splitlines()
                  if not line.startswith((" ", "heartbeat"))]
        if states != [[s, "done"] for s in steps]:
            raise SmokeFailure(f"engine: status {states}")
        print(f"  resume on the finished ledger: nothing re-ran or launched ({resume_s:.3f} s); "
              "status:\n" + "\n".join("    " + line for line in status.splitlines()))

        # the same description on the CPU
        copy_part(store.root, base / "cpu", "images")
        cpu = ExperimentStore.open(base / "cpu")
        (cpu.root / "c4.pipe.json").write_text(json.dumps(pipe))
        capacity.reset_routing_history()
        t0 = time.perf_counter()
        run_cli(cli, ["workflow", "submit", "--root", str(cpu.root), "--description",
                      str(desc_path), "--device", "cpu"])
        cpu_s = time.perf_counter() - t0
        if ledger_sequence(engine, cpu.root) != before:
            raise SmokeFailure("engine: the CPU run's ledger events differ from the card's")
        errs = {}
        for cycle in range(2):
            for ch in range(len(channels)):
                got, want = store.read_illumstats(cycle, ch), cpu.read_illumstats(cycle, ch)
                for k in ("n", "percentile_keys", "percentile_values"):
                    hold_tier(f"engine.corilla[{cycle},{ch}].{k}", torch.from_numpy(got[k]),
                              torch.from_numpy(want[k]), _EXACT)
                for k, tier in STATS_TIERS.items():
                    errs[k] = max(errs.get(k, 0.0), hold_tier(
                        f"engine.corilla[{cycle},{ch}].{k}", torch.from_numpy(got[k]),
                        torch.from_numpy(want[k]), tier))
        if not np.array_equal(store.read_shifts(1), cpu.read_shifts(1)):
            raise SmokeFailure("engine: the CPU's shifts differ from the card's")
        sites = json.loads((store.workflow_dir / "jterator" / "batch_000.json").read_text())[
            "sites"]
        # batch 0 as the CPU run wrote it, each side corrected with its own
        # statistics: labels, counts and solidity exact; the features it
        # puts outside the corrected tiers are counted (an intensity
        # standard deviation's cancellation magnifies the statistics'
        # ulps by (mean / std)^2)
        outside, worst_own = hold_batch(store, cpu, sites, corrected_tiers(CARD_TIERS),
                                        gate=False)
        # batch 0 again on the CPU over the card's statistics (the CPU
        # engine's batch file, `jterator run --job 0`): every feature by
        # CARD_TIERS
        copy_part(store.root, cpu.root, "illumstats")
        t0 = time.perf_counter()
        run_cli(cli, ["jterator", "run", "--root", str(cpu.root), "--device", "cpu",
                      "--job", "0"])
        rerun_s = time.perf_counter() - t0
        _, worst = hold_batch(store, cpu, sites, CARD_TIERS, gate=True)
        print(f"  CPU hold: the same description on the CPU in {cpu_s:.2f} s: ledger events "
              f"equal ({len(before)}), corilla n/percentiles exact, largest |card - cpu| "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + f"; shifts exact; batch 0 ({len(sites)} sites): labels, counts and "
              "Morphology_solidity exact; features with each side's own statistics: "
              f"{outside} values outside corrected CARD_TIERS, largest |card - cpu| by family "
              + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst_own.items()))
              + f"; batch 0 rerun on the CPU over the card's statistics ({rerun_s:.2f} s): "
              "features within CARD_TIERS, largest |card - cpu| by family "
              + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items())))
        if keep_features is not None:
            shutil.rmtree(keep_features, ignore_errors=True)
            copy_part(store.root, keep_features, "features")
    finally:
        shutil.rmtree(base, ignore_errors=True)


#: phase 7's CPU hold: the sites of the CPU's first jterator batch (16, as
#: phases 11-13 hold; a card batch of 64 takes ~40 s of the CPU)
CANONICAL_CPU_BATCH = 16


def phase_canonical(torch, wrappers, card, on_chip) -> None:
    """Phase 7, ``workflow_canonical_p96x4_256``: the canonical workflow
    from a directory of microscope files, as a user runs it.  Phase 5's
    plate (96 wells at 2x2 sites of 256x256, 384 sites) with config 3's
    DAPI and Actin (seed 0) written by the port's ``ImageWriter`` as
    ``{well}_s{site}_{channel}.tif`` under ``build/``; ``create``, then
    ``workflow submit --device cuda`` in this process of metaconfig
    (``sites_per_well_x`` 2) -> imextract -> corilla -> illuminati (its
    defaults) -> jterator (config 3 with both channels corrected, from a
    ``.pipe.json``, batches of 64, ``max_objects=256``), with the launch
    counters set to 0 just before and read just after (1, 1, 1, 2 per
    launched batch), then ``workflow resume`` (nothing re-runs or
    launches).  Holds: the ingested store equals the generator's pixels;
    ``file_mapping.json`` and ``experiment.ome.xml`` equal a CPU
    metaconfig's over the same directory; every tile, decoded by the
    port's codec, and ``layer.json`` equal a CPU illuminati's over the
    card's statistics; the static mapobject shards read back equal to the
    rows written (right after they are written: jterator's ``init``
    clears ``segmentations/``, as in the reference); jterator's first
    batch of :data:`CANONICAL_CPU_BATCH` sites on the CPU over the card's
    statistics: labels exact, features by ``CARD_TIERS``.  The directory
    is removed at the end."""
    import numpy as np

    from tmlibrary_tpu_torch import benchmarks, capacity, cli
    from tmlibrary_tpu_torch.io import parquet, png
    from tmlibrary_tpu_torch.models.experiment import Experiment
    from tmlibrary_tpu_torch.models.store import ExperimentStore
    from tmlibrary_tpu_torch.workflow import engine, get_step
    from tmlibrary_tpu_torch.writers import ImageWriter

    base = Path(__file__).resolve().parent / "build" / f"phase7.{os.getpid()}"
    shutil.rmtree(base, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        wells = [f"{chr(65 + r)}{c + 1:02d}" for r in range(PLATE[0]) for c in range(PLATE[1])]
        per_well = SITES_PER_WELL[0] * SITES_PER_WELL[1]
        n = len(wells) * per_well
        data = benchmarks.synthetic_cell_painting_batch(n, size=SIZE, seed=SEED)
        pixels = {ch: data[ch].astype(np.uint16) for ch in ("DAPI", "Actin")}
        del data
        src = base / "src"
        for i in range(n):
            for ch, px in pixels.items():
                with ImageWriter(src / f"{wells[i // per_well]}_s{i % per_well}_{ch}.tif") as w:
                    w.write(px[i])
        files = sorted(src.iterdir())
        mbytes = sum(f.stat().st_size for f in files) / 2**20
        write_s = time.perf_counter() - t0
        pipe = dict(benchmarks.CELL_PAINTING_PIPE)
        pipe["input"] = {"channels": [{"name": ch, "correct": True, "align": False}
                                      for ch in ("DAPI", "Actin")]}
        args = {"pipe": "cp.pipe.json", "batch_size": STEP_BATCH, "max_objects": MAX_OBJECTS}
        desc_path = base / "workflow.json"
        engine.WorkflowDescription.canonical({
            "metaconfig": {"source_dir": str(src), "sites_per_well_x": SITES_PER_WELL[1]},
            "imextract": {},
            "corilla": {},
            "illuminati": {},
            "jterator": args,
        }).save(desc_path)
        root = str(base / "card")
        run_cli(cli, ["create", "--root", root, "--name", "canonical"])
        (base / "card" / "cp.pipe.json").write_text(json.dumps(pipe))
        print(f"phase 7, workflow_canonical_p96x4_256: metaconfig -> imextract -> corilla -> "
              f"illuminati -> jterator (config 3, both channels corrected) through `create` and "
              f"`workflow submit --device cuda` from {len(files)} TIFF files ({mbytes:.1f} MiB, "
              f"{PLATE[0]}x{PLATE[1]} wells at {SITES_PER_WELL[0]}x{SITES_PER_WELL[1]} sites of "
              f"{SIZE}x{SIZE}; written by the port's ImageWriter in {write_s:.2f} s) on {card}")

        # the static shards, read back right after they are written
        shards: dict[str, tuple[dict, dict]] = {}
        write_table = parquet.write_table

        def recording_write(path, columns):
            out = write_table(path, columns)
            if "_polygons_" in Path(path).name:
                shards[Path(path).name] = (columns, parquet.read_table(path))
            return out

        submit = ["workflow", "submit", "--root", root, "--description", str(desc_path)]
        capacity.reset_routing_history()
        parquet.write_table = recording_write
        try:
            torch.cuda.synchronize()
            for w in wrappers.values():
                w.launches = 0
                if hasattr(w, "routes"):
                    w.routes = dict.fromkeys(w.routes, 0)
            t0 = time.perf_counter()
            summary = json.loads(run_cli(cli, submit + ["--device", "cuda"]))
            torch.cuda.synchronize()
            engine_s = time.perf_counter() - t0
            launches = {k: w.launches for k, w in wrappers.items()}
        finally:
            parquet.write_table = write_table

        store = ExperimentStore.open(base / "card")
        events = engine.RunLedger(store.workflow_dir / "ledger.jsonl").events()
        steps = ["metaconfig", "imextract", "corilla", "illuminati", "jterator"]
        done = {e["step"]: e for e in events if e["event"] == "step_done"}
        if list(summary) != steps or sorted(done) != sorted(steps):
            raise SmokeFailure(f"canonical: summary {list(summary)}, steps done {sorted(done)}")
        results = {s: [e["result"] for e in events
                       if e["event"] == "batch_done" and e["step"] == s] for s in steps}
        jt = results["jterator"]
        n_launched = len(jt) + sum(r.get("bucket_escalations", 0) for r in jt)
        expected = {k: 0 for k in wrappers}
        expected.update({"fill_holes_flood": n_launched, "cc_min_propagate": n_launched,
                         "watershed_flood": n_launched, "grouped_stats": 2 * n_launched})
        print(f"  launches {launches} over {len(jt)} jterator batches and "
              f"{n_launched - len(jt)} escalation re-launches")
        if launches != expected:
            raise SmokeFailure(f"canonical: launches {launches}, expected {expected}")
        for k, route in on_chip.items():
            taken = {r: c for r, c in wrappers[k].routes.items() if c}
            if taken != {route: launches[k]}:
                raise SmokeFailure(f"canonical: {k} routes {taken}, expected all on {route}")
        walls = {s: done[s]["elapsed"] for s in steps}
        ill = results["illuminati"]
        n_tiles = sum(r["n_tiles"] for r in ill)
        mpix = sum(int(np.prod(r["mosaic_shape"])) for r in ill) / 1e6
        stats = done["jterator"]["pipeline_stats"]
        print(f"  engine: {n} sites in {engine_s:.3f} s = {n / engine_s:.1f} sites/s end to end "
              "(CLI submit, five steps); step walls (s): "
              + ", ".join(f"{s} {walls[s]:.3f}" for s in steps) + f"; on {card}")
        print(f"    imextract: {len(files)} files in {walls['imextract']:.3f} s = "
              f"{len(files) / walls['imextract']:.1f} files/s "
              f"({mbytes / walls['imextract']:.1f} MiB/s); on {card}")
        print(f"    illuminati: mosaic {tuple(ill[0]['mosaic_shape'])} x {len(ill)} channels, "
              f"{ill[0]['n_levels']} levels, {n_tiles} tiles in {walls['illuminati']:.3f} s = "
              f"{n_tiles / walls['illuminati']:.1f} tiles/s, {mpix / walls['illuminati']:.1f} "
              f"Mpix/s of level 0; on {card}")
        print(f"    jterator: {n / walls['jterator']:.1f} sites/s; executor at depth "
              f"{stats['depth']} ({stats['source']}), totals (s): "
              + ", ".join(f"{k} {v['total_s']:.3f}" for k, v in stats["phases"].items())
              + f"; rungs routed {sorted({r['bucket_capacity'] for r in jt})}; on {card}")

        print_stages(card, illuminati_split(torch, store))

        # resume on the finished ledger: nothing re-runs, nothing launches
        before = ledger_sequence(engine, store.root)
        for w in wrappers.values():
            w.launches = 0
        resumed = json.loads(run_cli(cli, ["workflow", "resume", "--root", root,
                                           "--description", str(desc_path), "--device",
                                           "cuda"]))
        relaunched = {k: w.launches for k, w in wrappers.items() if w.launches}
        if resumed != {} or relaunched or \
                ledger_sequence(engine, store.root) != before + [("run_started", None, None)]:
            raise SmokeFailure(f"canonical: resume re-ran {resumed} / launched {relaunched}")

        # the ingested store: the generator's pixels at every site and channel
        channels = {c.name: c.index for c in store.experiment.channels}
        for ch, px in pixels.items():
            if not np.array_equal(store.read_sites(None, channel=channels[ch]), px):
                raise SmokeFailure(f"canonical: the ingested {ch} pixels differ from the files'")
        # metaconfig's artifacts against a CPU run over the same directory
        meta = ExperimentStore.create(base / "meta", Experiment(
            name="canonical", plates=[], channels=[], site_height=1, site_width=1))
        step = get_step("metaconfig")(meta, device="cpu")
        step.init({"source_dir": str(src), "sites_per_well_x": SITES_PER_WELL[1]})
        step.run(0)
        for name in ("file_mapping.json", "experiment.ome.xml"):
            if (store.workflow_dir / "metaconfig" / name).read_text() != \
                    (meta.workflow_dir / "metaconfig" / name).read_text():
                raise SmokeFailure(f"canonical: {name} differs from the CPU metaconfig's")
        # every tile against a CPU illuminati over the card's statistics
        for part in ("images", "illumstats"):
            copy_part(store.root, base / "cpu", part)
        cpu = ExperimentStore.open(base / "cpu")
        t0 = time.perf_counter()
        step = get_step("illuminati")(cpu, device="cpu")
        step.init({})
        for i in step.list_batches():
            step.run(i)
        cpu_ill_s = time.perf_counter() - t0
        tiles = sorted(p.relative_to(store.root) for p in (store.root / "pyramids").rglob("*.png"))
        if len(tiles) != n_tiles or tiles != sorted(
                p.relative_to(cpu.root) for p in (cpu.root / "pyramids").rglob("*.png")):
            raise SmokeFailure(f"canonical: {len(tiles)} card tiles, {n_tiles} reported, or "
                               "another tile set than the CPU's")
        for rel in tiles:
            got, want = png.read(store.root / rel), png.read(cpu.root / rel)
            if got.shape != (256, 256) or not np.array_equal(got, want):
                raise SmokeFailure(f"canonical: tile {rel} differs from the CPU's in "
                                   f"{int((got != want).sum())} pixels")
        for layer in sorted((store.root / "pyramids").rglob("layer.json")):
            if layer.read_text() != (cpu.root / layer.relative_to(store.root)).read_text():
                raise SmokeFailure(f"canonical: {layer.name} differs from the CPU's")
        # the static mapobject shards read back
        if sorted(shards) != [f"{t}_polygons_plate00.parquet" for t in ("Plates", "Sites",
                                                                       "Wells")]:
            raise SmokeFailure(f"canonical: static shards {sorted(shards)}")
        for name, (cols, back) in shards.items():
            for k, v in cols.items():
                same = (all(np.array_equal(a, b) for a, b in zip(back[k], v))
                        and len(back[k]) == len(v)) if v.dtype == object else \
                    back[k].tolist() == v.tolist()
                if not same:
                    raise SmokeFailure(f"canonical: {name} column {k} reads back other values")
        # jterator's batch 0 on the CPU over the card's statistics
        (cpu.root / "cp.pipe.json").write_text(json.dumps(pipe))
        capacity.reset_routing_history()
        t0 = time.perf_counter()
        step = get_step("jterator")(cpu, device="cpu")
        step.init({**args, "batch_size": CANONICAL_CPU_BATCH})
        step.run(0)
        cpu_jt_s = time.perf_counter() - t0
        sites = list(step.load_batch(0)["sites"])
        _, worst = hold_batch(store, cpu, sites, CARD_TIERS, gate=True)
        print(f"  holds: resume re-ran and launched nothing; the {n} sites x 2 channels "
              "ingested equal the files' pixels; file_mapping.json and experiment.ome.xml "
              f"equal a CPU metaconfig's; {len(tiles)} tiles and layer.json equal a CPU "
              f"illuminati's over the card's statistics ({cpu_ill_s:.2f} s); "
              f"{sum(len(cols['name']) for cols, _ in shards.values())} static mapobject rows "
              f"read back equal; jterator batch 0 on the CPU ({len(sites)} sites, "
              f"{cpu_jt_s:.2f} s): labels exact, features within CARD_TIERS, largest "
              "|card - cpu| by family " + ", ".join(f"{k} {v:.3g}"
                                                   for k, v in sorted(worst.items())))
    finally:
        shutil.rmtree(base, ignore_errors=True)


def illuminati_split(torch, store) -> dict:
    """Seconds of each part of the illuminati step's run on channel 0 of
    ``store``, timed apart in its order on the card: the stitched mosaic
    (reads, correction), its fetch and host percentiles, the levels, the
    uint8 levels fetched, the tiles cut, and their PNG encodes on the
    step's thread pool (the file writes left out)."""
    import concurrent.futures as cf

    import numpy as np

    from tmlibrary_tpu_torch.io import png
    from tmlibrary_tpu_torch.models.image import IllumstatsContainer
    from tmlibrary_tpu_torch.ops import pyramid
    from tmlibrary_tpu_torch.workflow import get_step

    step = get_step("illuminati")(store)
    args = step.batch_args.resolve({})
    stats = IllumstatsContainer.from_store(store.read_illumstats(0, 0))
    out, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    mosaic = step._mosaic(store.experiment.plates[0], 0, args, stats)
    lap("mosaic")
    host = mosaic.cpu().numpy()
    lap("fetch")
    lower, upper = np.percentile(host, [0.1, args["clip_percent"]])
    lap("percentiles")
    levels = pyramid.pyramid_levels(mosaic)
    lap("levels")
    level8 = [pyramid.to_uint8(lv, float(lower), float(upper)).cpu().numpy() for lv in levels]
    lap("uint8_fetched")
    tiles = [t for lv in level8 for t in pyramid.cut_tiles(lv).values()]
    lap("cut_tiles")
    with cf.ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(png.encode, tiles))
    lap("png_encode")
    return {k: v * 1e3 for k, v in out.items()}


def hold_batch(store, cpu, sites, tiers: dict, gate: bool) -> tuple[int, dict]:
    """The card store's rows of ``sites`` against the CPU store's: labels,
    rows (site, label, metadata) and ``Morphology_solidity`` exact; each
    float feature within its tier of ``tiers``, which fails when ``gate``
    and is otherwise counted.  Returns the values outside their tier and
    the largest |card - cpu| of each feature family."""
    import numpy as np

    outside, worst = 0, {}
    for name in ("nuclei", "cells"):
        a, b = store.read_labels(sites, name), cpu.read_labels(sites, name)
        if not np.array_equal(a, b):
            raise SmokeFailure(f"engine: {name} labels of batch 0 differ from the CPU's in "
                               f"{int((a != b).sum())} pixels")
        got, want = (rows_of_sites(s.read_features(name), sites) for s in (store, cpu))
        if list(got) != list(want):
            raise SmokeFailure(f"engine: {name} feature columns differ from the CPU's")
        for k in ("site_index", "label", "plate", "well_row", "well_col", "site_y", "site_x",
                  "Morphology_solidity"):
            if k in got and got[k].tolist() != want[k].tolist():
                raise SmokeFailure(f"engine: {name} {k} differs from the CPU's")
        for k, v in got.items():
            if v.dtype.kind != "f":
                continue
            rtol, atol = feature_tier(k, tiers)
            if gate:
                np.testing.assert_allclose(v, want[k], rtol=rtol, atol=atol,
                                           err_msg=f"engine {name}/{k}")
            else:
                outside += int((~np.isclose(v, want[k], rtol=rtol, atol=atol,
                                            equal_nan=True)).sum())
            if v.size:
                family = k.split("_")[0]
                worst[family] = max(worst.get(family, 0.0),
                                    float(np.nanmax(np.abs(v - want[k]), initial=0.0)))
    return outside, worst


def same_store(a, b, title: str) -> None:
    """Labels and feature shards of ``a`` bit for bit those of ``b``."""
    import numpy as np

    for name in ("nuclei", "cells"):
        if not np.array_equal(a.read_labels(None, name), b.read_labels(None, name)):
            raise SmokeFailure(f"steps ({title}): {name} labels differ from the cold run")
        fa, fb = (rows_of_sites(s.read_features(name), range(s.n_sites)) for s in (a, b))
        if list(fa) != list(fb) or any(not np.array_equal(fa[k], fb[k]) for k in fa):
            raise SmokeFailure(f"steps ({title}): {name} features differ from the cold run")


def copy_part(src: Path, dst: Path, part: str) -> None:
    """``src/part`` into the store at ``dst``, created from ``src``'s
    manifest when absent (the store's layout)."""
    if not (dst / "manifest.json").exists():
        dst.mkdir(parents=True, exist_ok=True)
        shutil.copy(src / "manifest.json", dst / "manifest.json")
        for sub in ("images", "illumstats", "segmentations", "features", "alignment",
                    "pyramids", "workflow", "tools"):
            (dst / sub).mkdir(exist_ok=True)
    shutil.rmtree(dst / part)
    shutil.copytree(src / part, dst / part)


def run_jterator_step(torch, get_step, store, args, wrappers) -> dict:
    """``init``, ``run_batches_pipelined`` at the default depth and
    ``collect`` of the jterator step on the card, on one clock, with every
    launch counter set to 0 just before and read just after."""
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
        if hasattr(w, "routes"):
            w.routes = dict.fromkeys(w.routes, 0)
    t0 = time.perf_counter()
    jt = get_step("jterator")(store)
    jt.init(args)
    batches = [jt.load_batch(i) for i in jt.list_batches()]
    results = [r for _, r in jt.run_batches_pipelined(batches)]
    collected = jt.collect()
    seconds = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    if jt.device.type != "cuda":
        raise SmokeFailure(f"steps: jterator runs on {jt.device}")
    return {"step": jt, "results": results, "collected": collected, "seconds": seconds,
            "launches": launches, "stats": jt.pipeline_stats,
            "per_batch": jt.pipeline_batch_times}


def print_step_run(run, n, card, chain_sps, title) -> None:
    """Sites/s of one jterator step run, the executor's phase totals, each
    batch's dispatch and device block, and the rungs routed."""
    import collections

    results, stats = run["results"], run["stats"]
    rungs = collections.Counter(r["bucket_capacity"] for r in results)
    escalations = sum(r.get("bucket_escalations", 0) for r in results)
    phases = ", ".join(f"{k} {v['total_s']:.3f}" for k, v in stats["phases"].items())
    print(f"  jterator step ({title}): {n} sites in {run['seconds']:.3f} s = "
          f"{n / run['seconds']:.1f} sites/s end to end (init + pipelined run + collect; "
          f"phase 4's in-memory chain {chain_sps:.1f} sites/s in this call) on {card}")
    print(f"    executor at depth {stats['depth']} ({stats['source']}), totals (s): {phases}; "
          f"rungs routed {dict(sorted(rungs.items()))}, escalations {escalations}")
    print("    per batch (ms) dispatch/device block: " + ", ".join(
        f"{b}: {t.get('dispatch', 0) * 1e3:.1f}/{t.get('device_block', 0) * 1e3:.1f}"
        for b, t in run["per_batch"].items()))


def sum_reads(jt) -> float:
    """Seconds of the step's store reads for every batch, timed alone."""
    t0 = time.perf_counter()
    for i in jt.list_batches():
        jt._load_inputs(jt._effective_batch(jt.load_batch(i)))
    return time.perf_counter() - t0


def syncs_in_launch(torch, jt) -> str:
    """Where one ``launch_batch`` (inputs already read) makes the host wait
    for the card (:func:`host_syncs`)."""
    batch = jt._effective_batch(jt.load_batch(0))
    inputs = jt._load_inputs(batch)
    launched = []
    report = host_syncs(torch, lambda: launched.append(jt.launch_batch(batch, inputs)))
    jt.block_batch(launched[0][1])
    return report


def hold_steps_on_cpu(torch, store, base, pipe, args, card) -> None:
    """The CPU hold: corilla and align with ``device="cpu"`` over a copy of
    the card store's images (statistics by :data:`STATS_TIERS`, ``n`` and
    percentiles exact; shifts and window exact), then, over the card's
    statistics and shifts, jterator batches :data:`CPU_BATCHES` on the CPU
    (``Step.run``): their sites' labels equal the card's and their feature
    rows hold by :data:`CARD_TIERS`, site by site (the card's
    routing history may pack the CPU's batches differently)."""
    import numpy as np

    from tmlibrary_tpu_torch.models.store import ExperimentStore
    from tmlibrary_tpu_torch.workflow import get_step

    copy_part(store.root, base / "cpu", "images")
    cpu = ExperimentStore.open(base / "cpu")
    (cpu.root / "cp.pipe.json").write_text(json.dumps(pipe))
    t0 = time.perf_counter()
    corilla = get_step("corilla")(cpu, device="cpu")
    corilla.init({})
    for i in corilla.list_batches():
        corilla.run(i)
    align = get_step("align")(cpu, device="cpu")
    align.init({"ref_cycle": 0, "batch_size": STEP_BATCH})
    for i in align.list_batches():
        align.run(i)
    cpu_window = align.collect()["window"]
    prep_s = time.perf_counter() - t0
    errs = {}
    for cycle in range(2):
        for ch in range(2):
            got, want = store.read_illumstats(cycle, ch), cpu.read_illumstats(cycle, ch)
            if list(got) != list(want):
                raise SmokeFailure(f"steps: illumstats fields {list(got)} vs {list(want)}")
            for k in ("n", "percentile_keys", "percentile_values"):
                hold_tier(f"steps.corilla[{cycle},{ch}].{k}", torch.from_numpy(got[k]),
                          torch.from_numpy(want[k]), _EXACT)
            for k, tier in STATS_TIERS.items():
                errs[k] = max(errs.get(k, 0.0), hold_tier(
                    f"steps.corilla[{cycle},{ch}].{k}", torch.from_numpy(got[k]),
                    torch.from_numpy(want[k]), tier))
    if not np.array_equal(store.read_shifts(1), cpu.read_shifts(1)) or \
            cpu_window != store.read_intersection():
        raise SmokeFailure("steps: the CPU's shifts or window differ from the card's")

    for part in ("illumstats", "alignment"):
        copy_part(store.root, cpu.root, part)
    t0 = time.perf_counter()
    jt = get_step("jterator")(cpu, device="cpu")
    jt.init(args)
    sites = []
    for i in CPU_BATCHES:
        jt.run(i)
        sites += list(jt.load_batch(i)["sites"])
    cpu_s = time.perf_counter() - t0
    worst = {}
    for name in ("nuclei", "cells"):
        if not np.array_equal(cpu.read_labels(sites, name), store.read_labels(sites, name)):
            raise SmokeFailure(f"steps: the CPU's {name} labels differ from the card's")
        got, want = (rows_of_sites(s.read_features(name), sites) for s in (store, cpu))
        if list(got) != list(want):
            raise SmokeFailure(f"steps: {name} feature columns differ")
        for k in ("site_index", "label", "well_row", "well_col", "site_y", "site_x"):
            if not np.array_equal(got[k], want[k]):
                raise SmokeFailure(f"steps: {name} rows differ in {k}")
        for k, v in got.items():
            if v.dtype.kind != "f":
                continue
            rtol, atol = feature_tier(k, CARD_TIERS)
            np.testing.assert_allclose(v, want[k], rtol=rtol, atol=atol, err_msg=f"{name}/{k}")
            if v.size:
                worst[k] = max(worst.get(k, 0.0), float(np.abs(v - want[k]).max()))
    print(f"  CPU hold: corilla and align on the CPU in {prep_s:.2f} s: n, percentiles exact, "
          "largest |card - cpu| " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f"; shifts and window exact; jterator batches {list(CPU_BATCHES)} on the CPU "
          f"({len(sites)} sites, {cpu_s:.2f} s) over the card's statistics and shifts: labels "
          "equal, features within CARD_TIERS, largest |card - cpu| "
          + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items())))


def rows_of_sites(table: dict, sites) -> dict:
    """The feature rows of ``sites``, ordered by (site_index, label)."""
    import numpy as np

    keep = np.isin(table["site_index"], np.asarray(sites))
    order = np.lexsort((table["label"][keep], table["site_index"][keep]))
    return {k: v[keep][order] for k, v in table.items()}


def feature_tier(name: str, tiers: dict = FEATURE_TIERS) -> tuple[float, float]:
    """The tolerance of a feature in ``tiers``; a name the table does not
    cover (or covers twice) raises ``KeyError``."""
    hits = [tier for pat, tier in tiers.items()
            if fnmatch.fnmatchcase(name, pat) or fnmatch.fnmatchcase(name, pat + "_*")]
    if len(hits) != 1:
        raise KeyError(f"feature '{name}' has {len(hits)} tolerance tiers")
    return hits[0]


# ------------------------------------------------------------ the DL paths
#: the ``dl`` configuration's decoder settings (bench.py:851-860)
DL_WEIGHTS, DL_THRESHOLD, DL_MIN_AREA = "seed:0", 0.6, 4


def dl_labels(nn, head, prob, names) -> dict:
    """The labels a ``(B, 3, H, W)`` head and its probabilities give
    through the port's decoder: the primary objects under ``names[0]``,
    the secondary ones (when two names) under ``names[1]``."""
    primary, _ = nn.decode_flows(head[:, :2], prob, prob_threshold=DL_THRESHOLD,
                                 min_area=DL_MIN_AREA, max_objects=MAX_OBJECTS)
    out = {names[0]: primary}
    if len(names) > 1:
        out[names[1]] = nn.decode_secondary(primary, prob, DL_THRESHOLD,
                                            max_objects=MAX_OBJECTS)[0]
    return out


def hold_dl(torch, nn, modules, images, card_objects, cpu_objects) -> tuple[list, dict]:
    """The boundary rule between the card's and the CPU's DL labels of the
    same ``(B, H, W)`` card images: both heads (the U-Net on each device)
    within :data:`HEAD_TIER` and every flipped decision within the tier
    of its boundary (:func:`dl_flips`); each side's head, decoded on the
    CPU, gives that side's labels (``card_objects``, ``cpu_objects``:
    ``{name: (B, H, W) numpy}``).  Returns the sites whose labels are
    equal on both sides and the flips."""
    import numpy as np

    names = list(cpu_objects)
    sides = {}
    for side, x in (("card", images), ("cpu", images.cpu())):
        head = modules._dl_head(x, DL_WEIGHTS).cpu()
        sides[side] = {"head": head, "prob": torch.sigmoid(head[:, 2])}
    flips = dl_flips({k: v.numpy() for k, v in sides["cpu"].items()},
                     {k: v.numpy() for k, v in sides["card"].items()}, DL_THRESHOLD)
    exact = np.ones(images.shape[0], bool)
    for side, objects in (("card", card_objects), ("cpu", cpu_objects)):
        decoded = dl_labels(nn, sides[side]["head"], sides[side]["prob"], names)
        for name in names:
            if not np.array_equal(decoded[name].numpy(), objects[name]):
                raise SmokeFailure(f"dl: the {side}'s {name} labels are not its head's")
    for name in names:
        exact &= (card_objects[name] == cpu_objects[name]).reshape(len(exact), -1).all(axis=1)
    return list(np.flatnonzero(exact)), flips


def dl_stages(torch, nn, measure, dapi, names) -> dict:
    """CUDA-event time of each stage of a DL batch at its shapes, run one
    by one."""
    net, _ = nn.unet_for(DL_WEIGHTS, dapi.device)
    norm = nn.normalize_image(dapi)
    head = net(norm[:, None])
    prob = torch.sigmoid(head[:, 2])
    mask = prob >= torch.tensor(DL_THRESHOLD, device=dapi.device)
    yy, xx = nn.follow_flows(head[:, :2])
    flat = nn.decode.sink_labels(mask, yy, xx)
    labels = nn.decode.compact_labels(flat, DL_MIN_AREA, MAX_OBJECTS).reshape(dapi.shape)
    steps = {
        "normalize": lambda: nn.normalize_image(dapi),
        "unet": lambda: net(norm[:, None]),
        "sigmoid_follow": lambda: (torch.sigmoid(head[:, 2]), nn.follow_flows(head[:, :2])),
        "hits_labeling": lambda: nn.decode.sink_labels(mask, yy, xx),
        "compact_clip": lambda: nn.decode.compact_labels(flat, DL_MIN_AREA, MAX_OBJECTS),
    }
    if len(names) > 1:
        steps["secondary"] = lambda: nn.decode_secondary(labels, prob, DL_THRESHOLD,
                                                         max_objects=MAX_OBJECTS)
    steps["measure"] = lambda: [measure.intensity_features(labels, dapi, MAX_OBJECTS)
                                for _ in names]
    return {name: cuda_ms(torch, fn, 5) for name, fn in steps.items()}


def host_syncs(torch, call) -> str:
    """Where ``call()`` makes the host wait for the card, as PyTorch's sync
    debug mode reports it: for each report inside the port, its innermost
    line on the stack, with their counts."""
    import collections
    import traceback
    import warnings

    root = Path(__file__).resolve().parent
    package = root / "tmlibrary_tpu_torch"
    where = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message).lower():
            return
        port = [f for f in traceback.extract_stack()
                if Path(f.filename).resolve().is_relative_to(package)]
        if port:  # the innermost line of the port: the op that waited
            where[f"{Path(port[-1].filename).resolve().relative_to(root)}:"
                  f"{port[-1].lineno}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return (", ".join(f"{k} x{v}" for k, v in sorted(where.items()))
            or "none reported") + f" ({sum(where.values())} in all)"


def drive_dl_path(torch, pkg, title, desc, data, wrappers, expect, card, bw) -> dict:
    """Phase 3's DL paths, (g) ``dl`` and (h) its primary + secondary form,
    through ``build_batch_fn`` on the card: a warm-up call, every launch
    counter set to 0, one call, the counters read (exactly ``expect``,
    nothing else; the watershed, where launched, on chip for every site);
    the kernels of the path held against their plain versions at its
    shapes (the seed labeling, the one-level flood against
    ``propagate_labels``, ``grouped_stats``); the first sites held to the
    port's CPU run by the boundary rule (:func:`hold_dl`), their
    features by ``CARD_TIERS`` where the labels agree; the heads
    bit-identical at batch 64, 8 and 1 and the labels at batch 8; then
    the host syncs of one batch, sites/s over 5 calls, the stage split
    and the U-Net's rates."""
    import numpy as np

    pipeline, nn, modules, label, kernels, fused_measure, measure, segment_secondary = (
        pkg[k] for k in ("pipeline", "nn", "modules", "label", "kernels", "fused_measure",
                         "measure", "segment_secondary"))
    n = next(iter(data.values())).shape[0]
    raw, stats, shifts = pipeline.from_jax_inputs(data, {}, [[0, 0]] * n, device="cuda")
    fn = pipeline.ImageAnalysisPipeline(desc, MAX_OBJECTS, device="cuda").build_batch_fn()
    fn(raw, stats, shifts)  # warm-up: allocator, cuDNN handles, first launches
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
    print(f"phase 3, {title}: launches {launches}")
    want_launches = {k: 0 for k in wrappers}
    want_launches.update(expect)
    if launches != want_launches:
        raise SmokeFailure(f"{title}: launches {launches}, expected {want_launches}")
    if launches["watershed_flood"]:
        site = wrappers["watershed_flood"].site_routes
        if wrappers["watershed_flood"].routes != {"onchip": launches["watershed_flood"],
                                                  "global": 0} or bool((site != 0).any()):
            raise SmokeFailure(f"{title}: watershed_flood off chip")
    card_res = pipeline.site_result_to_numpy(result)
    names = list(card_res.objects)
    dapi = raw["DAPI"].to(torch.float32)

    # the path's kernels against their plain versions at its shapes (not counted)
    net, _ = nn.unet_for(DL_WEIGHTS, dapi.device)
    head = net(nn.normalize_image(dapi)[:, None])
    prob = torch.sigmoid(head[:, 2])
    mask = prob >= torch.tensor(DL_THRESHOLD, device=dapi.device)
    seed_mask, _ = nn.decode.seed_mask(mask, *nn.follow_flows(head[:, :2]))
    holds = {"cc_min_propagate": (kernels.cc_min_propagate(seed_mask),
                                  kernels.cc_min_propagate_plain(seed_mask))}
    primary = result.objects[names[0]]
    if len(names) > 1:
        grow = mask | (primary > 0)
        holds["watershed_flood"] = (
            kernels.watershed_flood(torch.zeros_like(dapi), primary, grow, n_levels=1),
            segment_secondary.propagate_labels(primary, grow))
    holds["grouped_stats"] = (
        torch.stack(fused_measure.grouped_stats(primary, [dapi], MAX_OBJECTS)),
        torch.stack(fused_measure.grouped_stats_plain(primary, [dapi], MAX_OBJECTS)))
    for k, (got, want) in holds.items():
        if not torch.equal(got, want):
            raise SmokeFailure(f"{title}: {k} differs from its plain version on the path's "
                               "inputs")
    seeds_per_site = kernels.cc_min_propagate(seed_mask)
    print(f"  kernels at the path's shapes equal their plain versions: "
          + ", ".join(holds) + f" (seed pixels {int(seed_mask.sum())}, "
          f"seed components {int(label.compact_roots(seed_mask, seeds_per_site)[1].sum())})")

    # the first sites against the port's CPU run, by the boundary rule
    sub = {k: v[:N_CPU_SITES] for k, v in data.items()}
    craw, cstats, cshifts = pipeline.from_jax_inputs(sub, {}, [[0, 0]] * N_CPU_SITES,
                                                     device="cpu")
    cpu_res = pipeline.site_result_to_numpy(
        pipeline.ImageAnalysisPipeline(desc, MAX_OBJECTS, device="cpu")
        .build_batch_fn()(craw, cstats, cshifts))
    exact, flips = hold_dl(torch, nn, modules, dapi[:N_CPU_SITES],
                           {k: v[:N_CPU_SITES] for k, v in card_res.objects.items()},
                           cpu_res.objects)
    worst = compare_with_cpu(card_res, cpu_res, sites=exact)
    print(f"  cpu check: {len(exact)} of {N_CPU_SITES} sites exact (labels, counts, features "
          f"by CARD_TIERS); head {flips['max_rel_err']:.3g} of max|head| (HEAD_TIER "
          f"{HEAD_TIER}); {flips['sign_flips']} flow signs and {flips['mask_flips']} mask "
          "pixels flipped, each within the tier of its boundary; largest |card - cpu| "
          + ", ".join(f"{k} {d:.3g} ({f})" for k, (d, f) in sorted(worst.items())))

    # batch invariance: the same sites' heads at batch 64, 8 and 1
    h64 = modules._dl_head(dapi, DL_WEIGHTS)
    h8 = modules._dl_head(dapi[:8], DL_WEIGHTS)
    h1 = modules._dl_head(dapi[5:6], DL_WEIGHTS)
    r8 = fn({k: v[:8] for k, v in raw.items()}, stats, shifts[:8])
    if not (torch.equal(h8, h64[:8]) and torch.equal(h1, h64[5:6])):
        raise SmokeFailure(f"{title}: the head depends on the batch size")
    for name in names:
        if not torch.equal(r8.objects[name], result.objects[name][:8]):
            raise SmokeFailure(f"{title}: {name} labels depend on the batch size")
    print("  batch invariance: heads of sites 0-7 and 5 bit-identical at batch 64, 8 and 1; "
          "labels at batch 8 equal batch 64's")

    print(f"  host syncs of one batch: {host_syncs(torch, lambda: fn(raw, stats, shifts))}")
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(raw, stats, shifts)
    torch.cuda.synchronize()
    batch_s = (time.perf_counter() - t0) / reps
    print(f"  pipeline: {n / batch_s:.1f} sites/s ({batch_s * 1e3:.2f} ms per batch of {n}; "
          f"main-path run {main_s * 1e3:.2f} ms) on {card}")
    print("  counts: " + " ".join(f"{obj} {c[:N_CPU_SITES].tolist()}"
                                  for obj, c in card_res.counts.items()))
    stages = dl_stages(torch, nn, measure, dapi, names)
    print_stages(card, stages)
    cfg = nn.resolve_weights(DL_WEIGHTS)[2]
    flops = n * nn.unet_flops(cfg, SIZE, SIZE)
    io = n * nn.unet_io_bytes(cfg, SIZE, SIZE)
    bound_ms = max(flops / FP32_OPS_PER_S, io / bw) * 1e3
    print(f"  unet: {flops / 1e9:.2f} GFLOP and {io / 1e6:.2f} MB (unet_flops, unet_io_bytes) "
          f"a batch in {stages['unet']:.3f} ms = {flops / stages['unet'] / 1e6:.1f} GFLOP/s "
          f"({flops / stages['unet'] / 1e6 / (FP32_OPS_PER_S / 1e9):.1%} of the float32 "
          f"peak {FP32_OPS_PER_S / 1e12:.0f} TFLOP/s; bound {bound_ms:.3f} ms) on {card}")
    return {"launches": launches, "counts": card_res.counts, "sites_per_s": n / batch_s,
            "exact_sites": len(exact)}


def phase_qc_session(torch, wrappers, card) -> None:
    """Phase 8, ``workflow_engine_qc_p96x4_256``: the QC session on the card.
    Phase 5's plate (384 sites of 256x256, DAPI and Actin, 2 cycles,
    cycle 1 rolled within +-40) written under ``build/``; a JSON
    description of corilla -> align (ref_cycle 0) -> jterator (path (h):
    ``segment_dl_primary`` -> ``segment_dl_secondary`` -> ``measure_intensity``
    on both, DAPI corrected and aligned, from a ``.pipe.json``; cycle 1,
    batches of 64, ``max_objects=256``) by ``workflow submit --device cuda
    --qc`` in this process, launch counters set to 0 just before and read
    just after, and ``--no-qc``, in turns off, on, on, off, each on a
    fresh root.  Holds: the stores
    bit-identical with QC on and off; ``qc.json`` written (and nothing
    with QC off) with the ``__model__`` streams at 64 samples a stream a
    site; one ``qc_batch`` event a batch; batch 0 on the CPU over the
    card's statistics and shifts: labels by the boundary rule, its QC
    summary's counts exact and its floats within their tiers; the ``qc``
    verb's exit code against the CPU's profile is ``compare_profiles``'.
    The directory is removed at the end."""
    import numpy as np

    from tmlibrary_tpu_torch import benchmarks, capacity, cli, nn, qc
    from tmlibrary_tpu_torch.jterator import modules
    from tmlibrary_tpu_torch.jterator.description import PipelineDescription
    from tmlibrary_tpu_torch.jterator.pipeline import ImageAnalysisPipeline
    from tmlibrary_tpu_torch.models.experiment import grid_experiment
    from tmlibrary_tpu_torch.models.store import ExperimentStore
    from tmlibrary_tpu_torch.workflow import engine, get_step

    base = Path(__file__).resolve().parent / "build" / f"phase8.{os.getpid()}"
    shutil.rmtree(base, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        exp = grid_experiment("phase8", well_rows=PLATE[0], well_cols=PLATE[1],
                              sites_per_well=SITES_PER_WELL, channel_names=("DAPI", "Actin"),
                              site_shape=(SIZE, SIZE), n_cycles=2)
        n = exp.n_sites
        data = benchmarks.synthetic_cell_painting_batch(n, size=SIZE, seed=SEED)
        drift = np.random.default_rng(SEED + 8).integers(-MAX_DRIFT, MAX_DRIFT + 1, (n, 2))
        store = ExperimentStore.create(base / "card", exp)
        for c, ch in enumerate(("DAPI", "Actin")):
            px = data[ch].astype(np.uint16)
            store.write_sites(px, list(range(n)), cycle=0, channel=c)
            store.write_sites(np.stack([np.roll(s, tuple(d), axis=(0, 1))
                                        for s, d in zip(px, drift)]),
                              list(range(n)), cycle=1, channel=c)
        del data
        pipe = benchmarks.dl_secondary_pipe(DL_WEIGHTS, DL_THRESHOLD, DL_MIN_AREA,
                                            correct=True, align=True)
        (store.root / "dl.pipe.json").write_text(json.dumps(pipe))
        args = {"pipe": "dl.pipe.json", "cycle": 1, "batch_size": STEP_BATCH,
                "max_objects": MAX_OBJECTS}
        desc_path = base / "workflow.json"
        engine.WorkflowDescription.canonical({
            "corilla": {}, "align": {"ref_cycle": 0, "batch_size": STEP_BATCH},
            "jterator": args}).save(desc_path)
        for name in ("off1", "on1", "off"):
            copy_part(store.root, base / name, "images")
            shutil.copy(store.root / "dl.pipe.json", base / name / "dl.pipe.json")
        print(f"phase 8, workflow_engine_qc_p96x4_256: corilla -> align -> jterator (path (h), "
              f"DAPI corrected and aligned) through `workflow submit --device cuda --qc` over "
              f"{n} sites ({PLATE[0]}x{PLATE[1]} wells at {SITES_PER_WELL[0]}x"
              f"{SITES_PER_WELL[1]} sites of {SIZE}x{SIZE}, 2 cycles; written in "
              f"{time.perf_counter() - t0:.2f} s), in turns with --no-qc; on {card}")

        # in turns (off, on, on, off), each on a fresh root (a second submit
        # on a root would plan its batches from the first run's counts)
        walls = {"qc": [], "no-qc": []}
        for mode, root in (("no-qc", base / "off1"), ("qc", base / "on1"), ("qc", store.root),
                           ("no-qc", base / "off")):
            capacity.reset_routing_history()
            qc.reset_session()
            torch.cuda.synchronize()
            for w in wrappers.values():
                w.launches = 0
            t0 = time.perf_counter()
            run_cli(cli, ["workflow", "submit", "--root", str(root), "--description",
                          str(desc_path), "--device", "cuda", f"--{mode}"])
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t0)
            launches = {k: w.launches for k, w in wrappers.items()}
            events = engine.RunLedger(Path(root) / "workflow" / "ledger.jsonl").events()
            results = [e["result"] for e in events
                       if e["event"] == "batch_done" and e["step"] == "jterator"]
            n_launched = len(results) + sum(r.get("bucket_escalations", 0) for r in results)
            expected = {k: 0 for k in wrappers}
            expected.update({"cc_min_propagate": n_launched, "watershed_flood": n_launched,
                             "grouped_stats": 2 * n_launched})
            if launches != expected:
                raise SmokeFailure(f"qc ({mode}): launches {launches}, expected {expected}")
            if mode == "qc":
                on_events, on_results = events, results
        qc_events = [e for e in on_events if e["event"] == "qc_batch"]
        if [e["batch"] for e in qc_events] != list(range(len(on_results))):
            raise SmokeFailure(f"qc: qc_batch events for batches "
                               f"{[e['batch'] for e in qc_events]}")
        on_seq = ledger_sequence(engine, store.root)
        off_seq = ledger_sequence(engine, base / "off")
        if off_seq != [e for e in on_seq if e[0] not in ("qc_batch", "qc_site",
                                                          "qc_budget_exceeded")]:
            raise SmokeFailure("qc: the --no-qc ledger is not the --qc ledger less its qc events")
        off = ExperimentStore.open(base / "off")
        same_store(store, off, "qc on and off")
        same_store(ExperimentStore.open(base / "on1"), ExperimentStore.open(base / "off1"),
                   "qc on and off")
        if list((base / "off" / "workflow").glob("qc*.json")):
            raise SmokeFailure("qc: --no-qc wrote a QC profile")
        profile = qc.load_profile(store.workflow_dir / "qc.json")
        if profile is None or profile != qc.load_profile(qc.profile_path(store.workflow_dir)):
            raise SmokeFailure("qc: qc.json missing or unlike qc.host0.json")
        model = {k: v for k, v in profile["features"].items() if k.startswith("__model__.")}
        if sorted(model) != ["__model__.cell_prob", "__model__.cell_prob_secondary",
                             "__model__.flow_mag"] or \
                any(v["count"] != 64 * n or v["nan"] or v["inf"] for v in model.values()):
            raise SmokeFailure(f"qc: model streams {model}")
        if profile["steps"]["jterator"]["sites"] != n or \
                sorted(profile["illumination"]) != ["Actin", "DAPI"]:
            raise SmokeFailure(f"qc: profile steps {profile['steps']}, illumination "
                               f"{sorted(profile['illumination'])}")
        flagged = sum(1 for e in on_events if e["event"] == "qc_site")
        on_s, off_s = (sum(walls[m]) / len(walls[m]) for m in ("qc", "no-qc"))
        print(f"  engine, {n} sites a run in turns off, on, on, off: QC off "
              + ", ".join(f"{t:.3f}" for t in walls["no-qc"]) + " s, QC on "
              + ", ".join(f"{t:.3f}" for t in walls["qc"])
              + f" s; means {n / on_s:.1f} sites/s with QC on, {n / off_s:.1f} with QC off "
              f"({on_s / off_s - 1:+.1%}); {len(on_results)} jterator batches, "
              f"{len(qc_events)} qc_batch events, {flagged} qc_site events; stores bit-identical "
              f"with QC on and off; qc.json: {len(profile['features'])} feature sketches, "
              "model streams " + ", ".join(f"{k.split('.', 1)[1]} n {v['count']} p50 "
                                           f"{v['p50']:.4g} p95 {v['p95']:.4g}"
                                           for k, v in sorted(model.items())) + f"; on {card}")

        # batch 0 on the CPU over the card's statistics and shifts, QC on
        for part in ("images", "illumstats", "alignment"):
            copy_part(store.root, base / "cpu", part)
        shutil.copy(store.root / "dl.pipe.json", base / "cpu" / "dl.pipe.json")
        cpu = ExperimentStore.open(base / "cpu")
        capacity.reset_routing_history()
        qc.reset_session()
        t0 = time.perf_counter()
        jt = get_step("jterator")(cpu, device="cpu", qc=True)
        jt.init(args)
        batch = jt.load_batch(0)
        sites = json.loads((store.workflow_dir / "jterator" / "batch_000.json").read_text())[
            "sites"]
        if batch["sites"] != sites:
            raise SmokeFailure("qc: the CPU's batch 0 holds other sites than the card's")
        cpu_summary = jt.run(0)["qc"]
        cpu_s = time.perf_counter() - t0
        cpu_profile = qc.get_session(True).snapshot()
        qc.reset_session()

        # labels of batch 0 by the boundary rule, on the card's corrected images
        desc = PipelineDescription.from_dict(pipe)
        card_jt = get_step("jterator")(store, device="cuda")
        inputs = card_jt._load_inputs(card_jt._effective_batch(card_jt.load_batch(0)))
        window = store.read_intersection()
        window = (window["top"], window["bottom"], window["left"], window["right"])
        images = ImageAnalysisPipeline(desc, MAX_OBJECTS, device="cuda").build_preprocess_fn(
            None if window == (0, 0, 0, 0) else window)(
            {k: torch.from_numpy(v).cuda() for k, v in inputs["raw"].items()},
            {k: tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in pair)
             for k, pair in inputs["stats"].items()},
            torch.from_numpy(np.ascontiguousarray(inputs["shifts"], np.int32)).cuda())["DAPI"]
        top, left = (window[0], window[2])
        h, w = images.shape[-2:]
        crop = {name: store.read_labels(sites, name)[:, top:top + h, left:left + w]
                for name in ("nuclei", "cells")}
        cpu_crop = {name: cpu.read_labels(sites, name)[:, top:top + h, left:left + w]
                    for name in ("nuclei", "cells")}
        exact, flips = hold_dl(torch, nn, modules, images, crop, cpu_crop)
        card_summary = qc_events[0]["summary"]
        counts_exact = len(exact) == len(sites)
        for k in ("nan_columns", "nan_values", "inf_values", "capacity_saturated"):
            if card_summary[k] != cpu_summary[k]:
                raise SmokeFailure(f"qc: batch 0's {k} {card_summary[k]} on the card, "
                                   f"{cpu_summary[k]} on the CPU")
        if counts_exact and (card_summary["count_z_max"] != cpu_summary["count_z_max"] or
                             card_summary["flagged_total"] != cpu_summary["flagged_total"]):
            raise SmokeFailure("qc: batch 0's count statistics differ from the CPU's")
        worst = 0.0
        for ch, entry in cpu_summary["channels"].items():
            for k, v in entry.items():
                tier = {"focus_min": QC_TIERS["focus_tenengrad"],
                        "saturation_max": QC_TIERS["saturation_frac"],
                        "background_mean": QC_TIERS["background"]}[k]
                got = card_summary["channels"][ch][k]
                worst = max(worst, abs(got - v) / max(abs(v), 1e-30))
                if not np.isclose(got, v, rtol=tier[0], atol=tier[1]):
                    raise SmokeFailure(f"qc: batch 0's {ch} {k} {got} on the card, {v} on "
                                       "the CPU")
        cpu_path = base / "cpu_qc.json"
        qc.write_profile(cpu_path, cpu_profile)
        verdicts = {}
        for kind in ("run", "model"):
            rc, out = run_cli_rc(cli, ["qc", "--root", str(store.root), "--json", "--reference",
                                       str(cpu_path), "--profile-kind", kind])
            verdict = json.loads(out)["verdict"]
            want = qc.compare_profiles(qc.filter_profile_kind(profile, kind),
                                       qc.filter_profile_kind(cpu_profile, kind))
            if rc != verdict["exit_code"] or rc != want["exit_code"]:
                raise SmokeFailure(f"qc: `qc --profile-kind {kind}` exited {rc}, "
                                   f"compare_profiles gives {want['exit_code']}")
            verdicts[kind] = (rc, verdict["status"], verdict["checked"], len(verdict["drifted"]))
        print(f"  CPU hold: batch 0 ({len(sites)} sites) on the CPU over the card's statistics "
              f"and shifts in {cpu_s:.2f} s: {len(exact)} of {len(sites)} sites' labels exact, "
              f"the rest by the boundary rule (head {flips['max_rel_err']:.3g} of max|head|, "
              f"{flips['sign_flips']} flow signs and {flips['mask_flips']} mask pixels flipped); "
              f"QC summary: NaN columns and saturation exact, count z max and flags "
              f"{'exact' if counts_exact else 'not held (labels differ)'}, image statistics "
              f"within QC_TIERS (largest relative difference {worst:.3g})")
        print("  `tmx-torch qc --json` against the CPU's batch-0 profile: " + ", ".join(
            f"{kind} exit {rc} ({status}, {checked} checked, {drifted} drifted)"
            for kind, (rc, status, checked, drifted) in verdicts.items())
              + " = compare_profiles'")
    finally:
        os.environ.pop("TMX_QC", None)
        shutil.rmtree(base, ignore_errors=True)


# --------------------------------------------------- the spot-counting path
#: path (i): smFISH z-stacks of 8 planes beside config 3's DAPI and Actin
FISH_DEPTH = 8
#: detect_blobs' LoG threshold on path (i), set once from the data: the
#: largest response of a spot-free site (the noise of 8 planes, max
#: projected and bilateral-smoothed) is 8.5, the peak of the faintest
#: isolated spot about 260 (peak 600, sd 1.5 px, 0.5 plane off)
SPOT_THRESHOLD = 150.0
#: detect_blobs' scales on path (i)
SPOT_SIGMAS = (1.5, 3.0, 3)
#: kernel launches of one batch of path (i): the labeling in
#: segment_primary and in detect_blobs; grouped_stats in filter's
#: morphology, twice in measure_point_pattern, in measure_intensity
SPOTS_LAUNCHES = {"fill_holes_flood": 1, "cc_min_propagate": 2, "watershed_flood": 1,
                  "grouped_stats": 4}


def spot_response_tier(sigma_max: float, images, bilateral: bool) -> "list[float]":
    """Per site, how far two implementations' multi-scale LoG responses
    (``ops.blobs``) may lie apart: ``LOG_TIER * sigma_max**2 * max|image|``
    from the gaussian's taps, plus ``8 * BILATERAL_TIER`` of the same
    where the LoG's input is a bilateral filter's output (the gaussian
    keeps a difference's bound, the 5-point stencil's weights sum to 8 in
    magnitude).  ``images``: ``(B, H, W)`` numpy, the bilateral's input
    where ``bilateral``, else the LoG's."""
    import numpy as np

    scale = np.abs(np.asarray(images, np.float64)).reshape(len(images), -1).max(axis=1)
    tier = LOG_TIER + (8 * BILATERAL_TIER if bilateral else 0.0)
    return [float(v) for v in tier * sigma_max ** 2 * scale]


def blob_flips(torch, want: dict, got: dict, threshold: float, tol, min_distance: int) -> dict:
    """The boundary rule for ``detect_blobs``.  ``want``/``got``:
    ``{"response", "blobs", "centers"}`` ``(B, H, W)`` tensors of the same
    sites from two implementations (the multi-scale LoG response, the
    labels, the centres); ``tol`` the ``(B,)`` response tier
    (:func:`spot_response_tier`).  The responses must lie within it.  A
    pixel may change sides of the threshold only where ``want``'s
    response lies within ``tol`` of it; a pixel may change its peak
    decision (``local_maxima``' ``>=`` test and scan-order tie-break)
    only where a mask pixel flipped or, within its window, two pixels
    lie within ``2 * tol`` of each other.  A site with no flipped mask
    pixel must have equal labels, and equal centres where no peak
    flipped.  Raises :class:`SmokeFailure` otherwise; returns the largest
    response difference relative to its tier, the flips counted and the
    sites whose labels are equal."""
    F = torch.nn.functional
    wr, gr = want["response"].double(), got["response"].double()
    b = wr.shape[0]
    t = torch.as_tensor(tol, dtype=torch.float64).reshape(b, 1, 1)
    err = (gr - wr).abs().reshape(b, -1).amax(dim=1)
    if (err > t.reshape(b)).any():
        raise SmokeFailure(f"detect_blobs responses beyond their tier: "
                           f"{float((err / t.reshape(b)).max()):.3g} of it")
    mask_flip = (wr > threshold) != (gr > threshold)
    bad_mask = mask_flip & ((wr - threshold).abs() > t)
    d = int(min_distance)
    ambiguous = torch.zeros_like(mask_flip)
    h, w = wr.shape[-2:]
    padded = F.pad(wr, (d, d, d, d), value=float("nan"))
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            if dy or dx:
                other = padded[:, d + dy : d + dy + h, d + dx : d + dx + w]
                ambiguous |= (other - wr).abs() <= 2 * t
    window = 2 * d + 1
    near = F.max_pool2d((ambiguous | mask_flip).double()[:, None], window, stride=1,
                        padding=d)[:, 0] > 0
    peak_flip = (want["centers"] > 0) != (got["centers"] > 0)
    bad_peak = peak_flip & ~near
    if bad_mask.any() or bad_peak.any():
        raise SmokeFailure(f"detect_blobs decisions flipped away from a boundary: "
                           f"{int(bad_mask.sum())} mask pixels, {int(bad_peak.sum())} peaks")
    exact = []
    for s in range(b):
        if not bool(mask_flip[s].any()):
            if not torch.equal(want["blobs"][s], got["blobs"][s]):
                raise SmokeFailure(f"detect_blobs: site {s} labels differ on equal masks")
            if not bool(peak_flip[s].any()) and not torch.equal(want["centers"][s],
                                                                got["centers"][s]):
                raise SmokeFailure(f"detect_blobs: site {s} centres differ on equal peaks")
            exact.append(s)
    return {"max_tier_share": float((err / t.reshape(b)).max()),
            "mask_flips": int(mask_flip.sum()), "peak_flips": int(peak_flip.sum()),
            "exact_sites": exact}


def cell_centres(n_sites: int, size: int, n_cells: int = 12, seed: int = SEED) -> list:
    """The cell centres ``(ys, xs)`` and cell radii that
    ``benchmarks.synthetic_cell_painting_batch(n_sites, size, n_cells,
    seed)`` draws, one triple a site: its random sequence replayed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rng.normal(300.0, 25.0, (n_sites, size, size))  # the DAPI noise
    rng.normal(300.0, 25.0, (n_sites, size, size))  # the Actin noise
    margin = size // 10
    out = []
    for _ in range(n_sites):
        ys = rng.integers(margin, size - margin, n_cells)
        xs = rng.integers(margin, size - margin, n_cells)
        radii = []
        for _ in range(n_cells):
            r_n = rng.uniform(3.5, 5.5)
            radii.append(r_n * rng.uniform(2.0, 3.0))
        out.append((ys, xs, np.array(radii)))
    return out


def synthetic_fish_batch(n_sites: int, size: int = SIZE, depth: int = FISH_DEPTH,
                         seed: int = SEED, n_cells: int = 12):
    """``(B, Z, H, W)`` float32 smFISH z-stacks for the sites of
    ``synthetic_cell_painting_batch(n_sites, size, n_cells, seed)``:
    noise around 300 (sd 25) and 60-180 Gaussian spots a site (sd 1-1.5
    px in y and x, 1 plane in z, peak 600-3000), each placed uniformly in
    the disk of one of the site's cells (its centre and cell radius), so
    most fall inside cells; clipped to the uint16 range."""
    import numpy as np

    rng = np.random.default_rng([seed, depth])
    out = rng.normal(300.0, 25.0, (n_sites, depth, size, size)).astype(np.float32)
    zz = np.arange(depth, dtype=np.float64)[:, None, None]
    reach = 5
    for s, (ys, xs, radii) in enumerate(cell_centres(n_sites, size, n_cells, seed)):
        n = int(rng.integers(60, 181))
        cell = rng.integers(0, n_cells, n)
        r = radii[cell] * np.sqrt(rng.uniform(0.0, 1.0, n))
        angle = rng.uniform(0.0, 2 * np.pi, n)
        cy, cx = ys[cell] + r * np.sin(angle), xs[cell] + r * np.cos(angle)
        cz = rng.uniform(1.0, depth - 2.0, n)
        sd = rng.uniform(1.0, 1.5, n)
        peak = rng.uniform(600.0, 3000.0, n)
        for k in range(n):
            y0, x0 = int(round(cy[k])), int(round(cx[k]))
            y1, y2 = max(y0 - reach, 0), min(y0 + reach + 1, size)
            x1, x2 = max(x0 - reach, 0), min(x0 + reach + 1, size)
            if y1 >= y2 or x1 >= x2:
                continue
            yy = np.arange(y1, y2, dtype=np.float64)[None, :, None]
            xx = np.arange(x1, x2, dtype=np.float64)[None, None, :]
            spot = peak[k] * np.exp(-(zz - cz[k]) ** 2 / 2.0
                                    - ((yy - cy[k]) ** 2 + (xx - cx[k]) ** 2) / (2 * sd[k] ** 2))
            out[s, :, y1:y2, x1:x2] += spot.astype(np.float32)
    return np.clip(out, 0, 65535)


def spots_pipe(threshold: float = SPOT_THRESHOLD, max_points: int = MAX_OBJECTS) -> dict:
    """Path (i), a spot-counting pipeline (smFISH in thousands of single
    cells): DAPI, Actin and an 8-plane FISH z-stack; FISH's maximum
    projection, clipped and bilateral-smoothed, LoG spots; nuclei from
    median-smoothed DAPI, cells grown on Actin and kept at form factor
    >= 0.3, nuclei expanded by 3 px; spots counted per cell
    (``measure_point_pattern``) and measured on FISH."""
    def h(module, inputs, outputs):
        return {"handles": {"module": module, "input": inputs, "output": outputs}}

    def img(name, key, kind="IntensityImage"):
        return {"name": name, "type": kind, "key": key}

    def const(name, value, kind="Numeric"):
        return {"name": name, "type": kind, "value": value}

    def objects(key, name="objects"):
        return [{"name": name, "type": "SegmentedObjects", "key": key, "objects": key}]

    lo, hi, n = SPOT_SIGMAS
    return {
        "description": "spot counting: smFISH spots per cell",
        "input": {"channels": [{"name": "DAPI", "correct": False, "align": False},
                               {"name": "Actin", "correct": False, "align": False},
                               {"name": "FISH", "correct": False, "zstack": True}]},
        "pipeline": [
            h("mip", [img("zstack", "FISH")], [img("mip_image", "fish")]),
            h("clip", [img("intensity_image", "fish"), const("lower", 0.0),
                       const("upper", 20000.0)], [img("clipped_image", "fish_clip")]),
            h("smooth", [img("intensity_image", "fish_clip"),
                         const("method", "bilateral", "Character"), const("size", 5),
                         const("sigma", 2.0)], [img("smoothed_image", "fish_sm")]),
            h("detect_blobs", [img("intensity_image", "fish_sm"), const("threshold", threshold),
                               const("min_distance", 3), const("sigma_min", lo),
                               const("sigma_max", hi), const("n_scales", n)],
              objects("spots") + [img("centers", "spot_centers", "LabelImage")]),
            h("smooth", [img("intensity_image", "DAPI"), const("method", "median", "Character"),
                         const("size", 3)], [img("smoothed_image", "dapi_sm")]),
            h("segment_primary", [img("intensity_image", "dapi_sm"),
                                  const("threshold_method", "otsu", "Character"),
                                  const("smooth_sigma", 0.0), const("fill", True, "Boolean"),
                                  const("min_area", 20)], objects("nuclei")),
            h("segment_secondary", [img("primary_label_image", "nuclei", "LabelImage"),
                                    img("intensity_image", "Actin"),
                                    const("correction_factor", 0.8), const("n_levels", 16)],
              [img("objects", "cells_all", "LabelImage")]),
            h("filter", [img("label_image", "cells_all", "LabelImage"),
                         const("feature", "form_factor", "Character"),
                         const("lower_threshold", 0.3)],
              [img("filtered_label_image", "cells_ff", "LabelImage")]),
            h("expand_or_shrink", [img("label_image", "nuclei", "LabelImage"), const("n", 3)],
              [img("expanded_image", "perinuclei_lab", "LabelImage")]),
            h("register_objects", [img("label_image", "perinuclei_lab", "LabelImage")],
              objects("perinuclei")),
            h("register_objects", [img("label_image", "cells_ff", "LabelImage")],
              objects("cells")),
            h("measure_point_pattern", [img("objects_image", "cells", "LabelImage"),
                                        img("points_image", "spots", "LabelImage"),
                                        const("max_points", max_points)],
              [{"name": "measurements", "type": "Measurement", "objects": "cells"}]),
            h("measure_intensity", [img("objects_image", "spots", "LabelImage"),
                                    img("intensity_image", "fish")],
              [{"name": "measurements", "type": "Measurement", "objects": "spots",
                "channel": "FISH"}]),
        ],
        "output": {"objects": [{"name": "nuclei"}, {"name": "cells"}, {"name": "perinuclei"},
                               {"name": "spots"}]},
    }


def spot_chain(modules, fish):
    """Path (i)'s FISH chain up to ``detect_blobs``' input, as its modules
    compute it: ``(clipped maximum projection, bilateral output)``."""
    g = modules.get_module
    x = g("clip")(g("mip")(fish)["mip_image"], lower=0.0, upper=20000.0)["clipped_image"]
    return x, g("smooth")(x, method="bilateral", size=5, sigma=2.0)["smoothed_image"]


def spot_decisions(torch, blobs, image) -> dict:
    """``{"response", "blobs", "centers"}`` of path (i)'s ``detect_blobs``
    on ``image`` (its bilateral output), on the CPU."""
    lo, hi, n = SPOT_SIGMAS
    sigmas = tuple(lo + (hi - lo) * i / max(n - 1, 1) for i in range(n))
    resp = blobs.log_response(image, sigmas[0])
    for s in sigmas[1:]:
        resp = torch.maximum(resp, blobs.log_response(image, s))
    labels, centers, _ = blobs.detect_blobs(image, sigmas, SPOT_THRESHOLD, 3, MAX_OBJECTS)
    return {"response": resp.cpu(), "blobs": labels.cpu(), "centers": centers.cpu()}


def hold_spots(torch, modules, blobs, fish):
    """``hold(card, cpu)`` for path (i): the spots by the boundary rule
    (:func:`blob_flips`, each side's decisions recomputed from its own
    bilateral output of the first sites' ``fish``, which must give that
    side's spot labels), every other object exact, and the features by
    ``CARD_TIERS`` on the sites whose spots agree."""

    def hold(card, cpu):
        sides = {}
        for side, x in (("card", fish), ("cpu", fish.cpu())):
            mip, sm = spot_chain(modules, x)
            sides[side] = spot_decisions(torch, blobs, sm)
            sides[side]["mip"] = mip.cpu()
        for side, res in (("card", card), ("cpu", cpu)):
            if not torch.equal(sides[side]["blobs"],
                               torch.from_numpy(res.objects["spots"][:N_CPU_SITES])):
                raise SmokeFailure(f"spots: the {side}'s labels are not its decisions'")
        flips = blob_flips(torch, sides["cpu"], sides["card"], SPOT_THRESHOLD,
                           spot_response_tier(SPOT_SIGMAS[1], sides["cpu"]["mip"].numpy(),
                                              bilateral=True), 3)
        print(f"  spots by the boundary rule: response {flips['max_tier_share']:.3g} of its "
              f"tier, {flips['mask_flips']} mask pixels and {flips['peak_flips']} peaks "
              f"flipped, {len(flips['exact_sites'])} of {N_CPU_SITES} sites exact")
        return compare_with_cpu(card, cpu, sites=flips["exact_sites"])

    return hold


def module_stage_times(torch, modules, desc, call, reps: int = 5) -> dict:
    """CUDA-event milliseconds per batch of each module of ``desc`` over
    ``reps`` calls of ``call`` (a batch function of ``desc``), by module
    and its place in the description: the registry's functions are
    wrapped for the measurement and restored after."""
    registry = modules._REGISTRY
    saved = {name: dict(backends) for name, backends in registry.items()}
    events: list = []
    order = {}
    for i, mod in enumerate(desc.modules):
        order.setdefault(mod.module, []).append(f"{mod.module}#{i}")

    def timed(name, fn):
        @functools.wraps(fn)  # the pipeline reads the module's signature
        def run(**kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(**kwargs)
            end.record()
            events.append((name, start, end))
            return out
        return run

    try:
        for name, keys in order.items():
            fn, version = registry[name]["tpu"]
            registry[name]["tpu"] = (timed(name, fn), version)
        call()  # warm-up
        torch.cuda.synchronize()
        events.clear()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    finally:
        registry.clear()
        registry.update(saved)
    totals: dict = {}
    seen: dict = {}
    for name, start, end in events:
        k = seen.get(name, 0)
        key = order[name][k % len(order[name])]
        seen[name] = k + 1
        totals[key] = totals.get(key, 0.0) + start.elapsed_time(end) / reps
    return totals


def drive_spots_path(torch, pkg, wrappers, card) -> dict:
    """Phase 3 path (i), ``spots_b64_256``: config 3's DAPI and Actin
    with :func:`synthetic_fish_batch`'s z-stacks through
    :func:`spots_pipe` (:func:`drive_path`: exactly
    :data:`SPOTS_LAUNCHES`, nothing else, the watershed on chip for every
    site; 8 sites against the CPU by :func:`hold_spots`); the path's
    kernels against their plain versions at its shapes (the spot mask's
    labeling, the point-pattern centroid passes); the stage time of each
    module."""
    pipeline, modules, benchmarks, blobs, kernels, fused_measure = (pkg[k] for k in (
        "pipeline", "modules", "benchmarks", "blobs", "kernels", "fused_measure"))
    from tmlibrary_tpu_torch.jterator.description import PipelineDescription

    t0 = time.perf_counter()
    data = benchmarks.synthetic_cell_painting_batch(B, size=SIZE, seed=SEED)
    data["FISH"] = synthetic_fish_batch(B, SIZE)
    print(f"phase 3, spots: {B} sites of {SIZE}x{SIZE} and {FISH_DEPTH}-plane FISH stacks "
          f"made in {time.perf_counter() - t0:.1f} s")
    desc = PipelineDescription.from_dict(spots_pipe())
    fish = torch.from_numpy(data["FISH"][:N_CPU_SITES]).cuda()
    expect = {k: 0 for k in wrappers}
    expect.update(SPOTS_LAUNCHES)
    run = drive_path(torch, pipeline, "spots", desc, data, wrappers,
                     need=list(SPOTS_LAUNCHES), card=card, expect=expect,
                     only={"fill_holes_flood": "onchip", "watershed_flood": "onchip"},
                     hold=hold_spots(torch, modules, blobs, fish))

    # the path's kernels against their plain versions at its shapes (not counted)
    _, sm = spot_chain(modules, torch.from_numpy(data["FISH"]).cuda())
    lo, hi, n = SPOT_SIGMAS
    resp = blobs.log_response(sm, lo)
    for k in range(1, n):
        resp = torch.maximum(resp, blobs.log_response(sm, lo + (hi - lo) * k / (n - 1)))
    spot_mask = resp > SPOT_THRESHOLD
    spots, cells = run["objects"]["spots"], run["objects"]["cells"]
    yy, xx = torch.meshgrid(torch.arange(SIZE, dtype=torch.float32, device="cuda"),
                            torch.arange(SIZE, dtype=torch.float32, device="cuda"),
                            indexing="ij")
    chans = [torch.ones_like(sm), yy.expand_as(sm), xx.expand_as(sm)]
    holds = {"cc_min_propagate": (kernels.cc_min_propagate(spot_mask),
                                  kernels.cc_min_propagate_plain(spot_mask))}
    for name, lab in (("grouped_stats (points)", spots), ("grouped_stats (cells)", cells)):
        holds[name] = (torch.stack(fused_measure.grouped_stats(lab, chans, MAX_OBJECTS)),
                       torch.stack(fused_measure.grouped_stats_plain(lab, chans, MAX_OBJECTS)))
    for k, (got, want) in holds.items():
        if not torch.equal(got, want):
            raise SmokeFailure(f"spots: {k} differs from its plain version on the path's inputs")
    print("  kernels at the path's shapes equal their plain versions: " + ", ".join(holds)
          + f" (spot pixels {int(spot_mask.sum())}, spots {int(run['counts']['spots'].sum())},"
          f" cells {int(run['counts']['cells'].sum())} in the batch)")
    fn, (raw, stats, shifts) = run["fn"], run["inputs"]
    print_stages(card, module_stage_times(torch, modules, desc, lambda: fn(raw, stats, shifts)))
    return run


def phase_module_sweep(torch, pkg, inputs, card) -> None:
    """Phase 3 (j): each module and method that path (i) does not run,
    alone on the card at 64 sites of 256x256 (z-stacks of 8 planes) --
    its ms per batch (CUDA events, 5 calls after a warm-up) -- and held
    against the port's CPU on the first sites: exact (labels, masks, and
    float outputs, which both devices compute op by op with the same
    rounding: true divisions, correctly rounded roots, products and sums
    rounded one at a time, the host's gaussian taps), the Haralick
    features by ``CARD_TIERS`` (``log``/``exp``) and their GLCM counts
    exact."""
    modules, measure = pkg["modules"], pkg["measure"]
    g = modules.get_module
    dapi, actin, nuclei = inputs["dapi"], inputs["actin"], inputs["nuclei"]
    dapi_mask, actin_mask = inputs["dapi_mask"], inputs["actin_mask"]
    zstack = torch.from_numpy(synthetic_fish_batch(B, SIZE, seed=SEED + 1)).cuda()
    cases = [
        ("invert (float)", lambda a: g("invert")(image=a[0])["inverted_image"], [dapi]),
        ("invert (mask)", lambda a: g("invert")(image=a[0])["inverted_image"], [dapi_mask]),
        ("rescale", lambda a: g("rescale")(a[0], lower=250.0, upper=5000.0)["rescaled_image"],
         [dapi]),
        ("mask", lambda a: g("mask")(a[0], a[1])["masked_image"], [actin, dapi_mask]),
        ("combine_channels", lambda a: g("combine_channels")(
            a[0], a[1], weight_1=0.7, weight_2=1.3)["combined_image"], [dapi, actin]),
        ("filter_edges sobel", lambda a: g("filter_edges")(a[0], method="sobel")[
            "filtered_image"], [dapi]),
        ("filter_edges log", lambda a: g("filter_edges")(a[0], method="log")[
            "filtered_image"], [dapi]),
        ("expand 3", lambda a: g("expand")(a[0], n=3)["expanded_image"], [nuclei]),
        ("shrink 2", lambda a: g("shrink")(a[0], n=2)["shrunken_image"], [nuclei]),
        ("smooth median 9", lambda a: g("smooth")(a[0], method="median", size=9)[
            "smoothed_image"], [dapi]),
    ]
    for op in ("AND", "OR", "XOR"):
        cases.append((f"combine_masks {op}", lambda a, op=op: g("combine_masks")(
            a[0], a[1], operation=op)["combined_mask"], [dapi_mask, actin_mask]))
    for op in ("open", "close", "dilate", "erode"):
        cases.append((f"morphology {op}", lambda a, op=op: g("morphology")(
            a[0], operation=op, iterations=2)["output_mask"], [dapi_mask]))
    for method in ("max", "mean", "sum"):
        cases.append((f"project {method}", lambda a, m=method: g("project")(
            a[0], method=m)["projected_image"], [zstack]))
    print(f"phase 3j: the module sweep at {B} sites of {SIZE}x{SIZE} ({FISH_DEPTH}-plane "
          f"stacks), each held against the CPU on {N_CPU_SITES} sites; times on {card}")
    for name, fn, args in cases:
        ms = cuda_ms(torch, lambda: fn(args), 5)
        got = fn([a[:N_CPU_SITES] for a in args]).cpu()
        want = fn([a[:N_CPU_SITES].cpu() for a in args])
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise SmokeFailure(f"sweep {name}: the card differs from the CPU")
        print(f"  sweep {name}: {ms:.3f} ms per batch of {B} ({B / ms * 1e3:.1f} sites/s), "
              f"exact against the CPU; {card}")
    # Haralick's global quantisation: the GLCM counts exact, the features by tier
    q = measure.quantize_global(actin, LEVELS)
    ms = cuda_ms(torch, lambda: measure.haralick_features(
        nuclei, actin, MAX_OBJECTS, levels=LEVELS, quantization="global"), 5)
    card_glcm = measure.glcm_counts(nuclei[:N_CPU_SITES], q[:N_CPU_SITES], MAX_OBJECTS,
                                    LEVELS, OFFSETS)
    cpu_glcm = measure.glcm_counts(nuclei[:N_CPU_SITES].cpu(), q[:N_CPU_SITES].cpu(),
                                   MAX_OBJECTS, LEVELS, OFFSETS)
    if not torch.equal(q[:N_CPU_SITES].cpu(), measure.quantize_global(
            actin[:N_CPU_SITES].cpu(), LEVELS)) or not all(
            torch.equal(a.cpu(), b) for a, b in zip(card_glcm, cpu_glcm)):
        raise SmokeFailure("sweep haralick global: quantisation or GLCM counts differ")
    got = measure.haralick_features(nuclei[:N_CPU_SITES], actin[:N_CPU_SITES], MAX_OBJECTS,
                                    levels=LEVELS, quantization="global")
    want = measure.haralick_features(nuclei[:N_CPU_SITES].cpu(), actin[:N_CPU_SITES].cpu(),
                                     MAX_OBJECTS, levels=LEVELS, quantization="global")
    worst = max(hold_tier(f"haralick global {k}", got[k].cpu(), want[k],
                          feature_tier(k, CARD_TIERS)) for k in want)
    print(f"  sweep haralick_features global: {ms:.3f} ms per batch of {B} "
          f"({B / ms * 1e3:.1f} sites/s), quantisation and GLCM counts exact, features by "
          f"CARD_TIERS (largest |card - cpu| {worst:.3g}); {card}")


def run_cli_rc(cli, argv: list[str]) -> tuple[int, str]:
    """``cli.main(argv)`` in this process: its exit code and standard
    output."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def compare_with_cpu(card, cpu, sites=None) -> dict:
    """Labels and counts exact; every feature within its tier of
    :data:`CARD_TIERS` on the defined rows of the first sites (of
    ``sites`` among them, where given).  Returns the largest absolute
    difference of each feature family and the feature where it lies."""
    import numpy as np

    n = N_CPU_SITES
    keep = list(range(n)) if sites is None else list(sites)
    for obj in cpu.objects:
        if not np.array_equal(card.objects[obj][keep], cpu.objects[obj][keep]):
            raise SmokeFailure(f"{obj}: card labels differ from the CPU run")
        if not np.array_equal(card.counts[obj][keep], cpu.counts[obj][keep]):
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
            for s in keep:
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


# ------------------------------------------------------- the spatial layout
#: the wells of phase 9: the reference bench's ``BENCH_CONFIG=spatial``
#: well (``bench.py:1437-1515``: 8x8 sites of 256x256, 8 blobs a site) and
#: one at a camera's site size (4x4 sites of 2048x2048 at the same blob
#: density); (name, grid, site size, blobs a site)
SPATIAL_WELLS = (("spatial_8x8_256", (8, 8), 256, 8.0),
                 ("spatial_4x4_2048", (4, 4), 2048, 512.0))
#: the reference's metric name for the spatial layout's throughput
SPATIAL_METRIC = "jterator_spatial_mosaic_megapixels_per_sec"
SPATIAL_KERNELS = ("cc_min_propagate", "watershed_flood", "grouped_stats")


def mosaic_of(stack, grid):
    """The ``(gy*h, gx*w)`` mosaic of a row-major ``(gy*gx, h, w)`` stack."""
    gy, gx = grid
    _, h, w = stack.shape
    return stack.reshape(gy, gx, h, w).transpose(0, 2, 1, 3).reshape(gy * h, gx * w)


def spatial_run(torch, get_step, store, args, wrappers, device="cuda", reps=1) -> dict:
    """``init`` and ``run(0)`` of the jterator step ``reps`` times (the
    first ones warm), the launch counters set to 0 just before the last
    run and read just after; its seconds on the host clock."""
    jt = get_step("jterator")(store, device=device)
    jt.init(args)
    for i in range(reps):
        if i == reps - 1:
            for w in wrappers.values():
                w.launches = 0
                if hasattr(w, "routes"):
                    w.routes = dict.fromkeys(w.routes, 0)
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = jt.run(0)
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    if device == "cuda" and jt.device.type != "cuda":
        raise SmokeFailure(f"spatial: jterator runs on {jt.device}")
    return {"result": result, "seconds": seconds,
            "launches": {k: w.launches for k, w in wrappers.items()},
            "routes": {k: dict(w.routes) for k, w in wrappers.items() if hasattr(w, "routes")}}


def hold_spatial_store(card, cpu, families, title) -> dict:
    """Labels exact and features within :data:`CARD_TIERS` of the CPU's
    run; returns each feature's largest difference."""
    import numpy as np

    import torch

    errs = {}
    for fam in families:
        if not np.array_equal(card.read_labels(None, fam), cpu.read_labels(None, fam)):
            raise SmokeFailure(f"{title}: {fam} labels differ from the CPU run")
        got, want = card.read_features(fam), cpu.read_features(fam)
        if list(got) != list(want) or len(got["label"]) != len(want["label"]):
            raise SmokeFailure(f"{title}: {fam} feature columns or rows differ from the CPU")
        for k in got:
            if k == "plate" or got[k].dtype.kind == "i":
                if not np.array_equal(got[k], want[k]):
                    raise SmokeFailure(f"{title}: {fam}.{k} differs from the CPU")
                continue
            errs[k] = max(errs.get(k, 0.0), hold_tier(
                f"{title}: {fam}.{k}", torch.from_numpy(got[k]), torch.from_numpy(want[k]),
                feature_tier(k, CARD_TIERS)))
    return errs


def spatial_kernel_holds(torch, kernels, threshold, img, mask, labels, bw) -> dict:
    """Rows 2 and 3 against their plain versions at the mosaic's shape
    (the secondary's inputs for row 3), each timed, with the bound of
    :func:`finish_records`."""
    compare = make_compare(torch)
    m = mask[None]
    want = kernels.cc_min_propagate_plain(m)
    err2 = compare("cc_min_propagate[mosaic]", kernels.cc_min_propagate(m), want)
    sec = threshold.threshold_otsu(img[None])
    args = (img[None], labels[None], sec, 32, 8)
    plan = kernels.watershed_plan(img[None].shape, 32)
    want = kernels.watershed_flood_plain(*args)
    err3 = compare("watershed_flood[mosaic]", kernels.watershed_flood(*args), want)
    px = img.numel()
    out = {
        "cc_min_propagate": dict(
            route="cuda", max_abs_err=err2, shape=list(mask.shape),
            ms=cuda_ms(torch, lambda: kernels.cc_min_propagate(m), 5, 1),
            plain_ms=cuda_ms(torch, lambda: kernels.cc_min_propagate_plain(m), 1, 0),
            bytes=px * (1 + 4), ops=px * 8, library_ms=None),
        "watershed_flood": dict(
            route="cuda", flood_route=plan.route, max_abs_err=err3, shape=list(img.shape),
            ms=cuda_ms(torch, lambda: kernels.watershed_flood(*args), 2, 1),
            plain_ms=cuda_ms(torch, lambda: kernels.watershed_flood_plain(*args), 1, 0),
            bytes=px * (4 + 4 + 1 + 4), ops=px * 8, library_ms=None),
    }
    for r in out.values():
        t_bytes = r.pop("bytes") / bw * 1e3
        t_ops = r.pop("ops") / FP32_OPS_PER_S * 1e3
        r["bound_ms"], r["bound_by"] = (
            (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))
    return out


def spatial_cli(torch, store, run, root: Path, wrappers, card) -> dict:
    """``workflow submit --device cuda`` of the spatial description
    ``run`` (title, jterator arguments, expected launches) over a copy of
    ``store``'s images, in this process with the launch counters set to 0
    before: its launches as the step's, its labels and feature shards the
    step's store's bit for bit."""
    import numpy as np

    from tmlibrary_tpu_torch import cli
    from tmlibrary_tpu_torch.models.store import ExperimentStore
    from tmlibrary_tpu_torch.workflow.engine import WorkflowDescription

    title, args, expect = run
    copy_part(store.root, root, "images")
    desc = WorkflowDescription.canonical({"jterator": args})
    for stage in desc.stages:
        for sd in stage.steps:
            sd.active = sd.name == "jterator"
    desc.save(root / "wf.json")
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_cli(cli, ["workflow", "submit", "--root", str(root), "--description",
                  str(root / "wf.json"), "--device", "cuda"])
    seconds = time.perf_counter() - t0
    got = {k: wrappers[k].launches for k in expect}
    if got != expect:
        raise SmokeFailure(f"spatial cli: launches {got}, expected {expect}")
    sub = ExperimentStore.open(root)
    for fam in ("mosaic_cells", "mosaic_secondary"):
        if not np.array_equal(sub.read_labels(None, fam), store.read_labels(None, fam)):
            raise SmokeFailure(f"spatial cli: {fam} labels differ from the step's")
        a, b = sub.read_features(fam), store.read_features(fam)
        if list(a) != list(b) or any(not np.array_equal(a[k], b[k]) for k in a):
            raise SmokeFailure(f"spatial cli: {fam} features differ from the step's")
    print(f"  workflow submit --device cuda ({title}): {seconds:.3f} s with the engine and "
          f"its ledger, launches {got}, store = the step's on {card}")
    return {"seconds": seconds, "launches": got}


def phase_spatial(torch, pkg, wrappers, card, bw) -> tuple[dict, dict]:
    """Phase 9, the spatial layout on the card (``layout: spatial``): each
    well of :data:`SPATIAL_WELLS` (``synthetic_mosaic_well``) written to a
    store under ``build/`` as its sites, and the jterator step run on it
    through ``init`` and ``run(0)`` with the launch counters set to 0
    before the timed run and read after; Mpix/s of the whole step (stitch,
    segmentation, host features, writes).

    ``spatial_8x8_256`` runs twice: with ``spatial_zernike_degree: 0``
    (the reference bench's run: row 2 once, no flood) and with the default
    degree 9 and a secondary family on the same channel (row 2 once, row 3
    once, on its ``global`` route: one 2048x2048 image).  Each is held to
    the port's CPU run of the same step (labels and counts exact, features
    by :data:`CARD_TIERS`), the count to the scipy chain
    (``benchmarks.cpu_reference_mosaic``, whose time is the CPU
    denominator), and the labels to ``scipy.ndimage.label`` of the card's
    own mask; rows 2 and 3 are held to their plain versions at the
    mosaic's shape and timed there; the stage times are the step's own
    (its batch summary's ``stages``).
    ``spatial_4x4_2048`` (an 8192x8192 mosaic, 67.1 Mpx) runs the primary
    alone, held to the scipy chain's count and to ``ndimage.label`` of the
    card's mask; the port's CPU run is skipped there.  The 2048x2048
    well's secondary description also goes through ``workflow submit
    --device cuda`` (:func:`spatial_cli`).  Returns rows 2 and 3 at the
    mosaic's shape and the launches of the secondary run."""
    import numpy as np
    import scipy.ndimage as ndi

    from tmlibrary_tpu_torch import benchmarks
    from tmlibrary_tpu_torch.models.experiment import grid_experiment
    from tmlibrary_tpu_torch.models.store import ExperimentStore
    from tmlibrary_tpu_torch.workflow import get_step

    kernels, smooth, threshold = pkg["kernels"], pkg["smooth"], pkg["threshold"]
    base = Path(__file__).resolve().parent / "build" / f"spatial.{os.getpid()}"
    shutil.rmtree(base, ignore_errors=True)
    eight = ndi.generate_binary_structure(2, 2)
    summary = {}
    records, launches = {}, {}
    try:
        for name, grid, size, per_site in SPATIAL_WELLS:
            t0 = time.perf_counter()
            mosaic, tiles = benchmarks.synthetic_mosaic_well(*grid, size,
                                                              cells_per_site=per_site)
            stores = {}
            for who in ("card", "cpu") if size <= 256 else ("card",):
                exp = grid_experiment(name, well_rows=1, well_cols=1, sites_per_well=grid,
                                      channel_names=("DAPI",), site_shape=(size, size))
                stores[who] = ExperimentStore.create(base / name / who, exp)
                stores[who].write_sites(tiles, list(range(len(tiles))), channel=0)
            mpix = mosaic.size / 1e6
            print(f"  {name}: {grid[0]}x{grid[1]} sites of {size}x{size}, a "
                  f"{mosaic.shape[0]}x{mosaic.shape[1]} mosaic ({mpix:.1f} Mpx), made and "
                  f"written in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            scipy_count = benchmarks.cpu_reference_mosaic(mosaic)
            scipy_s = time.perf_counter() - t0
            runs = [("primary", {"layout": "spatial", "spatial_zernike_degree": 0},
                     {"cc_min_propagate": 1, "watershed_flood": 0, "grouped_stats": 0})]
            if size <= 256:
                runs.append(("secondary", {"layout": "spatial",
                                           "spatial_secondary_channel": "DAPI"},
                             {"cc_min_propagate": 1, "watershed_flood": 1,
                              "grouped_stats": 0}))
            else:
                print(f"  {name}: the port's CPU run of this well is skipped (an 8192x8192 "
                      "mosaic through the plain fixpoints); held to the scipy chain and to "
                      "ndimage.label of the card's mask")
            for title, args, expect in runs:
                run = spatial_run(torch, get_step, stores["card"], args, wrappers, reps=2)
                got = {k: run["launches"][k] for k in expect}
                if got != expect:
                    raise SmokeFailure(f"{name} {title}: launches {got}, expected {expect}")
                # one image above 65,536 pixels: the flood's global route
                route = kernels.watershed_plan(mosaic.shape, 32).route
                if expect["watershed_flood"] and run["routes"]["watershed_flood"] != {
                        "onchip": 0, "global": 0, route: 1}:
                    raise SmokeFailure(f"{name} {title}: flood routes "
                                       f"{run['routes']['watershed_flood']}, expected {route}")
                count = run["result"]["objects"]["mosaic_cells"]
                if count != scipy_count:
                    raise SmokeFailure(f"{name} {title}: {count} objects, the scipy chain "
                                       f"finds {scipy_count}")
                card_labels = mosaic_of(stores["card"].read_labels(None, "mosaic_cells"), grid)
                img = torch.from_numpy(mosaic.astype(np.float32)).cuda()
                sm = smooth.gaussian_smooth(img, 1.5)
                mask = sm > threshold.otsu_value(sm[None])[0]
                gold, n = ndi.label(mask.cpu().numpy(), eight)
                if n != count or not np.array_equal(gold, card_labels):
                    raise SmokeFailure(f"{name} {title}: labels differ from ndimage.label of "
                                       "the card's mask")
                line = {"metric": SPATIAL_METRIC, "well": name, "run": title,
                        "value": round(mpix / run["seconds"], 3), "seconds": run["seconds"],
                        "objects": count, "scipy_mpix_per_sec": round(mpix / scipy_s, 3),
                        "launches": got, "flood_routes": run["routes"]["watershed_flood"]}
                if "cpu" in stores:
                    cpu = spatial_run(torch, get_step, stores["cpu"], args, {}, device="cpu")
                    fams = ["mosaic_cells"] + (["mosaic_secondary"] if title == "secondary"
                                               else [])
                    errs = hold_spatial_store(stores["card"], stores["cpu"], fams,
                                              f"{name} {title}")
                    line["cpu_seconds"] = cpu["seconds"]
                    line["largest_feature_diff"] = max(errs.values(), default=0.0)
                print(f"  {name} {title}: {line['value']} Mpix/s ({run['seconds']:.3f} s for "
                      f"{mpix:.1f} Mpx; scipy chain {line['scipy_mpix_per_sec']} Mpix/s), "
                      f"{count} objects = the scipy chain's, launches {got}, flood routes "
                      f"{line['flood_routes']}, labels = ndimage.label of the card's mask"
                      + (f", CPU run held (labels exact, features by CARD_TIERS, largest "
                         f"diff {line['largest_feature_diff']:.3g}; {line['cpu_seconds']:.2f}"
                         " s on the CPU)" if "cpu_seconds" in line else "")
                      + f" on {card}")
                summary[f"{name}/{title}"] = line
                # the step's own stage times (its batch summary)
                stages = run["result"]["stages"]
                print(f"    stages (s): " + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
                      + f" on {card}")
                line["stages"] = stages
                if title == "secondary":
                    launches = run["launches"]
                    labels = torch.from_numpy(card_labels).cuda()
                    records = spatial_kernel_holds(torch, kernels, threshold, img, mask,
                                                   labels, bw)
                    for k, r in records.items():
                        r["launches"] = run["launches"][k]
                        print(f"    {k} at the mosaic's shape {r['shape']}: {r['ms']:.3f} ms "
                              f"(plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by "
                              f"{r['bound_by']}), exact against the plain version"
                              + (f", route {r['flood_route']}" if "flood_route" in r else "")
                              + f" on {card}")
            if "cpu" in stores:
                summary[f"{name}/cli"] = spatial_cli(torch, stores["card"], runs[-1],
                                                     base / name / "cli", wrappers, card)
            shutil.rmtree(base / name, ignore_errors=True)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    print("spatial: " + json.dumps(summary, default=float))
    return records, launches



# -------------------------------------------------------- the analytics plane
#: phase 10: warm calls timed per tool; the strided query rows the CPU
#: holds at 10^5 objects, and the rows held against a float64 brute force
ANALYTICS_REPS, CPU_HOLD_ROWS, F64_ROWS = 3, 2000, 256


def _self_knn_rows(ops, x, rows, k, device):
    """Self-kNN of ``rows`` alone (each row's own index dropped from an
    explicit-query sweep of k + 1), for a strided CPU hold."""
    import numpy as np

    idx, dist = ops.knn(x, k + 1, queries=x[rows], device=device)
    keep = idx != rows[:, None]
    keep[keep.sum(axis=1) > k, -1] = False  # self not among the k + 1: drop the last
    return (idx[keep].reshape(len(rows), k), dist[keep].reshape(len(rows), k))


def _sq64(x, c):
    """Squared distances in float64, (N, C)."""
    import numpy as np

    x, c = np.asarray(x, np.float64), np.asarray(c, np.float64)
    return (x * x).sum(1)[:, None] - 2.0 * x @ c.T + (c * c).sum(1)[None]


def _float64_knn(x, rows, k):
    import numpy as np

    x64 = x.astype(np.float64)
    q = x64[rows]
    d2 = (q * q).sum(1)[:, None] - 2.0 * q @ x64.T + (x64 * x64).sum(1)[None]
    d2[np.arange(len(rows)), rows] = np.inf
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return idx, np.sqrt(np.maximum(np.take_along_axis(d2, idx, 1), 0.0))


def analytics_population_phase(torch, n: int, card: str, device: str = "cuda") -> dict:
    """Phase 10 (a) at ``n`` objects: each tool's warm time on the card,
    its repeat bit-identical, and its output held to the port's CPU run."""
    import numpy as np

    from tmlibrary_tpu_torch import benchmarks
    from tmlibrary_tpu_torch.analytics import index as aidx
    from tmlibrary_tpu_torch.analytics import ops
    from tmlibrary_tpu_torch.analytics import spatial as asp
    from tmlibrary_tpu_torch.tools import clustering

    p = benchmarks.ANALYTICS_PARAMS
    x, site_index, centroids = benchmarks.analytics_population(n)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    qps, out = {}, {}
    for tool, fn in benchmarks.analytics_runners(x, site_index, centroids, device).items():
        seconds, out[tool], same = benchmarks.time_warm(fn, ANALYTICS_REPS, sync)
        if not same:
            raise SmokeFailure(f"analytics {tool} N={n}: repeated calls on the card differ")
        qps[tool] = 1.0 / seconds
    print(f"  N={n} x {x.shape[1]}: queries/s " + ", ".join(f"{t} {v:.3f}" for t, v in qps.items())
          + f" (mean of {ANALYTICS_REPS} warm calls, host clock ended by a sync; every "
          f"repeat bit-identical); on {card}")
    holds = {}
    # knn: the CPU on every row at 10^4, on strided rows at 10^5; float64
    k = p["knn_k"]
    rows = np.arange(n) if n <= 10_000 else np.linspace(0, n - 1, CPU_HOLD_ROWS).astype(np.int64)
    cidx, cdist = out["knn"]
    want = ops.knn(x, k, device="cpu") if len(rows) == n else \
        _self_knn_rows(ops, x, rows, k, "cpu")
    holds["knn_vs_cpu"] = knn_hold(x, x[rows], (cidx[rows], cdist[rows]), want)
    f64 = np.linspace(0, n - 1, F64_ROWS).astype(np.int64)
    holds["knn_vs_float64"] = knn_hold(x, x[f64], (cidx[f64], cdist[f64]),
                                       _float64_knn(x, f64, k))
    # pca
    cpu_pca = ops.pca(x, p["pca_components"], device="cpu")
    holds["pca_rel_err"] = max(rel_hold(f"pca {name} N={n}", g, w) for name, g, w in
                               zip(("scores", "components", "ratio"), out["pca"], cpu_pca))
    # embedding: the whole CPU run at 10^4; at 10^5 the CPU's spectral
    # stage on the card's graph (the graph is the knn hold above)
    if n <= 10_000:
        cpu_emb = ops.spectral_embedding(x, 2, k=p["embedding_k"], device="cpu")
    else:
        graph = ops.knn(x, p["embedding_k"], device=device)
        cpu_emb = ops.spectral_embedding(x, 2, k=p["embedding_k"], graph=graph, device="cpu")
    holds["embedding_cos"] = subspace_cos(out["embedding"], cpu_emb)
    if holds["embedding_cos"] < EMBEDDING_MIN_COS:
        raise SmokeFailure(f"embedding N={n}: principal cosine {holds['embedding_cos']}")
    # spatial: exact
    cpu_index = asp.build_index(site_index, centroids, device="cpu")
    card_index = asp.build_index(site_index, centroids, device=device)
    if not (np.array_equal(card_index.tables.cpu().numpy(), cpu_index.tables.numpy())
            and np.array_equal(out["spatial"], asp.density(cpu_index, p["spatial_radius"]))):
        raise SmokeFailure(f"spatial N={n}: tables or density differ from the CPU (exact)")
    # k-means: seeds exact, then every Lloyd step of the CPU's trajectory
    # half by half on the card
    kk = p["kmeans_k"]
    xc, xg = torch.from_numpy(x), torch.from_numpy(x).to(device)
    cent = clustering._greedy_seeds(xc, kk, 0)
    if not torch.equal(clustering._greedy_seeds(xg, kk, 0).cpu(), cent):
        raise SmokeFailure(f"kmeans N={n}: the card's seeds differ from the CPU's")
    flips, worst = 0, 0.0
    for _ in range(50):
        assign, dmin = clustering.lloyd_assign(xc, cent)
        g_assign, _ = clustering.lloyd_assign(xg, cent.to(device))
        d2 = _sq64(x, cent.numpy())
        scale = (x.astype(np.float64) ** 2).sum(1) + float((cent.double() ** 2).sum(1).max())
        flips += decision_hold(f"kmeans N={n} assignments", g_assign.cpu().numpy(),
                               assign.numpy(), d2, scale)
        new = clustering.lloyd_update(xc, cent, assign, dmin)
        worst = max(worst, rel_hold(f"kmeans N={n} update", clustering.lloyd_update(
            xg, cent.to(device), assign.to(device), dmin.to(device)).cpu().numpy(), new.numpy()))
        cent = new
    final = float((out["clustering"][0] == clustering.lloyd_assign(xc, cent)[0].numpy()).mean())
    holds["kmeans"] = {"step_flips": flips, "update_rel_err": worst,
                       "final_assignments_equal": final}
    # IVF on the clustered population: build, self sweep against brute
    # force, recall@k; the CPU searches the card's cells
    xb = benchmarks.clustered_population(n)
    t0 = time.perf_counter()
    cent_b, mem, assign_b = aidx.ivf_build_arrays(xb, device=device)
    sync()
    build_s = time.perf_counter() - t0
    brute_s, _, _ = benchmarks.time_warm(lambda: ops.knn(xb, k, device=device), ANALYTICS_REPS,
                                         sync)
    ivf_s, ivf_out, same = benchmarks.time_warm(
        lambda: aidx.ivf_search_arrays(xb, cent_b, mem, k, device=device), ANALYTICS_REPS, sync)
    if not same:
        raise SmokeFailure(f"ivf N={n}: repeated sweeps on the card differ")
    recall = aidx.measure_recall(xb, cent_b, mem, k=k, device=device)
    qrows = np.linspace(0, n - 1, min(n, CPU_HOLD_ROWS)).astype(np.int64)
    holds["ivf_vs_cpu"] = knn_hold(
        xb, xb[qrows], aidx.ivf_search_arrays(xb, cent_b, mem, k, queries=xb[qrows],
                                              device=device),
        aidx.ivf_search_arrays(xb, cent_b, mem, k, queries=xb[qrows], device="cpu"))
    with torch.no_grad():
        cpu_cells = aidx.assign_cells(torch.from_numpy(xb), torch.from_numpy(cent_b)).numpy()
    diff = np.nonzero(assign_b != cpu_cells)[0]
    holds["ivf_cell_flips"] = decision_hold(
        f"ivf N={n} cells", assign_b[diff], cpu_cells[diff], _sq64(xb[diff], cent_b),
        (xb[diff].astype(np.float64) ** 2).sum(1) + (cent_b.astype(np.float64) ** 2).sum(1).max())
    index_row = {"n": n, "brute_qps": 1.0 / brute_s, "ivf_qps": 1.0 / ivf_s,
                 "speedup": brute_s / ivf_s, "recall_at_k": recall, "build_s": build_s,
                 "n_cells": int(cent_b.shape[0]), "top_p": aidx.DEFAULT_TOP_P, "k": k}
    print(f"  N={n} index_vs_brute (clustered): brute {index_row['brute_qps']:.3f} q/s, ivf "
          f"{index_row['ivf_qps']:.3f} q/s ({index_row['speedup']:.2f}x), recall@{k} {recall}, "
          f"build {build_s:.3f} s, {index_row['n_cells']} cells; on {card}")
    print(f"  N={n} holds against the port's CPU run ({'all' if len(rows) == n else len(rows)} "
          f"query rows for knn, {F64_ROWS} rows against float64): {json.dumps(holds)}")
    return {"per_tool": qps, "index_vs_brute": index_row, "holds": holds}


def _query(cli, root, tool, payload, device, *extra) -> dict:
    return json.loads(run_cli(cli, ["query", "--root", root, "--tool", tool, "--objects",
                                    "nuclei", "--payload", json.dumps(payload), "--device",
                                    device, *extra]))


def analytics_query_phase(torch, features_root: Path, card: str, device: str = "cuda") -> dict:
    """Phase 10 (b): ``tmx-torch query`` of every tool over the feature
    store of phase 6's plate, on the card: a miss, a hit equal to it,
    a recompute bit-identical to it; ``index build`` and ``index list``;
    then each query with ``--device cpu`` over a copy of the store that
    keeps the card's indexes (the same store digest), held to the card."""
    import numpy as np

    from tmlibrary_tpu_torch import cli
    from tmlibrary_tpu_torch.analytics.index import knn_search
    from tmlibrary_tpu_torch.analytics.store import FeatureStore
    from tmlibrary_tpu_torch.models.store import ExperimentStore
    from tmlibrary_tpu_torch.tools.base import ToolResult
    from tmlibrary_tpu_torch.tools.classification import softmax_train

    root = str(features_root)
    fs = FeatureStore.ensure(ExperimentStore.open(features_root), "nuclei")
    ids, x, feats = fs.standardized()
    area = fs.column("Morphology_area")
    order = np.argsort(area, kind="stable")
    pick = np.concatenate([order[:10], order[-10:]])
    examples = [{"site_index": int(ids["site_index"][i]), "label": int(ids["label"][i]),
                 "class": "small" if j < 10 else "large"} for j, i in enumerate(pick)]
    heat = next(f for f in feats if f.startswith("Intensity_mean"))
    queries = {
        "knn": ("knn", {"k": 10}),
        "pca": ("pca", {"n_components": 2}),
        "embedding": ("embedding", {"k": 15}),
        "spatial": ("spatial", {"statistic": "density", "radius": 2}),
        "clustering": ("clustering", {"k": 5}),
        "heatmap": ("heatmap", {"feature": heat}),
        "logreg": ("classification", {"training_examples": examples}),
        "knn_vote": ("classification", {"training_examples": examples, "method": "knn"}),
    }
    t0 = time.perf_counter()
    built = json.loads(run_cli(cli, ["index", "build", "--root", root, "--objects", "nuclei",
                                     "--device", device]))
    index_s = time.perf_counter() - t0
    card_res, times = {}, {}
    for name, (tool, payload) in queries.items():
        t0 = time.perf_counter()
        miss = _query(cli, root, tool, payload, device)
        if device == "cuda":
            torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        hit = _query(cli, root, tool, payload, device)
        values = Path(miss["result_dir"]) / "values.parquet"
        first = values.read_bytes()
        redo = _query(cli, root, tool, payload, device, "--no-cache")
        if (miss["cache"], hit["cache"], redo["cache"]) != ("miss", "hit", "miss") or \
                hit["key"] != miss["key"] or hit["attributes"] != miss["attributes"]:
            raise SmokeFailure(f"query {name}: miss/hit/recompute {miss['cache']}, "
                               f"{hit['cache']}, {redo['cache']} or the hit differs")
        if values.read_bytes() != first:
            raise SmokeFailure(f"query {name}: the recompute on the card is not bit-identical")
        card_res[name] = ToolResult.load(miss["result_dir"])
    listed = json.loads(run_cli(cli, ["index", "list", "--root", root, "--objects", "nuclei",
                                      "--device", device]))
    if not listed["indexes"] or {i["state"] for i in listed["indexes"]} != {"fresh"}:
        raise SmokeFailure(f"index list: {listed}")
    # the CPU over a copy holding the shards and the card's indexes
    cpu_root = features_root.parent / (features_root.name + ".cpu")
    shutil.rmtree(cpu_root, ignore_errors=True)
    copy_part(features_root, cpu_root, "features")
    shutil.copytree(features_root / "analytics", cpu_root / "analytics")
    cpu_res = {name: ToolResult.load(_query(cli, str(cpu_root), tool, payload, "cpu")
                                     ["result_dir"]) for name, (tool, payload) in queries.items()}
    col = lambda res, pre, n: np.stack([np.asarray(res.values[f"{pre}{j}"])  # noqa: E731
                                        for j in range(n)], 1)
    holds = {"knn": knn_hold(x, x, (col(card_res["knn"], "nn", 10),
                                    col(card_res["knn"], "nnd", 10)),
                             (col(cpu_res["knn"], "nn", 10), col(cpu_res["knn"], "nnd", 10)))}
    holds["pca_rel_err"] = max(
        rel_hold("query pca scores", col(card_res["pca"], "pc", 2), col(cpu_res["pca"], "pc", 2)),
        rel_hold("query pca components", card_res["pca"].attributes["components"],
                 cpu_res["pca"].attributes["components"]))
    holds["embedding_cos"] = subspace_cos(col(card_res["embedding"], "emb", 2),
                                          col(cpu_res["embedding"], "emb", 2))
    if holds["embedding_cos"] < EMBEDDING_MIN_COS:
        raise SmokeFailure(f"query embedding: principal cosine {holds['embedding_cos']}")
    for name in ("spatial", "heatmap", "clustering"):
        if not np.array_equal(card_res[name].values["value"], cpu_res[name].values["value"]):
            raise SmokeFailure(f"query {name}: values differ from the CPU's (exact)")
    # logistic regression: a class may differ only at a near tie of the CPU's logits
    lookup = {t: i for i, t in enumerate(zip(ids["site_index"].tolist(), ids["label"].tolist()))}
    rows = np.array([lookup[(e["site_index"], e["label"])] for e in examples])
    y = np.array([0 if e["class"] == "large" else 1 for e in examples])
    w, b = softmax_train(x[rows], y, 2, device="cpu")
    z = x.astype(np.float64) @ w.double().numpy() + b.double().numpy()
    holds["logreg_flips"] = decision_hold(
        "query logreg", card_res["logreg"].values["value"], cpu_res["logreg"].values["value"],
        z, np.abs(z).max(axis=1))
    # kNN votes: a class may differ only where the two neighbour lists do
    nb = {d: knn_search(fs, x, 10, features=feats, device=d)[0] for d in (device, "cpu")}
    differ = card_res["knn_vote"].values["value"] != cpu_res["knn_vote"].values["value"]
    if (differ & (nb[device] == nb["cpu"]).all(axis=1)).any():
        raise SmokeFailure("query classification knn: a vote differs on equal neighbours")
    holds["knn_vote_flips"] = int(differ.sum())
    shutil.rmtree(cpu_root, ignore_errors=True)
    print(f"  query over phase 6's plate ({fs.n_objects} nuclei x {len(feats)} features): "
          f"index build {index_s:.3f} s ({built['n_cells']} cells, recall@10 "
          f"{built['recall_at_k']}), miss seconds " + ", ".join(
              f"{k} {v:.3f}" for k, v in times.items())
          + f"; every hit equal to its miss and every recompute bit-identical; on {card}")
    print(f"  query holds against --device cpu (the card's indexes): {json.dumps(holds)}")
    return {"n_objects": fs.n_objects, "n_features": len(feats), "miss_s": times,
            "index_build_s": index_s, "holds": holds}


def phase_analytics(torch, features_root: Path, card: str) -> dict:
    """Phase 10: the analytics plane on the card (see the module doc)."""
    t0 = time.perf_counter()
    print(f"phase 10: the analytics plane, the reference bench's populations and "
          f"`tmx-torch query` on the card; times on {card}")
    out = {"populations": {str(n): analytics_population_phase(torch, n, card)
                           for n in (10_000, 100_000)},
           "query": analytics_query_phase(torch, features_root, card)}
    print(f"  phase 10 took {time.perf_counter() - t0:.1f} s")
    print("analytics: " + json.dumps(out))
    return out


#: config 3 as a project: (module, instance) in pipeline order
PROJECT_MODULES = (("smooth", "smooth"), ("segment_primary", "segment_primary"),
                   ("segment_secondary", "segment_secondary"),
                   ("measure_intensity", "measure_nuclei"),
                   ("measure_intensity", "measure_cells"))


#: the CPU hold's batch size in phase 11 (its first and last batches run)
PROJECT_CPU_BATCH = 16


def _mib_per_s(nbytes: int, seconds: float) -> float:
    return nbytes / 2**20 / max(seconds, 1e-9)


def _tree_bytes(path: Path) -> int:
    path = Path(path)
    if path.is_file():
        return path.stat().st_size
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def build_project(cli, proj: Path) -> Path:
    """Config 3 (``CELL_PAINTING_PIPE``) as a jterator project, built as a
    user builds one: ``project create``, ``add-channel``, ``add-module``,
    then each instance's handles set to config 3's values with
    ``Project.update_handles``; ``project check`` must print OK.  Returns
    the ``.pipe.yaml`` path."""
    from tmlibrary_tpu_torch import benchmarks
    from tmlibrary_tpu_torch.jterator.handles import HandleCollection
    from tmlibrary_tpu_torch.jterator.project import Project

    pipe = benchmarks.CELL_PAINTING_PIPE
    run_cli(cli, ["project", "create", "--dir", str(proj), "--description",
                  pipe["description"]])
    for ch in pipe["input"]["channels"]:
        run_cli(cli, ["project", "add-channel", "--dir", str(proj), "--name", ch["name"],
                      "--no-correct"])
    for module, instance in PROJECT_MODULES:
        run_cli(cli, ["project", "add-module", "--dir", str(proj), "--module", module,
                      "--instance", instance])
    project = Project(proj)
    for (_, instance), item in zip(PROJECT_MODULES, pipe["pipeline"]):
        version = project.get_handles(instance).version
        project.update_handles(instance, HandleCollection.from_dict(
            {**item["handles"], "version": version}))
    for obj in pipe["output"]["objects"]:
        project.add_output_objects(obj["name"])
    checked = run_cli(cli, ["project", "check", "--pipe", str(project.pipe_path)])
    if not checked.startswith("OK:"):
        raise SmokeFailure(f"project: check says {checked.strip()}")
    return project.pipe_path


def phase_project(torch, wrappers, card, device: str = "cuda") -> dict:
    """Phase 11, ``project_yaml_p96x4_256``: a reference user's YAML
    project on the card, from the project to the exports and back in.
    Config 3 built through the ``project`` verbs (:func:`build_project`),
    ``workflow template`` filled in and saved as ``workflow.yaml``, and
    ``workflow submit --device cuda`` over phase 5's plate (96 wells at
    2x2 sites of 256x256, DAPI and Actin, one cycle) with the launch
    counters set to 0 just before and read just after (rows 1-4 must
    launch).  Holds: the store's labels and feature shards bit-identical
    to the same plate run from the JSON forms of the pipeline and the
    workflow description; the sites of the first and last of the CPU's
    batches of :data:`PROJECT_CPU_BATCH` equal to the port's CPU run
    (labels, counts and metadata exact, features by ``CARD_TIERS``); the exports (Parquet, CSV, GeoJSON ``--simplify
    1.0``, the DAPI images, the plate as OME-NGFF with both label
    stacks) read back; the NGFF plate re-ingested by ``metaconfig
    --handler ngff`` and ``imextract`` into a fresh store on the card
    with every pixel equal; ``workflow cleanup`` leaving no step output,
    batch plan, registration or ledger.  Prints the ``project:`` line.
    The directory is removed at the end."""
    import numpy as np

    from tmlibrary_tpu_torch import benchmarks, capacity, cli, yamlio
    from tmlibrary_tpu_torch.io import parquet
    from tmlibrary_tpu_torch.models.experiment import grid_experiment
    from tmlibrary_tpu_torch.models.mapobject import MapobjectTypeRegistry
    from tmlibrary_tpu_torch.models.store import ExperimentStore
    from tmlibrary_tpu_torch.readers import read_tiff_page_py
    from tmlibrary_tpu_torch.workflow import engine, get_step

    started = time.perf_counter()
    base = Path(__file__).resolve().parent / "build" / f"phase11.{os.getpid()}"
    shutil.rmtree(base, ignore_errors=True)
    try:
        exp = grid_experiment("phase11", well_rows=PLATE[0], well_cols=PLATE[1],
                              sites_per_well=SITES_PER_WELL, channel_names=("DAPI", "Actin"),
                              site_shape=(SIZE, SIZE))
        n = exp.n_sites
        data = benchmarks.synthetic_cell_painting_batch(n, size=SIZE, seed=SEED)
        stores = {}
        for name in ("yaml", "json"):
            stores[name] = ExperimentStore.create(base / name, exp)
            for c, ch in enumerate(("DAPI", "Actin")):
                stores[name].write_sites(data[ch].astype(np.uint16), list(range(n)), channel=c)
        del data
        store = stores["yaml"]
        root = str(store.root)

        # 1-2. the project, the template filled in and saved as workflow.yaml
        pipe_path = build_project(cli, store.root / "project")
        run_cli(cli, ["workflow", "template", "--root", root, "--device", device])
        wf_path = store.workflow_dir / "workflow.yaml"
        desc = engine.WorkflowDescription.load(wf_path)
        args = {"pipe": str(pipe_path.relative_to(store.root)), "batch_size": STEP_BATCH,
                "max_objects": MAX_OBJECTS, "as_polygons": True}
        for step in (s for st in desc.stages for s in st.steps):
            if step.name == "jterator":
                step.args, step.active = dict(args), True
        desc.save(wf_path)
        if engine.WorkflowDescription.load(wf_path).to_dict() != desc.to_dict():
            raise SmokeFailure("project: workflow.yaml does not read back as written")
        print(f"phase 11, project_yaml_p96x4_256: config 3 as a YAML project "
              f"({len(PROJECT_MODULES)} modules, `project check` OK) through `workflow "
              f"submit --device {device}` of the store's workflow.yaml over {n} sites "
              f"({PLATE[0]}x{PLATE[1]} wells at {SITES_PER_WELL[0]}x{SITES_PER_WELL[1]} sites of "
              f"{SIZE}x{SIZE}, DAPI and Actin) on {card}")

        # 3-4. submit from the YAML project, launches read around it
        capacity.reset_routing_history()
        if device == "cuda":
            torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
            if hasattr(w, "routes"):
                w.routes = dict.fromkeys(w.routes, 0)
        t0 = time.perf_counter()
        summary = json.loads(run_cli(cli, ["workflow", "submit", "--root", root,
                                           "--device", device]))
        submit_s = time.perf_counter() - t0
        launches = {k: wrappers[k].launches for k in
                    ("fill_holes_flood", "cc_min_propagate", "watershed_flood", "grouped_stats")}
        if not all(launches.values()):
            raise SmokeFailure(f"project: a kernel of rows 1-4 did not launch: {launches}")
        walls = {step: round(float(e["elapsed"]), 3) for step, e in engine.RunLedger(
            store.workflow_dir / "ledger.jsonl").status().items()}
        print(f"  submit: {n / submit_s:.1f} sites/s ({submit_s:.3f} s of command), step walls "
              f"{walls}, launches {launches}; summary {json.dumps(summary)[:160]}")

        # 5. the same plate from the JSON forms of the pipeline and description
        other = stores["json"]
        pipe = dict(benchmarks.CELL_PAINTING_PIPE)
        (other.root / "cp.pipe.json").write_text(json.dumps(pipe))
        wf_json = json.loads(json.dumps(desc.to_dict()))
        for st in wf_json["stages"]:
            for step in st["steps"]:
                if step["name"] == "jterator":
                    step["args"]["pipe"] = "cp.pipe.json"
        (base / "workflow.json").write_text(json.dumps(wf_json, indent=2))
        capacity.reset_routing_history()
        run_cli(cli, ["workflow", "submit", "--root", str(other.root), "--description",
                      str(base / "workflow.json"), "--device", device])
        same_store(store, other, "YAML project vs JSON pipe")
        print("  the YAML project's store equals the JSON pipe's: labels and feature shards "
              "bit for bit")

        # 6. a few batches against the port's CPU run over a copy of the images
        cpu = base / "cpu"
        copy_part(store.root, cpu, "images")
        shutil.copytree(store.root / "project", cpu / "project")
        cpu_store = ExperimentStore.open(cpu)
        jt = get_step("jterator")(cpu_store, device="cpu")
        jt.init({**args, "batch_size": PROJECT_CPU_BATCH})
        batches = [0, len(jt.list_batches()) - 1]
        capacity.reset_routing_history()
        t0 = time.perf_counter()
        sites: list[int] = []
        for i in batches:
            jt.run(i)
            sites += list(jt.load_batch(i)["sites"])
        cpu_s = time.perf_counter() - t0
        outside, worst = hold_batch(store, cpu_store, sites, CARD_TIERS, gate=True)
        print(f"  CPU hold: the first and last of {len(jt.list_batches())} batches of "
              f"{PROJECT_CPU_BATCH} ({len(sites)} sites, {cpu_s:.2f} s on the CPU): labels, "
              "counts and metadata exact, features by CARD_TIERS (largest |card - cpu| "
              + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + ")")

        # 7. the exports
        out = base / "export"
        exports = {}

        def export(title, argv, path):
            t = time.perf_counter()
            run_cli(cli, ["export", "--root", root, "--device", device, *argv, "--out",
                          str(path)])
            seconds = time.perf_counter() - t
            exports[title] = {"s": round(seconds, 4),
                              "MiB_per_s": round(_mib_per_s(_tree_bytes(path), seconds), 2)}

        feats = store.read_features("nuclei")
        export("parquet", ["--objects", "nuclei"], out / "nuclei.parquet")
        back = parquet.read_table(out / "nuclei.parquet")
        if list(back) != list(feats) or any(not np.array_equal(back[k], feats[k])
                                            for k in feats):
            raise SmokeFailure("export: the Parquet table differs from the feature store")
        export("csv", ["--objects", "nuclei"], out / "nuclei.csv")
        lines = (out / "nuclei.csv").read_text().splitlines()
        if lines[0] != ",".join(feats) or len(lines) != len(feats["label"]) + 1:
            raise SmokeFailure("export: the CSV table has the wrong header or row count")
        export("geojson", ["--objects", "nuclei", "--simplify", "1.0"], out / "nuclei.geojson")
        polys = [parquet.read_table(p) for p in sorted(
            (store.root / "segmentations").glob("nuclei_polygons_*.parquet"))]
        n_polys = sum(len(t["label"]) for t in polys)
        fc = json.loads((out / "nuclei.geojson").read_text())
        if len(fc["features"]) != n_polys or n_polys != len(feats["label"]):
            raise SmokeFailure(f"export: {len(fc['features'])} GeoJSON features for {n_polys} "
                               f"polygons and {len(feats['label'])} nuclei")
        export("images", ["--images", "0"], out / "dapi")
        tifs = sorted((out / "dapi").glob("*.tif"))
        dapi = store.read_sites(None, channel=0)
        first = read_tiff_page_py(tifs[0], 0)
        if len(tifs) != n or not np.array_equal(first, dapi[0]):
            raise SmokeFailure("export: the DAPI images differ from the store")
        zarr = out / "ngff" / "phase11.zarr"
        export("ngff", ["--ngff", "--ngff-labels", "nuclei,cells"], zarr)
        exports["ngff"]["files"] = sum(1 for p in zarr.rglob("*") if p.is_file())
        print("  exports (s, MiB/s of output): " + json.dumps(exports))

        # 8. the NGFF plate back in, into a fresh store on the card
        fresh = base / "reingest"
        run_cli(cli, ["create", "--root", str(fresh), "--name", "reingest"])
        engine.WorkflowDescription.canonical({
            "metaconfig": {"source_dir": str(zarr.parent), "handler": "ngff",
                           "sites_per_well_x": SITES_PER_WELL[1]},
            "imextract": {}}).save(fresh / "workflow" / "workflow.yaml")
        t0 = time.perf_counter()
        run_cli(cli, ["workflow", "submit", "--root", str(fresh), "--device", device])
        ingest_s = time.perf_counter() - t0
        again = ExperimentStore.open(fresh)
        n_files = 2 * n  # one level-0 chunk file a plane
        if again.n_sites != n:
            raise SmokeFailure(f"reingest: {again.n_sites} sites, expected {n}")
        for c, ch in enumerate(store.experiment.channels):
            c2 = [x.name for x in again.experiment.channels].index(ch.name)
            if not np.array_equal(again.read_sites(None, channel=c2),
                                  store.read_sites(None, channel=c)):
                raise SmokeFailure(f"reingest: {ch.name} pixels differ from the original")
        print(f"  NGFF re-ingest: metaconfig --handler ngff -> imextract on {device}: {n} sites "
              f"x 2 channels pixel-equal, {n_files / ingest_s:.1f} files/s "
              f"({ingest_s:.3f} s)")

        # 9. cleanup
        run_cli(cli, ["workflow", "cleanup", "--root", root, "--device", device])
        left = [str(p.relative_to(store.root)) for sub in ("segmentations", "features")
                for p in (store.root / sub).rglob("*") if p.is_file()]
        left += [str(p.relative_to(store.root)) for p in store.workflow_dir.rglob("batch_*.json")]
        if (store.workflow_dir / "ledger.jsonl").exists():
            left.append("workflow/ledger.jsonl")
        left += [f"registration {r}" for r in MapobjectTypeRegistry(store.root).names()]
        if left:
            raise SmokeFailure(f"cleanup left {left[:5]}")
        if not yamlio.load(wf_path):
            raise SmokeFailure("cleanup removed workflow.yaml")
        phase_s = time.perf_counter() - started
        print("  cleanup: no step output, batch plan, registration or ledger left")
        line = {"cell": "project_yaml_p96x4_256", "sites": n,
                "submit_sites_per_s": round(n / submit_s, 1), "submit_s": round(submit_s, 3),
                "step_walls_s": walls, "launches": launches, "exports": exports,
                "ngff_write_MiB_per_s": exports["ngff"]["MiB_per_s"],
                "reingest_files_per_s": round(n_files / ingest_s, 1),
                "cpu_hold_sites": len(sites), "phase_s": round(phase_s, 1), "card": card}
        print("project: " + json.dumps(line))
        return line
    finally:
        shutil.rmtree(base, ignore_errors=True)


# ------------------------------------------------------------------ phase 13
#: sha256 of :func:`jpeg_sites` encoded by the port's JPEG encoder
#: (quality 95) and decoded by ``cv2.imdecode`` (pinned by
#: ``tests/test_torch_jpeg.py``): phase 13's JPEG CZI well must decode to it
JPEG_DIGEST = "263e1ad0c50d96f347c8d5c8a4879c4479c50ad9223cab090a8d414a41c3793b"


def jpeg_sites(n: int = 4, size: int = SIZE, seed: int = SEED):
    """``(n, size, size)`` uint8 grey sites for phase 13's JPEG files:
    noise around 40 and 12 discs a site, brightest at their centres,
    made with integer arithmetic only, so the pinned digest holds on any
    machine."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = rng.integers(30, 50, (n, size, size)).astype(np.int64)
    yy, xx = np.mgrid[0:size, 0:size]
    margin = size // 10
    for s in range(n):
        for _ in range(12):
            y, x = rng.integers(margin, size - margin, 2)
            r2 = int(rng.integers(5, 12)) ** 2
            d2 = (yy - y) ** 2 + (xx - x) ** 2
            out[s] += np.where(d2 < r2, 180 - (d2 * 100) // r2, 0)
    return np.clip(out, 0, 255).astype(np.uint8)


def jpeg_digest(planes) -> str:
    """sha256 of decoded JPEG planes, concatenated in order."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for p in planes:
        h.update(np.ascontiguousarray(p, np.uint8).tobytes())
    return h.hexdigest()


# ------------------------------------------------------------------ phase 12
#: phase 12's jterator batches on the CPU (the first of them held)
CONTAINER_CPU_BATCH = 16


def container_wells(cw, px: dict, src: Path) -> dict:
    """One well of every container format but ND2, from the plate's first
    well (4 sites x DAPI and Actin), each written by the port's writer
    into its own directory under ``src``: name -> (directory, the
    handler ``auto`` must resolve, the written planes as
    ``{(channel, zplane): [planes]}``, sites, ``{file: inspect keys}``)."""
    import numpy as np

    d, a = px["DAPI"][:4], px["Actin"][:4]
    h, w = d.shape[1:]
    named = {("DAPI", 0): list(d), ("Actin", 0): list(a)}
    one = {("C00", 0): [d[0]], ("C01", 0): [a[0]]}
    dims = {"height": h, "width": w}
    out = {}

    def well(name, handler, planes, n_sites, files):
        out[name] = (src / name, handler, planes, n_sites, files)
        (src / name).mkdir(parents=True)
        return src / name

    p = well("czi", "czi", named, 4, {"scan_A01.czi": {
        **dims, "format": "CZI", "n_scenes": 4, "n_tiles": 1, "n_channels": 2,
        "channel_names": ["DAPI", "Actin"]}})
    cw.write_czi(p / "scan_A01.czi", np.stack([d, a], 1), channel_names=["DAPI", "Actin"])
    p = well("czi_mosaic", "czi", named, 4, {"mosaic_A01.czi": {
        **dims, "format": "CZI", "n_scenes": 1, "n_tiles": 4, "n_channels": 2}})
    cw.write_czi(p / "mosaic_A01.czi", np.stack([d, a], 1), n_tiles=4,
                 tile_origins=[(0, 0), (0, w), (h, 0), (h, w)], channel_names=["DAPI", "Actin"])
    p = well("lif", "lif", named, 4, {"A01.lif": {
        **dims, "format": "LIF", "n_series": 4, "channel_names": ["DAPI", "Actin"]}})
    cw.write_lif(p / "A01.lif", [np.stack([d[s], a[s]])[:, None, None] for s in range(4)],
                 lut_names=["DAPI", "Actin"])
    p = well("dv", "dv", one, 1, {"A01.dv": {
        **dims, "format": "DV", "n_channels": 2, "n_zplanes": 1, "n_tpoints": 1}})
    cw.write_dv(p / "A01.dv", np.stack([d[0], a[0]])[:, None, None])
    p = well("stk", "stk", {("C00", 0): [d[0]], ("C00", 1): [a[0]]}, 1, {"A01.stk": {
        **dims, "format": "STK", "n_zplanes": 2, "n_channels": 1}})
    cw.write_stk(p / "A01.stk", np.stack([d[0], a[0]]))
    p = well("lsm", "lsm", one, 1, {"A01.lsm": {
        **dims, "format": "LSM", "n_channels": 2, "n_zplanes": 1, "n_tpoints": 1}})
    cw.write_lsm(p / "A01.lsm", np.stack([d[0], a[0]])[None, None], compression=5, predictor=2)
    p = well("oib", "olympus", one, 1, {"A01.oib": {
        **dims, "format": "OIB", "n_channels": 2, "n_zplanes": 1, "n_tpoints": 1}})
    cw.write_oib(p / "A01.oib", np.stack([d[0], a[0]])[:, None, None])
    p = well("oif", "olympus", one, 1, {"A01.oif": {
        **dims, "format": "OIF", "n_channels": 2, "n_zplanes": 1, "n_tpoints": 1}})
    cw.write_oif(p, "A01", np.stack([d[0], a[0]])[:, None, None])
    p = well("flex", "flex", named, 4, {"001001000.flex": {
        **dims, "format": "Flex", "n_fields": 4, "n_channels": 2,
        "channel_names": ["DAPI", "Actin"]}})
    cw.write_flex(p / "001001000.flex", np.stack([d, a], 1).reshape(8, h, w),
                  channel_names=("DAPI", "Actin"))
    return out


def store_planes(store) -> dict:
    """``{(channel, zplane): sorted plane digests}`` of every stored site."""
    import hashlib

    import numpy as np

    out = {}
    exp = store.experiment
    for ch in exp.channels:
        for z in range(exp.n_zplanes):
            stack = store.read_sites(None, channel=ch.index, zplane=z)
            out[(ch.name, z)] = sorted(hashlib.sha1(np.ascontiguousarray(p).tobytes())
                                       .hexdigest() for p in stack)
    return out


def digests(planes: dict) -> dict:
    """:func:`store_planes` of written ``{(channel, zplane): [planes]}``."""
    import hashlib

    import numpy as np

    return {k: sorted(hashlib.sha1(np.ascontiguousarray(p, np.uint16).tobytes()).hexdigest()
                      for p in v) for k, v in planes.items()}


def submit_seconds(engine, store) -> dict:
    """Each step's wall from the run ledger."""
    return {step: float(e["elapsed"]) for step, e in engine.RunLedger(
        store.workflow_dir / "ledger.jsonl").status().items()}


def phase_containers(torch, wrappers, card, device: str = "cuda") -> dict:
    """Phase 12, ``containers_p96x4_256``: microscope container files on
    the card.  Phase 5's plate (96 wells at 2x2 sites of 256x256, DAPI and
    Actin, seed 0) written as one ND2 a well by the port's ``write_nd2``
    (an XY loop over a 2x2 stage grid, the channel names in the picture
    metadata); ``create``, then ``workflow submit --device cuda`` of
    metaconfig (``handler: auto``, which must resolve ``nd2``) ->
    imextract -> jterator (config 3, batches of 64, ``max_objects=256``)
    with the launch counters set to 0 just before and read just after (1,
    1, 1, 2 per launched batch).  Holds: the ingested store equals the
    generator's pixels site by site on the stage grid; ``file_mapping.json``
    and ``experiment.ome.xml`` equal a CPU metaconfig's over the same
    directory; the sites of jterator's first CPU batch of
    :data:`CONTAINER_CPU_BATCH` have the card's labels exactly and its
    features within ``CARD_TIERS``.  Then one well of each other format
    (:func:`container_wells`: CZI, a CZI 2x2 mosaic scene, LIF, DV, STK,
    LSM with LZW strips and predictor 2, OIB, OIF, Opera FLEX) through
    ``metaconfig --handler auto`` and imextract on the card: the handler
    resolved, the store's planes equal the written ones, the mosaic's
    tiles on their grid; ``inspect --json`` over every file and directory
    with the written keys; an STK its reader declines read through the
    TIFF path.  Last the ingest bench (:func:`benchmarks.measure_ingest`:
    raw TIFF, ND2, CZI at 96 sites of 256x256, pooled, one worker, cold).
    Prints the ``containers:`` line.  The directory is removed at the end."""
    import numpy as np

    from tmlibrary_tpu_torch import benchmarks, capacity, cli, container_writers, readers
    from tmlibrary_tpu_torch.models.experiment import Experiment
    from tmlibrary_tpu_torch.models.store import ExperimentStore
    from tmlibrary_tpu_torch.workflow import engine, get_step
    from tmlibrary_tpu_torch.workflow.steps.imextract import ImageExtractor

    started = time.perf_counter()
    base = Path(__file__).resolve().parent / "build" / f"phase12.{os.getpid()}"
    shutil.rmtree(base, ignore_errors=True)
    try:
        # 1. the plate as one ND2 a well
        t0 = time.perf_counter()
        wells = [(r, c) for r in range(PLATE[0]) for c in range(PLATE[1])]
        per_well = SITES_PER_WELL[0] * SITES_PER_WELL[1]
        n = len(wells) * per_well
        data = benchmarks.synthetic_cell_painting_batch(n, size=SIZE, seed=SEED)
        px = {ch: data[ch].astype(np.uint16) for ch in ("DAPI", "Actin")}
        del data
        src = base / "nd2"
        src.mkdir(parents=True)
        points = [(float(y * SIZE), float(x * SIZE)) for y in range(SITES_PER_WELL[0])
                  for x in range(SITES_PER_WELL[1])]
        for i, (r, c) in enumerate(wells):
            sl = slice(i * per_well, (i + 1) * per_well)
            container_writers.write_nd2(
                src / f"plate_{chr(65 + r)}{c + 1:02d}.nd2",
                np.stack([px["DAPI"][sl], px["Actin"][sl]], -1),
                loops=[(2, per_well, points)], channel_names=["DAPI", "Actin"])
        files = sorted(src.iterdir())
        mbytes = sum(f.stat().st_size for f in files) / 2**20
        write_s = time.perf_counter() - t0
        args = {"pipe": "cp.pipe.json", "batch_size": STEP_BATCH, "max_objects": MAX_OBJECTS}
        desc_path = base / "workflow.json"
        engine.WorkflowDescription.canonical({
            "metaconfig": {"source_dir": str(src), "handler": "auto"},
            "imextract": {}, "jterator": args}).save(desc_path)
        root = base / "card"
        run_cli(cli, ["create", "--root", str(root), "--name", "containers"])
        (root / "cp.pipe.json").write_text(json.dumps(benchmarks.CELL_PAINTING_PIPE))
        print(f"phase 12, containers_p96x4_256: metaconfig (handler auto) -> imextract -> "
              f"jterator (config 3) through `workflow submit --device {device}` from "
              f"{len(files)} ND2 files, one a well ({mbytes:.1f} MiB, {PLATE[0]}x{PLATE[1]} "
              f"wells at {SITES_PER_WELL[0]}x{SITES_PER_WELL[1]} sites of {SIZE}x{SIZE}, DAPI "
              f"and Actin; written by the port's write_nd2 in {write_s:.2f} s) on {card}")

        # 2. the submit, launches read around it
        capacity.reset_routing_history()
        if device == "cuda":
            torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
            if hasattr(w, "routes"):
                w.routes = dict.fromkeys(w.routes, 0)
        t0 = time.perf_counter()
        summary = json.loads(run_cli(cli, ["workflow", "submit", "--root", str(root),
                                           "--description", str(desc_path),
                                           "--device", device]))
        if device == "cuda":
            torch.cuda.synchronize()
        submit_s = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        store = ExperimentStore.open(root)
        events = engine.RunLedger(store.workflow_dir / "ledger.jsonl").events()
        steps = ["metaconfig", "imextract", "jterator"]
        if list(summary) != steps:
            raise SmokeFailure(f"containers: summary {list(summary)}")
        jt = [e["result"] for e in events
              if e["event"] == "batch_done" and e["step"] == "jterator"]
        n_launched = len(jt) + sum(r.get("bucket_escalations", 0) for r in jt)
        expected = {k: 0 for k in wrappers}
        expected.update({"fill_holes_flood": n_launched, "cc_min_propagate": n_launched,
                         "watershed_flood": n_launched, "grouped_stats": 2 * n_launched})
        if launches != expected:
            raise SmokeFailure(f"containers: launches {launches}, expected {expected}")
        mapping = json.loads((store.workflow_dir / "metaconfig" / "file_mapping.json")
                             .read_text())
        if not mapping or any(not e["path"].endswith(".nd2") for e in mapping):
            raise SmokeFailure("containers: the file mapping holds other files than the ND2s")
        walls = submit_seconds(engine, store)
        print(f"  submit: {n / submit_s:.1f} sites/s ({submit_s:.3f} s of command), step walls "
              "(s) " + ", ".join(f"{s} {walls[s]:.3f}" for s in steps) + f"; launches "
              f"{launches} over {len(jt)} batches and {n_launched - len(jt)} escalation "
              f"re-launches; on {card}")
        rates = {"nd2": {"files_per_s": len(files) / walls["imextract"],
                         "MiB_per_s": mbytes / walls["imextract"]}}
        print(f"    imextract nd2: {len(files)} files in {walls['imextract']:.3f} s = "
              f"{rates['nd2']['files_per_s']:.1f} files/s ({rates['nd2']['MiB_per_s']:.1f} "
              f"MiB/s); on {card}")

        # 3. holds: the pixels on the stage grid, metaconfig against the CPU's,
        # jterator's first CPU batch
        order = [((ref.well_row * PLATE[1] + ref.well_column) * per_well
                  + ref.site_y * SITES_PER_WELL[1] + ref.site_x)
                 for ref in store.experiment.sites()]
        if sorted(order) != list(range(n)):
            raise SmokeFailure("containers: the stage grid does not cover every site once")
        for ch, values in px.items():
            got = store.read_sites(None, channel=store.experiment.channel_index(ch))
            if not np.array_equal(got, values[order]):
                raise SmokeFailure(f"containers: the ingested {ch} pixels differ from the ND2s'")
        meta = ExperimentStore.create(base / "meta", Experiment(
            name="containers", plates=[], channels=[], site_height=1, site_width=1))
        step = get_step("metaconfig")(meta, device="cpu")
        step.init({"source_dir": str(src), "handler": "auto"})
        step.run(0)
        for name in ("file_mapping.json", "experiment.ome.xml"):
            if (store.workflow_dir / "metaconfig" / name).read_text() != \
                    (meta.workflow_dir / "metaconfig" / name).read_text():
                raise SmokeFailure(f"containers: {name} differs from the CPU metaconfig's")
        copy_part(store.root, base / "cpu", "images")
        cpu = ExperimentStore.open(base / "cpu")
        (cpu.root / "cp.pipe.json").write_text(json.dumps(benchmarks.CELL_PAINTING_PIPE))
        capacity.reset_routing_history()
        t0 = time.perf_counter()
        jt_cpu = get_step("jterator")(cpu, device="cpu")
        jt_cpu.init({**args, "batch_size": CONTAINER_CPU_BATCH})
        jt_cpu.run(0)
        cpu_s = time.perf_counter() - t0
        sites = list(jt_cpu.load_batch(0)["sites"])
        _, worst = hold_batch(store, cpu, sites, CARD_TIERS, gate=True)
        print(f"  holds: the {n} sites x 2 channels ingested equal the ND2s' pixels on the "
              "stage grid; file_mapping.json and experiment.ome.xml equal a CPU metaconfig's; "
              f"jterator's first CPU batch ({len(sites)} sites, {cpu_s:.2f} s): labels exact, "
              "features within CARD_TIERS, largest |card - cpu| by family "
              + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items())))
        shutil.rmtree(base / "cpu")
        shutil.rmtree(base / "meta")

        # 4. one well of every other format
        held = ["nd2"]
        others = container_wells(container_writers, px, base / "wells")
        inspect_args = []
        for name, (wsrc, want_handler, planes, n_sites, wfiles) in others.items():
            wroot = base / f"store_{name}"
            run_cli(cli, ["create", "--root", str(wroot), "--name", name])
            wdesc = base / f"{name}.json"
            engine.WorkflowDescription.canonical({
                "metaconfig": {"source_dir": str(wsrc), "handler": "auto"},
                "imextract": {}}).save(wdesc)
            run_cli(cli, ["workflow", "submit", "--root", str(wroot), "--description",
                          str(wdesc), "--device", device])
            wstore = ExperimentStore.open(wroot)
            wwalls = submit_seconds(engine, wstore)
            mapping = json.loads((wstore.workflow_dir / "metaconfig" / "file_mapping.json")
                                 .read_text())
            n_files = len({e["path"] for e in mapping})
            nbytes = sum(p.stat().st_size for p in wsrc.rglob("*") if p.is_file())
            if wstore.n_sites != n_sites or store_planes(wstore) != digests(planes):
                raise SmokeFailure(f"containers: the {name} store ({wstore.n_sites} sites) "
                                   "differs from the written planes")
            if name == "czi_mosaic":
                grid = {(r.site_y, r.site_x) for r in wstore.experiment.sites()}
                dapi = wstore.read_sites(None, channel=wstore.experiment.channel_index("DAPI"))
                tiles = [px["DAPI"][(r.site_y * 2 + r.site_x)] for r in wstore.experiment.sites()]
                if grid != {(0, 0), (0, 1), (1, 0), (1, 1)} or \
                        not np.array_equal(dapi, np.stack(tiles)):
                    raise SmokeFailure(f"containers: mosaic tiles off their grid {sorted(grid)}")
            rates[name] = {"files_per_s": n_files / wwalls["imextract"],
                           "MiB_per_s": nbytes / 2**20 / wwalls["imextract"],
                           "planes": sum(len(v) for v in planes.values())}
            inspect_args += [str(wsrc / f) for f in wfiles] + [str(wsrc)]
            held.append(name)

        # 5. inspect over every file and directory
        lines = [json.loads(x) for x in run_cli(
            cli, ["inspect", "--json", *inspect_args, str(src / "plate_A01.nd2"),
                  str(src)]).splitlines()]
        by_file = {x["file"]: x for x in lines}
        for name, (wsrc, want_handler, planes, n_sites, wfiles) in others.items():
            for f, keys in wfiles.items():
                got = by_file[str(wsrc / f)]
                if {k: got.get(k) for k in keys} != keys:
                    raise SmokeFailure(f"inspect {name}/{f}: {got}, expected {keys}")
            got = by_file[str(wsrc)]
            if (got.get("handler"), got.get("n_sites"), got.get("n_skipped_files")) != \
                    (want_handler, n_sites, 0):
                raise SmokeFailure(f"inspect {name}: {got}")
        nd2 = by_file[str(src / "plate_A01.nd2")]
        want = {"format": "ND2", "n_sequences": per_well, "n_components": 2,
                "loops": [["XY", per_well]], "channel_names": ["DAPI", "Actin"],
                "height": SIZE, "width": SIZE}
        if {k: nd2.get(k) for k in want} != want or by_file[str(src)].get("handler") != "nd2" \
                or by_file[str(src)].get("n_sites") != n:
            raise SmokeFailure(f"inspect nd2: {nd2} / {by_file[str(src)]}")

        # 6. an STK its reader declines, through the TIFF path
        declined = base / "declined.stk"
        container_writers.write_packbits_stk(declined, px["DAPI"][0])
        if readers.read_container_plane(declined, 0) is not None or not np.array_equal(
                ImageExtractor._read_plane(str(declined), 0, SIZE, SIZE), px["DAPI"][0]) or \
                not np.array_equal(readers.ImageReader(declined).read(0), px["DAPI"][0]):
            raise SmokeFailure("containers: the declined STK did not read through the TIFF path")
        held.append("stk_declined")
        print(f"  {len(others)} other wells through metaconfig --handler auto -> imextract on "
              f"{device}: stores equal the written planes, inspect --json keys equal what was "
              "written, the declined STK read through the TIFF path; imextract files/s, MiB/s: "
              + ", ".join(f"{k} {v['files_per_s']:.1f}, {v['MiB_per_s']:.1f}"
                          for k, v in rates.items()) + f"; on {card}")

        # 7. the ingest bench
        t0 = time.perf_counter()
        bench = benchmarks.measure_ingest(base / "bench", size=SIZE, device=device)
        bench_s = time.perf_counter() - t0
        print(f"  ingest bench ({bench['sites']} sites of {SIZE}x{SIZE}, "
              f"{bench['timing_methodology']}, {bench_s:.1f} s): Mpix/s pooled / one worker / cold "
              f"({benchmarks.INGEST_COLD_MS} ms a plane) pooled / cold one worker: "
              + "; ".join(f"{fmt} {r['mpix_per_sec']:.1f} / {r['single_thread_mpix_per_sec']:.1f}"
                          f" / {r['cold_mpix_per_sec']:.1f} / "
                          f"{r['cold_single_thread_mpix_per_sec']:.1f}"
                          for fmt, r in bench["per_format"].items()) + f"; on {card}")
        phase_s = time.perf_counter() - started
        line = {"cell": "containers_p96x4_256", "formats": held, "sites": n,
                "submit_sites_per_s": n / submit_s, "submit_s": submit_s,
                "step_walls_s": walls, "launches": launches,
                "imextract": rates, "ingest_bench": bench["per_format"],
                "cpu_hold_sites": len(sites), "phase_s": phase_s, "card": card}
        print("containers: " + json.dumps(line))
        return line
    finally:
        shutil.rmtree(base, ignore_errors=True)


#: phase 13's jterator batch on the CPU (the first of the batches held)
CODEC_CPU_BATCH = 16


def codec_wells(cw, px: dict, src: Path, native) -> dict:
    """One well of each other codec input for phase 13, from the plate's
    first well (4 sites x DAPI and Actin) or :func:`jpeg_sites`, each
    written by the port's writers into its own directory under ``src``:
    name -> (directory, metaconfig arguments, the planes the store must
    hold as ``{(channel, zplane): [planes]}``, sites)."""
    import numpy as np

    d, a = px["DAPI"][:4], px["Actin"][:4]
    g8 = np.minimum(d >> 4, 255).astype(np.uint8)
    jsites = jpeg_sites()
    decoded = [native.jpeg_decode_array(native.jpeg_encode(p, quality=95)) for p in jsites]
    named = {("DAPI", 0): list(d), ("Actin", 0): list(a)}
    one = {("DAPI", 0): [d[0]], ("Actin", 0): [a[0]]}
    out = {}

    def well(name, args, planes, n_sites):
        (src / name).mkdir(parents=True)
        out[name] = (src / name, {"source_dir": str(src / name), **args}, planes, n_sites)
        return src / name

    auto = {"handler": "auto"}
    cw.write_czi(well("czi_zstd0", auto, named, 4) / "scan_A01.czi", np.stack([d, a], 1),
                 compression=5, channel_names=["DAPI", "Actin"])
    cw.write_czi(well("czi_gray8_zstd0", auto, {("DAPI", 0): list(g8)}, 4) / "scan_A01.czi",
                 g8[:, None], pixel_type=0, compression=5, channel_names=["DAPI"])
    cw.write_czi(well("czi_gray8_jpeg", auto, {("DAPI", 0): decoded}, 4) / "scan_A01.czi",
                 jsites[:, None], pixel_type=0, compression=1, channel_names=["DAPI"])
    jpg = {"pattern": r"(?P<well>[A-Z]{1,2}\d{2})_s(?P<site>\d+)_(?P<channel>[A-Za-z0-9\-]+)"
                      r"\.jpg$"}
    cw.write_jpeg_sites(well("jpg_sites", jpg, {("DAPI", 0): decoded}, 4),
                        {("A01", s, "DAPI"): jsites[s] for s in range(4)})
    cw.write_ims(well("ims", auto, one, 1) / "A01.ims", np.stack([d[0], a[0]])[:, None, None],
                 ["DAPI", "Actin"])
    cw.write_ims(well("ims_chunked_gzip", auto, one, 1) / "A01.ims",
                 np.stack([d[0], a[0]])[:, None, None], ["DAPI", "Actin"],
                 chunks=(1, 96, 96), compression="gzip")
    return out


def phase_codecs(torch, wrappers, card, device: str = "cuda") -> dict:
    """Phase 13, ``czi_zstd_p96x4_256``: the codecs the containers need,
    on the card.  Phase 5's plate (96 wells at 2x2 sites of 256x256, DAPI
    and Actin, seed 0) written as one CZI a well with zstd1 hi-lo
    subblocks (ZEN's default) by the port's writer and Zstandard encoder;
    ``workflow submit --device cuda`` of metaconfig (``handler: auto``,
    which must resolve ``czi``) -> imextract -> jterator (config 3,
    batches of 64, ``max_objects=256``) with the launch counters set to 0
    just before and read just after (1, 1, 1, 2 a launched batch).
    Holds: the store equals the generator's pixels site by site; the
    sites of jterator's first CPU batch of :data:`CODEC_CPU_BATCH` have
    the card's labels exactly and its features within ``CARD_TIERS``.
    Then one well each (:func:`codec_wells`: a zstd0 CZI, a Gray8 zstd0
    CZI, a Gray8 JPEG CZI, a directory of grey ``.jpg`` sites, an
    ``.ims`` with contiguous data and one chunked and deflated with chunk
    padding) through metaconfig (``auto``; the JPEG sites by ``pattern``)
    and imextract on the card: the store's planes equal the written ones,
    the JPEG CZI's decode to :data:`JPEG_DIGEST`.  Last corilla over the
    plate, ``export --illumstats 0`` read back with ``DatasetReader``,
    equal to ``read_illumstats``.  Prints the phase's seconds, submit
    sites/s, zstd decode MiB/s, JPEG decode Mpix/s and HDF5 chunked-gzip
    read MiB/s, and the ``codecs:`` line.  The directory is removed at
    the end."""
    import numpy as np

    from tmlibrary_tpu_torch import benchmarks, capacity, cli, container_writers, native, readers
    from tmlibrary_tpu_torch.models.experiment import Experiment
    from tmlibrary_tpu_torch.models.store import ExperimentStore
    from tmlibrary_tpu_torch.workflow import engine, get_step

    started = time.perf_counter()
    base = Path(__file__).resolve().parent / "build" / f"phase13.{os.getpid()}"
    shutil.rmtree(base, ignore_errors=True)
    try:
        # 1. the plate as one zstd1 hi-lo CZI a well
        t0 = time.perf_counter()
        wells = [(r, c) for r in range(PLATE[0]) for c in range(PLATE[1])]
        per_well = SITES_PER_WELL[0] * SITES_PER_WELL[1]
        n = len(wells) * per_well
        data = benchmarks.synthetic_cell_painting_batch(n, size=SIZE, seed=SEED)
        px = {ch: data[ch].astype(np.uint16) for ch in ("DAPI", "Actin")}
        del data
        src = base / "czi"
        src.mkdir(parents=True)
        for i, (r, c) in enumerate(wells):
            sl = slice(i * per_well, (i + 1) * per_well)
            container_writers.write_czi(
                src / f"plate_{chr(65 + r)}{c + 1:02d}.czi",
                np.stack([px["DAPI"][sl], px["Actin"][sl]], 1), compression=6, hilo=True,
                channel_names=["DAPI", "Actin"])
        files = sorted(src.iterdir())
        mbytes = sum(f.stat().st_size for f in files) / 2**20
        raw_mib = 2 * n * SIZE * SIZE * 2 / 2**20
        write_s = time.perf_counter() - t0
        args = {"pipe": "cp.pipe.json", "batch_size": STEP_BATCH, "max_objects": MAX_OBJECTS}
        desc_path = base / "workflow.json"
        engine.WorkflowDescription.canonical({
            "metaconfig": {"source_dir": str(src), "handler": "auto"},
            "imextract": {}, "jterator": args}).save(desc_path)
        root = base / "card"
        run_cli(cli, ["create", "--root", str(root), "--name", "codecs"])
        (root / "cp.pipe.json").write_text(json.dumps(benchmarks.CELL_PAINTING_PIPE))
        print(f"phase 13, czi_zstd_p96x4_256: metaconfig (handler auto) -> imextract -> "
              f"jterator (config 3) through `workflow submit --device {device}` from "
              f"{len(files)} CZI files with zstd1 hi-lo subblocks, one a well ({mbytes:.1f} MiB "
              f"for {raw_mib:.1f} MiB of planes, {PLATE[0]}x{PLATE[1]} wells at "
              f"{SITES_PER_WELL[0]}x{SITES_PER_WELL[1]} sites of {SIZE}x{SIZE}, DAPI and "
              f"Actin; written by the port's write_czi in {write_s:.2f} s) on {card}")

        # 2. the submit, launches read around it
        capacity.reset_routing_history()
        if device == "cuda":
            torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
            if hasattr(w, "routes"):
                w.routes = dict.fromkeys(w.routes, 0)
        t0 = time.perf_counter()
        summary = json.loads(run_cli(cli, ["workflow", "submit", "--root", str(root),
                                           "--description", str(desc_path),
                                           "--device", device]))
        if device == "cuda":
            torch.cuda.synchronize()
        submit_s = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        store = ExperimentStore.open(root)
        events = engine.RunLedger(store.workflow_dir / "ledger.jsonl").events()
        steps = ["metaconfig", "imextract", "jterator"]
        if list(summary) != steps:
            raise SmokeFailure(f"codecs: summary {list(summary)}")
        jt = [e["result"] for e in events
              if e["event"] == "batch_done" and e["step"] == "jterator"]
        n_launched = len(jt) + sum(r.get("bucket_escalations", 0) for r in jt)
        expected = {k: 0 for k in wrappers}
        expected.update({"fill_holes_flood": n_launched, "cc_min_propagate": n_launched,
                         "watershed_flood": n_launched, "grouped_stats": 2 * n_launched})
        if launches != expected:
            raise SmokeFailure(f"codecs: launches {launches}, expected {expected}")
        mapping = json.loads((store.workflow_dir / "metaconfig" / "file_mapping.json")
                             .read_text())
        if not mapping or any(not e["path"].endswith(".czi") for e in mapping):
            raise SmokeFailure("codecs: the file mapping holds other files than the CZIs")
        walls = submit_seconds(engine, store)
        print(f"  submit: {n / submit_s:.1f} sites/s ({submit_s:.3f} s of command), step walls "
              "(s) " + ", ".join(f"{s} {walls[s]:.3f}" for s in steps) + f"; imextract "
              f"{len(files) / walls['imextract']:.1f} files/s ({raw_mib / walls['imextract']:.1f}"
              f" MiB/s of planes); launches {launches} over {len(jt)} batches and "
              f"{n_launched - len(jt)} escalation re-launches; on {card}")

        # 3. holds: the pixels site by site, jterator's first CPU batch
        order = [((ref.well_row * PLATE[1] + ref.well_column) * per_well
                  + ref.site_y * SITES_PER_WELL[1] + ref.site_x)
                 for ref in store.experiment.sites()]
        if sorted(order) != list(range(n)):
            raise SmokeFailure("codecs: the scenes do not cover every site once")
        for ch, values in px.items():
            got = store.read_sites(None, channel=store.experiment.channel_index(ch))
            if not np.array_equal(got, values[order]):
                raise SmokeFailure(f"codecs: the ingested {ch} pixels differ from the CZIs'")
        copy_part(store.root, base / "cpu", "images")
        cpu = ExperimentStore.open(base / "cpu")
        (cpu.root / "cp.pipe.json").write_text(json.dumps(benchmarks.CELL_PAINTING_PIPE))
        capacity.reset_routing_history()
        t0 = time.perf_counter()
        jt_cpu = get_step("jterator")(cpu, device="cpu")
        jt_cpu.init({**args, "batch_size": CODEC_CPU_BATCH})
        jt_cpu.run(0)
        cpu_s = time.perf_counter() - t0
        sites = list(jt_cpu.load_batch(0)["sites"])
        _, worst = hold_batch(store, cpu, sites, CARD_TIERS, gate=True)
        print(f"  holds: the {n} sites x 2 channels ingested equal the generator's pixels site "
              f"by site; jterator's first CPU batch ({len(sites)} sites, {cpu_s:.2f} s): labels "
              "exact, features within CARD_TIERS, largest |card - cpu| by family "
              + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items())))
        shutil.rmtree(base / "cpu")

        # 4. one well of each other codec input
        others = codec_wells(container_writers, px, base / "wells", native)
        rates = {}
        for name, (wsrc, margs, planes, n_sites) in others.items():
            wroot = base / f"store_{name}"
            run_cli(cli, ["create", "--root", str(wroot), "--name", name])
            wdesc = base / f"{name}.json"
            engine.WorkflowDescription.canonical({"metaconfig": margs, "imextract": {}}) \
                .save(wdesc)
            run_cli(cli, ["workflow", "submit", "--root", str(wroot), "--description",
                          str(wdesc), "--device", device])
            wstore = ExperimentStore.open(wroot)
            if wstore.n_sites != n_sites or store_planes(wstore) != digests(planes):
                raise SmokeFailure(f"codecs: the {name} store ({wstore.n_sites} sites) "
                                   "differs from the written planes")
            if name == "czi_gray8_jpeg":
                got = wstore.read_sites(None, channel=0).astype(np.uint8)
                if jpeg_digest(got) != JPEG_DIGEST:
                    raise SmokeFailure(f"codecs: the JPEG CZI decodes to {jpeg_digest(got)}, "
                                       f"not the pinned {JPEG_DIGEST}")
            rates[name] = submit_seconds(engine, wstore)["imextract"]
        print(f"  {len(others)} wells through metaconfig and imextract on {device}: stores "
              "equal the written planes, the JPEG CZI's pixels hash to the pinned digest; "
              "imextract s: " + ", ".join(f"{k} {v:.3f}" for k, v in rates.items())
              + f"; on {card}")

        # 5. codec rates on the host: every subblock of the plate, the JPEG
        # sites, the chunked Imaris file
        t0 = time.perf_counter()
        for f in files:
            with readers.CZIReader(f) as r:
                for s in range(r.n_scenes):
                    for c in range(r.n_channels):
                        r.read_plane(s, c)
        zstd_mib_s = raw_mib / (time.perf_counter() - t0)
        streams = [native.jpeg_encode(p, quality=95) for p in jpeg_sites()]
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            for st in streams:
                native.jpeg_decode_array(st)
        jpeg_mpix_s = reps * len(streams) * SIZE * SIZE / 1e6 / (time.perf_counter() - t0)
        ims = others["ims_chunked_gzip"][0] / "A01.ims"
        t0 = time.perf_counter()
        for _ in range(reps):
            with readers.IMSReader(ims) as r:
                for page in range(r.n_channels):
                    r.read_plane_linear(page)
        hdf5_mib_s = reps * 2 * SIZE * SIZE * 2 / 2**20 / (time.perf_counter() - t0)
        print(f"  codecs on the host, one thread: zstd decode {zstd_mib_s:.1f} MiB/s (every "
              f"subblock of the plate through CZIReader), JPEG decode {jpeg_mpix_s:.1f} Mpix/s "
              f"({len(streams)} sites of {SIZE}x{SIZE}), HDF5 chunked-gzip read "
              f"{hdf5_mib_s:.1f} MiB/s (IMSReader, 96x96 chunks); on {card}")

        # 6. corilla over the plate, its statistics out as HDF5 and back
        t0 = time.perf_counter()
        corilla = get_step("corilla")(store, device=device)
        corilla.init({})
        for i in corilla.list_batches():
            corilla.run(i)
        corilla.collect()
        out = base / "illumstats_c0.h5"
        run_cli(cli, ["export", "--root", str(root), "--illumstats", "0", "--out", str(out)])
        want = store.read_illumstats(channel=0)
        with readers.DatasetReader(out) as r:
            pairs = [("stats/mean", "mean_log"), ("stats/std", "std_log"), ("stats/n", "n")]
            if "percentile_keys" in want:
                pairs += [("stats/percentiles/keys", "percentile_keys"),
                          ("stats/percentiles/values", "percentile_values")]
            for path, key in pairs:
                got = r.read(path)
                if got.dtype != want[key].dtype or not np.array_equal(got, want[key]):
                    raise SmokeFailure(f"codecs: exported {path} differs from read_illumstats")
        export_s = time.perf_counter() - t0
        print(f"  corilla over the plate and export --illumstats 0 ({out.stat().st_size} bytes, "
              f"{export_s:.2f} s with corilla): read back by DatasetReader equal to "
              f"read_illumstats ({', '.join(p for p, _ in pairs)}); on {card}")

        phase_s = time.perf_counter() - started
        line = {"cell": "czi_zstd_p96x4_256", "sites": n, "phase_s": phase_s,
                "submit_sites_per_s": n / submit_s, "submit_s": submit_s,
                "step_walls_s": walls, "launches": launches, "plate_mib": mbytes,
                "zstd_decode_mib_per_s": zstd_mib_s, "jpeg_decode_mpix_per_s": jpeg_mpix_s,
                "hdf5_chunked_gzip_read_mib_per_s": hdf5_mib_s, "wells": sorted(others),
                "cpu_hold_sites": len(sites), "card": card}
        print(f"  phase 13: {phase_s:.1f} s on {card}")
        print("codecs: " + json.dumps(line))
        return line
    finally:
        shutil.rmtree(base, ignore_errors=True)


# ------------------------------------------------------------------ phase 14
#: phase 14's experiments: 24 wells of 2x2 sites (96 sites of 256x256)
SERVE_WELLS = (4, 6)
#: jterator batch of the served jobs: 12 batches a job, more than the
#: pipelined window of 8, so a stop lands between batches of a job
SERVE_BATCH = 8
#: the burst's admission high watermark and its size
SERVE_MAX_QUEUE, SERVE_BURST, SERVE_LATE_BURST = 16, 40, 8
#: a burst job's experiment: one well of 2x2 sites, one batch
SERVE_BURST_WELLS = (1, 1)
#: pairs of telemetry on/off turns
SERVE_TELEMETRY_PAIRS = 10
#: the CPU hold's batch in phase 14
SERVE_CPU_BATCH = 8
ROWS_1_4 = ("fill_holes_flood", "cc_min_propagate", "watershed_flood", "grouped_stats")


def _pcts(values) -> dict:
    """p50/p95 of ``values`` as the SLO report takes them."""
    from tmlibrary_tpu_torch import slo

    vals = [float(v) for v in values]
    return {"p50": slo.quantile(vals, 0.5), "p95": slo.quantile(vals, 0.95), "n": len(vals)}


def _wait(cond, what: str, timeout: float, procs=(), every: float = 0.02) -> None:
    """Poll ``cond()`` every ``every`` seconds; fail after ``timeout``
    seconds or when one of ``procs`` has exited."""
    deadline = time.monotonic() + timeout
    while not cond():
        for proc in procs:
            if proc.poll() is not None:
                raise SmokeFailure(f"serve: {what}: a daemon exited {proc.returncode} first")
        if time.monotonic() > deadline:
            raise SmokeFailure(f"serve: {what}: not within {timeout:.0f} s")
        time.sleep(every)


def _run_span_s(engine, root: Path) -> float:
    """The engine's last ``run`` span in a store's workflow ledger: the
    same span whether the run was a direct submit or a served job."""
    spans = [e["elapsed"] for e in engine.RunLedger(root / "workflow" / "ledger.jsonl").events()
             if e.get("event") == "span" and e.get("span") == "run"]
    if not spans:
        raise SmokeFailure(f"serve: no run span in {root}")
    return float(spans[-1])


def _phase_s(engine, telemetry, roots) -> dict:
    """The executor's phase spans (load, launch, persist, ...) summed over
    the workflow ledgers of ``roots``, a job's mean, in seconds."""
    totals: dict = {}
    for root in roots:
        events = engine.RunLedger(root / "workflow" / "ledger.jsonl").events()
        for k, v in telemetry.phase_totals(events).items():
            totals[k] = totals.get(k, 0.0) + v / len(roots)
    return {k: round(v, 4) for k, v in sorted(totals.items())}


def _kernel_launches(path: Path) -> dict:
    """``tmx_kernel_launches_total`` by kernel from a registry snapshot."""
    snap = json.loads(Path(path).read_text())
    out: dict = {}
    for c in snap.get("counters", []):
        if c["name"] == "tmx_kernel_launches_total":
            k = c["labels"]["kernel"]
            out[k] = out.get(k, 0) + int(c["value"])
    return out


def phase_serve(torch, wrappers, card, device: str = "cuda") -> dict:
    """Phase 14, ``serve_p24x4_256``: the serving plane on the card (see the
    module notes, item 14).  Returns the ``serve:`` line, whose
    ``launches`` are rows 1-4's counts in the restarted daemon."""
    import numpy as np

    from tmlibrary_tpu_torch import benchmarks, capacity, cli, serve, telemetry, traceexport
    from tmlibrary_tpu_torch.models.experiment import grid_experiment
    from tmlibrary_tpu_torch.models.store import ExperimentStore
    from tmlibrary_tpu_torch.workflow import engine, get_step
    from tmlibrary_tpu_torch.workflow.admission import JobSpec

    started = time.perf_counter()
    repo = Path(__file__).resolve().parent
    base = repo / "build" / f"phase14.{os.getpid()}"
    shutil.rmtree(base, ignore_errors=True)
    procs: list = []

    def daemon(sroot: Path, tag: str, *args, env=None) -> subprocess.Popen:
        log = open(base / f"{tag}.log", "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "tmlibrary_tpu_torch.cli", "serve", "run", "--root",
             str(sroot), "--device", device, "--poll", "0.02", *args],
            cwd=repo, stdout=log, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": str(repo), **(env or {})})
        log.close()
        procs.append(proc)
        return proc

    def finish(proc, tag: str, want: int, timeout: float) -> None:
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            raise SmokeFailure(f"serve: {tag} did not exit within {timeout:.0f} s") from None
        if rc != want:
            tail = (base / f"{tag}.log").read_text()[-1500:]
            raise SmokeFailure(f"serve: {tag} exited {rc}, expected {want}:\n{tail}")

    def events(sroot: Path, kind: str) -> list:
        return [e for e in serve.serve_ledger_events(sroot) if e.get("event") == kind]

    def batches_done(root: Path) -> list:
        return sorted(e["batch"] for e in engine.RunLedger(
            root / "workflow" / "ledger.jsonl").events()
            if e.get("event") == "batch_done" and e.get("step") == "jterator")

    def zero():
        if device == "cuda":
            torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
            if hasattr(w, "routes"):
                w.routes = dict.fromkeys(w.routes, 0)

    def read(title: str) -> dict:
        launches = {k: wrappers[k].launches for k in ROWS_1_4}
        if not all(launches.values()):
            raise SmokeFailure(f"serve: {title}: a kernel of rows 1-4 did not launch: "
                               f"{launches}")
        return launches

    try:
        base.mkdir(parents=True)
        exps = {wells: grid_experiment("phase14", well_rows=wells[0], well_cols=wells[1],
                                       sites_per_well=SITES_PER_WELL,
                                       channel_names=("DAPI", "Actin"), site_shape=(SIZE, SIZE))
                for wells in (SERVE_WELLS, SERVE_BURST_WELLS)}
        n = exps[SERVE_WELLS].n_sites
        pipe_path = build_project(cli, base / "project")
        args = {"pipe": f"project/{pipe_path.name}", "batch_size": SERVE_BATCH,
                "max_objects": MAX_OBJECTS}

        def make(path: Path, data: dict, batch: int = SERVE_BATCH,
                 wells: tuple = SERVE_WELLS) -> Path:
            exp = exps[wells]
            store = ExperimentStore.create(path, exp)
            for c, ch in enumerate(("DAPI", "Actin")):
                store.write_sites(data[ch][:exp.n_sites].astype(np.uint16),
                                  list(range(exp.n_sites)), channel=c)
            shutil.copytree(base / "project", path / "project")
            engine.WorkflowDescription.for_type(
                "canonical", {"jterator": {**args, "batch_size": batch}}).save(
                store.workflow_dir / "workflow.yaml")
            return path

        datas = [benchmarks.synthetic_cell_painting_batch(n, size=SIZE, seed=SEED + 14 + k)
                 for k in range(4)]
        served = [make(base / f"e{k}", datas[k]) for k in range(4)]
        direct = [make(base / f"d{k}", datas[k]) for k in range(4)]
        quiet = make(base / "t0", datas[0])
        late = make(base / "late", datas[1], batch=1)
        fleet = make(base / "fleet", datas[0])
        # the burst: a fresh experiment a job, each one well of datas[1]
        # in one batch, and one direct submit of the same well to hold them by
        small = exps[SERVE_BURST_WELLS].n_sites
        bursts = [make(base / f"b{i:03d}", datas[1], batch=small, wells=SERVE_BURST_WELLS)
                  for i in range(SERVE_BURST + SERVE_LATE_BURST)]
        dsmall = make(base / "dsmall", datas[1], batch=small, wells=SERVE_BURST_WELLS)
        print(f"phase 14, serve_p24x4_256: 4 experiments of {n} sites ({SERVE_WELLS[0]}x"
              f"{SERVE_WELLS[1]} wells at {SITES_PER_WELL[0]}x{SITES_PER_WELL[1]} sites of "
              f"{SIZE}x{SIZE}, DAPI and Actin) as YAML projects running config 3 in batches "
              f"of {SERVE_BATCH}, max_objects={MAX_OBJECTS}, served on {device}; {card}")

        # 1. direct submits in one process whose router starts cold, as a
        # daemon's does; then telemetry on against off in pairs of turns
        walls = []
        zero()
        capacity.reset_routing_history()
        for root in direct:
            t0 = time.perf_counter()
            run_cli(cli, ["workflow", "submit", "--root", str(root), "--device", device])
            walls.append(time.perf_counter() - t0)
        direct_launches = read("direct submit")
        # sites/s over the engine's run span of the jobs after the first
        # (a warm router), the span and state the served figure reads
        direct_runs = [_run_span_s(engine, root) for root in direct]
        direct_sps = 3 * n / sum(direct_runs[1:])
        direct_phases = _phase_s(engine, telemetry, direct[1:])
        run_cli(cli, ["workflow", "submit", "--root", str(dsmall), "--device", device])
        turns = {True: [], False: []}
        for pair in range(SERVE_TELEMETRY_PAIRS):
            for on in ((True, False) if pair % 2 == 0 else (False, True)):
                capacity.reset_routing_history()
                telemetry.set_enabled(on)
                t0 = time.perf_counter()
                run_cli(cli, ["workflow", "submit", "--root", str(direct[0] if on else quiet),
                              "--device", device])
                turns[on].append(time.perf_counter() - t0)
        telemetry.set_enabled(True)
        same_store(ExperimentStore.open(direct[0]), ExperimentStore.open(quiet),
                   "telemetry on vs off")
        ratios = sorted((a - b) / b for a, b in zip(turns[True], turns[False]))
        overhead = {"median": float(np.median(ratios)),
                    "p25": float(np.percentile(ratios, 25)),
                    "p75": float(np.percentile(ratios, 75)),
                    "pairs": len(ratios)}
        overhead["resolved"] = not overhead["p25"] <= 0.0 <= overhead["p75"]
        print(f"  direct submit: {direct_sps:.1f} sites/s over the run spans of jobs 2-4 "
              f"({[round(w, 3) for w in direct_runs]} s; walls "
              f"{[round(w, 3) for w in walls]} s), launches {direct_launches}; telemetry on "
              f"{[round(w, 3) for w in turns[True]]} s vs off "
              f"{[round(w, 3) for w in turns[False]]} s in {len(ratios)} pairs: median "
              f"{100 * overhead['median']:+.2f}%, quartiles {100 * overhead['p25']:+.2f}% "
              f"to {100 * overhead['p75']:+.2f}% (resolved: {overhead['resolved']}), "
              f"stores equal bit for bit; {card}")

        # 2. the CPU's first batch of 8
        cpu = base / "cpu"
        copy_part(direct[0], cpu, "images")
        shutil.copytree(base / "project", cpu / "project")
        cpu_store = ExperimentStore.open(cpu)
        jt = get_step("jterator")(cpu_store, device="cpu")
        jt.init({**args, "batch_size": SERVE_CPU_BATCH})
        capacity.reset_routing_history()
        jt.run(0)
        cpu_sites = list(jt.load_batch(0)["sites"])

        # 3. serve run A, SIGTERMed once a job persisted a batch
        sroot = base / "serve_root"
        for k, root in enumerate(served):
            run_cli(cli, ["enqueue", "--root", str(sroot), "--experiment", str(root),
                          "--tenant", "prod" if k < 2 else "dev", "--job-id", f"a-e{k}",
                          "--trace-id", f"trace-e{k}"])
        weights = ["--tenant-weights", "prod=3,dev=1", "--max-queue", str(SERVE_MAX_QUEUE)]
        run_a = daemon(sroot, "run_a", *weights)
        _wait(lambda: any(batches_done(r) for r in served), "a served batch", 120, [run_a])
        run_a.terminate()  # SIGTERM
        finish(run_a, "run_a", 75, 120)
        if sorted(p.stem for p in serve.spool_dir(sroot, "incoming").glob("*.json")) != \
                [f"a-e{k}" for k in range(4)]:
            raise SmokeFailure("serve: the SIGTERM drain did not re-spool every job")
        cut = [len(batches_done(r)) for r in served]
        if not any(0 < c < n // SERVE_BATCH for c in cut):
            raise SmokeFailure(f"serve: no job was stopped mid-run by the drain: {cut}")
        launches_a = _kernel_launches(serve.serve_dir(sroot) / "metrics.json")

        # 4. run B: the restart with a burst, then a late tranche
        for i in range(SERVE_BURST):
            serve.enqueue_job(sroot, JobSpec(job_id=f"b-{i:03d}", tenant="burst",
                                             root=str(bursts[i]), trace_id=f"trace-b{i}"))
        max_jobs = 4 + (SERVE_MAX_QUEUE - 4) + SERVE_LATE_BURST
        run_b = daemon(sroot, "run_b", *weights, "--max-jobs", str(max_jobs))
        _wait(lambda: len(events(sroot, "job_done")) >= 4 + SERVE_MAX_QUEUE // 2,
              "the queue draining to its low watermark", 240, [run_b],
              every=0.5)  # rarely: each look parses the whole serve ledger beside the timed jobs
        for i in range(SERVE_LATE_BURST):
            serve.enqueue_job(sroot, JobSpec(job_id=f"c-{i:03d}", tenant="burst",
                                             root=str(bursts[SERVE_BURST + i]),
                                             trace_id=f"trace-c{i}"))
        finish(run_b, "run_b", 0, 240)
        for k in range(4):
            same_store(ExperimentStore.open(served[k]), ExperimentStore.open(direct[k]),
                       f"served e{k} vs direct submit")
        burst_done = {e["job"] for e in events(sroot, "job_done") if e["job"][0] in "bc"}
        if len(burst_done) != SERVE_MAX_QUEUE - 4 + SERVE_LATE_BURST:
            raise SmokeFailure(f"serve: {len(burst_done)} burst jobs done")
        for job in sorted(burst_done):
            i = int(job[2:]) + (SERVE_BURST if job[0] == "c" else 0)
            same_store(ExperimentStore.open(bursts[i]), ExperimentStore.open(dsmall),
                       f"burst job {job} vs direct submit")
        outside, worst = hold_batch(ExperimentStore.open(served[0]), cpu_store, cpu_sites,
                                    CARD_TIERS, gate=True)
        launches_b = _kernel_launches(serve.serve_dir(sroot) / "metrics.json")
        if not all(launches_b.get(k) for k in ROWS_1_4):
            raise SmokeFailure(f"serve: rows 1-4 not all launched by the served jobs: "
                               f"{launches_b}")
        ledger = serve.serve_ledger_events(sroot)
        b0 = max(e["ts"] for e in ledger if e.get("event") == "serve_started")
        replay = telemetry.registry_from_ledger([e for e in ledger if e["ts"] >= b0])
        live = json.loads((serve.serve_dir(sroot) / "metrics.json").read_text())
        pick = lambda snap: {(c["name"], tuple(sorted(c["labels"].items()))): c["value"]
                             for c in snap["counters"]
                             if c["name"].startswith(("tmx_serve_", "tmx_slo_"))}
        if pick(replay.snapshot()) != pick(live):
            raise SmokeFailure("serve: the ledger replay's counters differ from the live "
                               "snapshot's")
        rejected = [e.get("reason") for e in events(sroot, "job_rejected")]
        readmitted = [e["job"] for e in events(sroot, "job_admitted")
                      if e["job"].startswith("c-")]
        if rejected.count("queue_full") != 4 + SERVE_BURST - SERVE_MAX_QUEUE or \
                len(readmitted) != SERVE_LATE_BURST:
            raise SmokeFailure(f"serve: shedding {rejected} / re-admitted {readmitted}")
        trace_out = base / "trace.json"
        run_cli(cli, ["trace", "--root", str(sroot), "--export", "chrome", str(trace_out)])
        doc = json.loads(trace_out.read_text())
        if traceexport.validate_chrome_trace(doc):
            raise SmokeFailure("serve: the Chrome trace does not validate")
        flows = [e["id"] for e in doc["traceEvents"] if e.get("ph") == "s"]
        if len(flows) != len(set(flows)) or not flows:
            raise SmokeFailure("serve: the Chrome trace needs one flow a trace id")

        # the cell's numbers from run B's part of the serve ledger
        in_b = [e for e in ledger if e["ts"] >= b0]
        done_b = [e for e in in_b if e.get("event") == "job_done"]
        wf_done = [e for e in done_b if e["job"].startswith("a-")]
        burst_b = [e for e in done_b if not e["job"].startswith("a-")]
        # served sites/s: the engine's run span of the workflow jobs that
        # ran whole and not first in run B's process (a warm router), as
        # the direct figure
        first = next(e["job"] for e in in_b if e.get("event") == "job_started")
        full = [int(e["job"][3:]) for e in wf_done
                if not e.get("resumed") and e["job"] != first]
        if not full:
            raise SmokeFailure("serve: no workflow job ran whole on a warm router")
        served_sps = len(full) * n / sum(_run_span_s(engine, served[k]) for k in full)
        served_phases = _phase_s(engine, telemetry, [served[k] for k in full])
        jobs_per_s = len(done_b) / (max(e["ts"] for e in done_b) - b0)
        admission_us = [1e6 * e["elapsed"] for e in in_b
                        if e.get("event") == "span" and e.get("span") == "admission"]
        numbers = {
            "jobs_per_s": jobs_per_s, "served_sites_per_s": served_sps,
            "direct_sites_per_s": direct_sps,
            "workflow_job_s": _pcts(e["elapsed_s"] for e in wf_done),
            "job_s": _pcts(e["elapsed_s"] for e in done_b),
            "burst_job_s": _pcts(e["elapsed_s"] for e in burst_b),
            "served_sps_jobs": len(full),
            "phase_s_per_job": {"direct": direct_phases, "served": served_phases},
            "queue_wait_s": _pcts(e["queue_wait_s"] for e in in_b
                                  if e.get("event") == "job_admitted" and "queue_wait_s" in e),
            "sched_delay_s": _pcts(e["sched_delay_s"] for e in in_b
                                   if e.get("event") == "job_started"
                                   and "sched_delay_s" in e),
            "admission_us_per_decision": sum(admission_us) / len(admission_us),
            "shed": rejected.count("queue_full"), "readmitted": len(readmitted),
            "telemetry_overhead": overhead}
        print(f"  serve run A: SIGTERM after a persisted batch -> exit 75, 4 jobs re-spooled "
              f"(jterator batches done {cut}), rows 1-4 {launches_a}; run B: "
              f"{len(done_b)} jobs done, {numbers['shed']} shed at max-queue "
              f"{SERVE_MAX_QUEUE}, {len(readmitted)} re-admitted below the low watermark, "
              f"rows 1-4 {launches_b}; served stores equal the direct submits' (rows by site), "
              f"the {len(burst_done)} burst stores the direct submit of their well, "
              f"e0's first {SERVE_CPU_BATCH} sites equal the CPU's by CARD_TIERS (largest "
              + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + "); replay == live "
              f"counters; trace: {len(flows)} flows; {card}")
        print(f"  serve numbers: {jobs_per_s:.2f} jobs/s ({len(wf_done)} workflow jobs of "
              f"{n} sites, {len(burst_b)} burst jobs of {small}), served "
              f"{served_sps:.1f} sites/s ({len(full)} jobs) vs direct {direct_sps:.1f} (3 jobs), "
              f"both the run span on a warm router (phase s a job: served {served_phases} vs "
              f"direct {direct_phases}); workflow job s "
              f"{numbers['workflow_job_s']}, burst job s {numbers['burst_job_s']}, "
              f"queue wait s {numbers['queue_wait_s']}, "
              f"scheduling delay s {numbers['sched_delay_s']}, admission "
              f"{numbers['admission_us_per_decision']:.1f} us a decision; {card}")

        # 5. a deadline that expires mid-run (in this process)
        lroot = base / "late_root"
        budget = max(0.6, 0.5 * n / direct_sps)
        serve.enqueue_job(lroot, JobSpec(job_id="late", tenant="dev", root=str(late),
                                         deadline=time.time() + budget, trace_id="trace-late"))
        zero()
        capacity.reset_routing_history()
        if serve.run_serve(lroot, poll_s=0.02, max_jobs=1, install_handlers=False,
                           device=device) != 0:
            raise SmokeFailure("serve: the deadline daemon failed")
        late_launches = read("deadline job")
        done_late = batches_done(late)
        if not events(lroot, "job_expired") or not 0 < len(done_late) < n:
            raise SmokeFailure(f"serve: the deadline job did not expire mid-run "
                               f"({len(done_late)} of {n} batches)")
        print(f"  deadline: expired after {budget:.3f} s at {len(done_late)} of {n} batches "
              f"of 1 site, launches {late_launches}; {card}")

        # 6. eight query jobs, fused and unfused
        payloads = [(0, {"tool": "knn", "objects_name": "nuclei", "k": k, "index": "brute"})
                    for k in (3, 5, 7)]
        payloads += [(1, {"tool": "knn", "objects_name": "cells", "k": k, "index": "brute"})
                     for k in (4, 6)]
        payloads += [(k, {"tool": "knn", "objects_name": o, "k": 3, "index": "brute"})
                     for k, o in ((2, "nuclei"), (3, "cells"), (2, "cells"))]
        # the feature stores first, so neither wave pays for building them
        from tmlibrary_tpu_torch.analytics.store import FeatureStore

        for k, payload in payloads:
            FeatureStore.ensure(ExperimentStore.open(served[k]), payload["objects_name"])
        query_s, pooled = {}, {True: [], False: []}
        for turn, fused in enumerate((True, False, True, False)):
            qroot = base / f"query_{turn}"
            for root in served:
                shutil.rmtree(root / "tools" / "queries", ignore_errors=True)
            for i, (k, payload) in enumerate(payloads):
                serve.enqueue_job(qroot, JobSpec(job_id=f"q-{i}", tenant="dev",
                                                 root=str(served[k]), kind="query",
                                                 payload=payload, trace_id=f"trace-q{i}"))
            os.environ["TM_SERVE_QUERY_FUSION"] = "1" if fused else "0"
            try:
                if serve.run_serve(qroot, poll_s=0.02, max_jobs=len(payloads),
                                   install_handlers=False, device=device) != 0:
                    raise SmokeFailure("serve: a query daemon failed")
            finally:
                os.environ.pop("TM_SERVE_QUERY_FUSION")
            qdone = events(qroot, "job_done")
            if len(qdone) != len(payloads):
                raise SmokeFailure(f"serve: {len(qdone)} of {len(payloads)} query jobs done")
            windows = sorted(e["window"] for e in events(qroot, "query_fused"))
            if windows != ([2, 3] if fused else []):
                raise SmokeFailure(f"serve: fusion windows {windows}")
            pooled[fused] += [e["elapsed_s"] for e in qdone]
        query_s = {"fused": _pcts(pooled[True]), "unfused": _pcts(pooled[False])}
        print(f"  queries: 8 jobs a wave, fused and unfused in turns (two waves each), job s "
              f"fused {query_s['fused']} (windows 3 and 2) vs unfused {query_s['unfused']}; "
              f"{card}")

        # 7. two hosts: h0 held mid-job and SIGKILLed, h1 reaps its job
        froot = base / "fleet_root"
        serve.enqueue_job(froot, JobSpec(job_id="f-0", tenant="prod", root=str(fleet),
                                         trace_id="trace-f0"))
        stall = json.dumps({"faults": [{"site": "persist", "kind": "hang", "step": "jterator",
                                        "batch": 1, "seconds": 600}]})
        h0 = daemon(froot, "h0", "--host", "h0", "--lease", "2",
                    env={"TMX_FAULT_PLAN": stall})
        _wait(lambda: batches_done(fleet), "h0 persisting a batch", 120, [h0])
        h1 = daemon(froot, "h1", "--host", "h1", "--lease", "2", "--max-jobs", "1",
                    "--idle-exit", "120")
        _wait(lambda: serve.heartbeat_file(froot, "h1").exists(), "h1 coming up", 120,
              [h0, h1])
        h0.kill()
        killed = time.time()
        h0.wait(timeout=60)
        finish(h1, "h1", 0, 240)
        reclaimed = events(froot, "job_reclaimed")
        if [(e["job"], e.get("from_host"), e.get("host")) for e in reclaimed] != \
                [("f-0", "h0", "h1")] or \
                [e.get("host") for e in events(froot, "job_done")] != ["h1"]:
            raise SmokeFailure(f"serve: h1 did not reap h0's job: {reclaimed}")
        same_store(ExperimentStore.open(fleet), ExperimentStore.open(direct[0]),
                   "reclaimed job vs direct submit")
        launches_h1 = _kernel_launches(serve.serve_dir(froot) / "metrics.h1.json")
        if not all(launches_h1.get(k) for k in ROWS_1_4):
            raise SmokeFailure(f"serve: rows 1-4 not launched by h1: {launches_h1}")
        reclaim_s = reclaimed[0]["ts"] - killed
        print(f"  fleet: h0 SIGKILLed mid-job (lease 2 s), h1 reclaimed it after "
              f"{reclaim_s:.3f} s and finished it equal to the direct submit, rows 1-4 "
              f"{launches_h1}; {card}")
        phase_s = time.perf_counter() - started
        line = {"cell": "serve_p24x4_256", "sites_per_job": n, **numbers,
                "query_job_s": query_s, "reclaim_s": reclaim_s,
                "deadline_batches_done": len(done_late),
                "launches": {k: launches_b[k] for k in ROWS_1_4},
                "launches_run_a": {k: launches_a.get(k, 0) for k in ROWS_1_4},
                "launches_h1": {k: launches_h1[k] for k in ROWS_1_4},
                "cpu_hold_sites": len(cpu_sites), "phase_s": phase_s, "card": card}
        print(f"  phase 14: {phase_s:.1f} s on {card}")
        print("serve: " + json.dumps(line))
        return line
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        shutil.rmtree(base, ignore_errors=True)


# ------------------------------------------------------------------ phase 15
#: the trace's kernel events of rows 1-4, by the names of their __global__
#: functions (one event a launch of the wrapper: row 2's last phase, row
#: 4's walk)
TRACE_KERNELS = {"fill_holes_flood": r"fill_(onchip|global)_kernel",
                 "cc_min_propagate": r"uf_flatten",
                 "watershed_flood": r"ws_(onchip|global)_kernel",
                 "grouped_stats": r"gs_walk"}
#: profiled and plain submits, in turns, for the profiler's overhead
PROFILE_PAIRS = 3

IMPORT_CHECK = r"""
import json, sys, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
import numpy as np
from tmlibrary_tpu_torch import aotstore, benchmarks, telemetry
from tmlibrary_tpu_torch.jterator import pipeline
from tmlibrary_tpu_torch.ops import _cuda
_cuda.BUILD_DIR = Path(sys.argv[7])


def no_nvcc():
    raise RuntimeError("this process has no nvcc")


_cuda._nvcc = no_nvcc
t0 = time.perf_counter()
_cuda.lib()
load_s = time.perf_counter() - t0
n, size = int(sys.argv[3]), int(sys.argv[4])
data = benchmarks.synthetic_cell_painting_batch(n, size=size, seed=int(sys.argv[6]))
raw, stats, shifts = pipeline.from_jax_inputs(data, {}, [[0, 0]] * n, device="cuda")
fn = pipeline.ImageAnalysisPipeline(benchmarks.cell_painting_description(), int(sys.argv[5]),
                                    device="cuda").build_batch_fn()
res = pipeline.site_result_to_numpy(fn(raw, stats, shifts))
np.savez(sys.argv[2], **{f"labels_{k}": v for k, v in res.objects.items()},
         **{f"counts_{k}": v for k, v in res.counts.items()})
snap = telemetry.get_registry().snapshot()
print(json.dumps({
    "nvcc_builds": _cuda.nvcc_builds, "build_s": _cuda.last_build_seconds, "load_s": load_s,
    "import_hits": sum(c["value"] for c in snap["counters"]
                       if c["name"] == "tmx_compile_import_hit_total"),
    "saved_s": aotstore.seconds_saved(), "library": str(_cuda.build())}))
"""


def trace_counts(path: Path) -> tuple[dict, set]:
    """Rows 1-4's kernel events and the ``record_function`` range names of
    a Chrome trace."""
    import re

    doc = json.loads(Path(path).read_text())
    kernels = [e["name"] for e in doc["traceEvents"] if e.get("cat") == "kernel"]
    if not kernels:
        raise SmokeFailure(f"profile: no CUDA kernel in the trace {path} (CUPTI missing?)")
    counts = {k: sum(1 for n in kernels if re.search(p, n)) for k, p in TRACE_KERNELS.items()}
    ranges = {e["name"] for e in doc["traceEvents"] if e.get("cat") == "user_annotation"}
    return counts, ranges


def phase_profile(torch, wrappers, card) -> dict:
    """Phase 15, ``profile_p96x4_256``: the compile and profile plumbing on
    phase 5's plate (96 wells at 2x2 sites of 256x256, 384 sites, one
    cycle of DAPI and Actin), config 3 at ``max_objects=256`` in batches
    of 64 through ``workflow submit --device cuda``.  In order: one
    ``--profile`` submit that takes each program's first call and counts
    its FLOPs and bytes, then plain and
    ``--profile`` submits in turns (:data:`PROFILE_PAIRS` pairs; the
    stores equal bit for bit, the first timed traced run's kernel events of
    rows 1-4 equal to their launch counters over the run, the step and
    batch ranges in the trace, the wall ratio); ``workflow/perf.json``
    and ``perf --root --json``; ``perf history`` on a regressed ``cuda``
    record (exit 1); the tuned link with the repo's ``tuning/TUNING.json``
    (batch 32, depth 8) and with a ``cuda`` verdict; the three submit
    options in one submit (the defaults' store); the kernel-library
    store on in a fresh directory: a build into an empty directory
    exports the library, ``cache list`` shows it, a subprocess with an
    empty build directory and ``nvcc`` off its PATH (and any call of it
    failing) imports it and its config 3
    batch of 8 sites equals this process's, ``cache gc`` drops a planted
    stale entry.  Prints the ``profile:`` line and returns it."""
    import statistics

    import numpy as np

    from tmlibrary_tpu_torch import aotstore, benchmarks, capacity, cli, perf, tuning
    from tmlibrary_tpu_torch.jterator import pipeline
    from tmlibrary_tpu_torch.models.experiment import grid_experiment
    from tmlibrary_tpu_torch.models.store import ExperimentStore
    from tmlibrary_tpu_torch.ops import _cuda
    from tmlibrary_tpu_torch.workflow import engine, get_step
    from tmlibrary_tpu_torch.workflow.pipelined import resolve_pipeline_depth

    started = time.perf_counter()
    base = Path(__file__).resolve().parent / "build" / f"phase15.{os.getpid()}"
    shutil.rmtree(base, ignore_errors=True)
    saved_env = {k: os.environ.get(k) for k in ("TMX_AOT_STORE", "TMX_AOT_STORE_DIR",
                                                 "TMX_TUNING_JSON")}
    try:
        exp = grid_experiment("phase15", well_rows=PLATE[0], well_cols=PLATE[1],
                              sites_per_well=SITES_PER_WELL, channel_names=("DAPI", "Actin"),
                              site_shape=(SIZE, SIZE))
        n = exp.n_sites
        data = benchmarks.synthetic_cell_painting_batch(n, size=SIZE, seed=SEED)
        roots = {name: base / name for name in ("plain", "traced", "options")}
        store = ExperimentStore.create(roots["plain"], exp)
        for c, ch in enumerate(("DAPI", "Actin")):
            store.write_sites(data[ch].astype(np.uint16), list(range(n)), channel=c)
        for name in ("traced", "options"):
            copy_part(roots["plain"], roots[name], "images")
        desc_path = base / "workflow.json"
        engine.WorkflowDescription.canonical({"jterator": {
            "pipe": str(base / "cp.pipe.json"), "batch_size": STEP_BATCH,
            "max_objects": MAX_OBJECTS}}).save(desc_path)
        (base / "cp.pipe.json").write_text(json.dumps(benchmarks.CELL_PAINTING_PIPE))
        print(f"phase 15, profile_p96x4_256: config 3 through `workflow submit --device cuda` "
              f"over {n} sites ({PLATE[0]}x{PLATE[1]} wells at {SITES_PER_WELL[0]}x"
              f"{SITES_PER_WELL[1]} sites of {SIZE}x{SIZE}, one cycle), plain and "
              f"--profile in turns; {card}")
        library_build = next((p for p in perf.perf_profiles()
                              if p["program"] == "cuda_kernels"), None)
        perf.reset_profiles()

        def submit(root: Path, *extra) -> float:
            capacity.reset_routing_history()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_cli(cli, ["workflow", "submit", "--root", str(root), "--description",
                          str(desc_path), "--device", "cuda", *extra])
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        # 1. plain and traced submits in turns, after one untimed traced
        # submit that takes each program's first call and counts its cost
        submit(roots["traced"], "--profile", str(base / "trace_first"))
        walls = {"plain": [], "traced": []}
        launches = counts = ranges = None
        for turn in range(PROFILE_PAIRS):
            walls["plain"].append(submit(roots["plain"]))
            for w in wrappers.values():
                w.launches = 0
            trace_dir = base / f"trace{turn}"
            walls["traced"].append(submit(roots["traced"], "--profile", str(trace_dir)))
            if turn == 0:
                launches = {k: wrappers[k].launches for k in ROWS_1_4}
                (trace,) = trace_dir.glob("*.pt.trace.json")
                counts, ranges = trace_counts(trace)
            same_store(ExperimentStore.open(roots["traced"]),
                       ExperimentStore.open(roots["plain"]), "profiled vs plain submit")
        if counts != launches or not all(launches.values()):
            raise SmokeFailure(f"profile: trace kernels {counts} vs launch counters {launches}")
        if "run/step:jterator" not in ranges or not any(r.startswith("batch:") for r in ranges):
            raise SmokeFailure(f"profile: step and batch ranges missing: {sorted(ranges)[:20]}")
        ratios = [t / p for t, p in zip(walls["traced"], walls["plain"])]
        overhead = {"ratios": ratios, "median": statistics.median(ratios),
                    "min": min(ratios), "max": max(ratios), "plain_s": walls["plain"],
                    "traced_s": walls["traced"]}
        print(f"  traced run: rows 1-4 kernel events {counts} == launch counters; ranges "
              f"run/step:jterator and {sum(r.startswith('batch:') for r in ranges)} batch "
              f"ranges; wall traced/plain over {PROFILE_PAIRS} pairs in turns: median "
              f"{overhead['median']:.4f} (min {overhead['min']:.4f}, max "
              f"{overhead['max']:.4f}); {card}")

        # 2. the perf store and its verbs
        wf = roots["plain"] / "workflow"
        snap = json.loads((wf / "perf.json").read_text())
        jt = [p for p in snap["programs"] if p["program"].startswith("jterator:")]
        if not jt or not all(p["compiles"] >= 1 and p["compile_seconds_total"] > 0
                             and p["flops"] is not None and p["bytes"]
                             and p["bound_by"] in ("memory", "compute")
                             and p["backend"] == "cuda" for p in jt):
            raise SmokeFailure(f"profile: perf.json programs {snap['programs']}")
        if snap["card"]["ridge_flops_per_byte"] <= 0 or not snap["card"]["power_limit"]:
            raise SmokeFailure(f"profile: perf.json card {snap['card']}")
        doc = json.loads(run_cli(cli, ["perf", "--root", str(roots["plain"]), "--json",
                                       "--top", "0"]))
        stats = next(e["pipeline_stats"] for e in engine.RunLedger(wf / "ledger.jsonl").events()
                     if e.get("event") == "step_done")
        if doc["programs"] != snap["programs"] or [(r["device_s"], r["host_s"])
                                                  for r in doc["phases"]] != \
                [(stats["device_s"], stats["host_s"])]:
            raise SmokeFailure("profile: `perf --json` does not reproduce perf.json and the "
                               "ledger's phase split")
        batch_s = [e["elapsed"] for e in engine.RunLedger(wf / "ledger.jsonl").events()
                   if e.get("span") == "batch"]
        first = max(jt, key=lambda p: p["compile_seconds_total"])
        hist = base / "history.jsonl"
        for value in (1000.0, 800.0):
            tuning.append_bench_history({"metric": "jterator_sites_per_sec", "config": "3",
                                         "backend": "cuda", "value": value}, str(hist))
        rc, _ = run_cli_rc(cli, ["perf", "history", "--history", str(hist)])
        if rc != 1:
            raise SmokeFailure(f"profile: `perf history` on a regressed record exited {rc}")
        print(f"  perf.json: {len(jt)} jterator programs, first call (counted) by capacity "
              f"{ {p['capacity']: p['last_compile_s'] for p in jt} } s against a warm batch of "
              f"{statistics.median(batch_s):.4f} s (median of {len(batch_s)}), "
              f"{first['bytes'] / 1e6:.1f} MB, {first['flops']:.4g} FLOPs, "
              f"{first['bound_by']}-bound against the ridge "
              f"{snap['card']['ridge_flops_per_byte']:.1f}; `perf --json` reproduces it; "
              f"`perf history` exits 1 on a 20% regression; {card}")

        # 3. the tuned link on the card
        os.environ["TMX_TUNING_JSON"] = str(Path(__file__).resolve().parent / "tuning" /
                                            "TUNING.json")
        step = get_step("jterator")(store, device="cuda")
        repo = (step._auto_batch_size(), resolve_pipeline_depth(None, "cuda"))
        cuda_file = base / "TUNING.cuda.json"
        cuda_file.write_text(json.dumps({"written_by": "phase 15", "backend": "cuda",
                                         "best_batch": 48, "best_pipeline": 6}))
        os.environ["TMX_TUNING_JSON"] = str(cuda_file)
        tuned = (step._auto_batch_size(), resolve_pipeline_depth(None, "cuda"))
        if repo != (32, (8, "default")) or tuned != (48, (6, "tuning")):
            raise SmokeFailure(f"profile: tuned link {repo} with the repo's file, {tuned} "
                               "with a cuda verdict")
        os.environ.pop("TMX_TUNING_JSON")
        print(f"  tuning: the repo's tuning/TUNING.json (a TPU's) leaves batch {repo[0]} and "
              f"depth {repo[1][0]}; a cuda verdict sets batch {tuned[0]} and depth "
              f"{tuned[1][0]}")

        # 4. the three submit options in one submit
        submit(roots["options"], "--reduction-strategy", "fused", "--object-buckets", "off",
               "--schedule", "off")
        same_store(ExperimentStore.open(roots["options"]), ExperimentStore.open(roots["plain"]),
                   "submit options vs defaults")
        print("  --reduction-strategy fused --object-buckets off --schedule off: the "
              "defaults' store bit for bit")

        # 5. the kernel-library store, on in a fresh directory
        os.environ["TMX_AOT_STORE"] = "1"
        os.environ["TMX_AOT_STORE_DIR"] = str(base / "aot")
        builds, build_dir = _cuda.nvcc_builds, _cuda.BUILD_DIR
        _cuda.BUILD_DIR = base / "kernels_built"
        try:
            _cuda.build()
        finally:
            _cuda.BUILD_DIR = build_dir
        build_s = _cuda.last_build_seconds
        if _cuda.nvcc_builds != builds + 1:
            raise SmokeFailure("profile: the build into an empty directory ran no nvcc")
        listed = json.loads(run_cli(cli, ["cache", "list", "--json"]))
        live = [e for e in listed["entries"] if e["program"] == "cuda_kernels"]
        if len(live) != 1 or live[0]["stale"] or listed["stats"]["dir"] != str(base / "aot"):
            raise SmokeFailure(f"profile: cache list {listed}")
        # nvcc off the PATH and out of reach: the import needs no compiler
        path = [d for d in os.environ.get("PATH", "").split(os.pathsep)
                if d and not (Path(d) / "nvcc").exists()]
        env = {**os.environ, "PATH": os.pathsep.join(path),
               "CUDA_HOME": str(base / "no_cuda_home")}
        proc = subprocess.run(
            [sys.executable, "-c", IMPORT_CHECK, str(Path(__file__).resolve().parent),
             str(base / "imported.npz"), "8", str(SIZE), str(MAX_OBJECTS), str(SEED),
             str(base / "kernels_imported")],
            env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise SmokeFailure(f"profile: the importing process failed:\n{proc.stderr[-2000:]}")
        imported = json.loads(proc.stdout.strip().splitlines()[-1])
        if imported["nvcc_builds"] != 0 or imported["build_s"] != 0.0 or \
                imported["import_hits"] != 1 or not imported["saved_s"] > 0:
            raise SmokeFailure(f"profile: the import {imported}")
        raw, st8, shifts = pipeline.from_jax_inputs(
            benchmarks.synthetic_cell_painting_batch(8, size=SIZE, seed=SEED), {},
            [[0, 0]] * 8, device="cuda")
        mine = pipeline.site_result_to_numpy(pipeline.ImageAnalysisPipeline(
            benchmarks.cell_painting_description(), MAX_OBJECTS,
            device="cuda").build_batch_fn()(raw, st8, shifts))
        with np.load(base / "imported.npz") as got:
            for k in mine.objects:
                if not (np.array_equal(got[f"labels_{k}"], mine.objects[k])
                        and np.array_equal(got[f"counts_{k}"], mine.counts[k])):
                    raise SmokeFailure(f"profile: the importing process's {k} differ")
        meta_path = base / "aot" / f"{live[0]['digest']}.json"
        planted = "0" * 40
        shutil.copy(meta_path.with_suffix(".bin"), base / "aot" / f"{planted}.bin")
        (base / "aot" / f"{planted}.json").write_text(json.dumps(
            {**json.loads(meta_path.read_text()), "digest": planted,
             "fingerprint": "stale00000000000"}))
        gc = json.loads(run_cli(cli, ["cache", "gc", "--json"]))
        if gc["removed"] != [planted] or gc["kept"] != 1:
            raise SmokeFailure(f"profile: cache gc {gc}")
        print(f"  kernel-library store: nvcc build {build_s:.2f} s exported "
              f"({live[0]['size_bytes']} bytes); an empty build directory imported it in "
              f"{imported['load_s']:.3f} s with nvcc off its PATH (import hits 1, "
              f"{imported['saved_s']:.2f} "
              f"build s saved), its config 3 batch of 8 sites equal to this process's; cache "
              f"gc dropped the planted stale entry; {card}")
        phase_s = time.perf_counter() - started
        line = {"cell": "profile_p96x4_256", "sites": n, "trace_kernels": counts,
                "launches": launches, "overhead": overhead,
                "first_call_s": {p["capacity"]: p["last_compile_s"] for p in jt},
                "warm_batch_s": statistics.median(batch_s),
                "program_bytes": first["bytes"], "program_flops": first["flops"],
                "bound_by": first["bound_by"],
                "library_load_s": library_build and library_build["last_compile_s"],
                "nvcc_build_s": build_s, "import_load_s": imported["load_s"],
                "build_s_saved": imported["saved_s"], "tuned": {"repo": repo, "cuda": tuned},
                "phase_s": phase_s, "card": card}
        print(f"  phase 15: {phase_s:.1f} s on {card}")
        print("profile: " + json.dumps(line))
        return line
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(base, ignore_errors=True)

# ------------------------------------------------------------------ phase 16
#: the strategies phase 16 holds against ``"fused"``: every one on config
#: 3, those the reference's own suite sweeps (onehot, scatter) on config 4
STRATEGIES_C3, STRATEGIES_C4 = ("onehot", "sort", "scatter"), ("onehot", "scatter")
#: rounds of one timed call of each build, the order reversed every
#: other round (CUDA events); a build's ms a batch is their median
STRATEGY_ROUNDS = 5
SEGMENT_KERNELS = ("fill_holes_flood", "cc_min_propagate", "watershed_flood")
MEASURE_KERNELS = ("grouped_stats", "intensity_hist", "glcm_all")


def strategy_batch(torch, pipeline, desc, inputs, wrappers, strategy: str) -> dict:
    """Build ``desc`` with ``reduction_strategy=strategy``, call it once,
    set every launch counter to 0, call it once more and read the
    counters."""
    fn = pipeline.ImageAnalysisPipeline(desc, MAX_OBJECTS, device="cuda").build_batch_fn(
        reduction_strategy=strategy)
    if fn.reduction_strategy != strategy:
        raise SmokeFailure(f"build_batch_fn pinned {fn.reduction_strategy}, not {strategy}")
    fn(*inputs)
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    result = fn(*inputs)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    return {"fn": fn, "result": result, "host": pipeline.site_result_to_numpy(result),
            "launches": launches}


def time_strategies(torch, runs: dict, inputs) -> None:
    """:data:`STRATEGY_ROUNDS` rounds of one call of each build, in
    alternating order; sets each run's ``ms`` (the median) and
    ``ms_range`` (the least and the most)."""
    import statistics

    order = list(runs)
    times: dict[str, list] = {s: [] for s in order}
    for r in range(STRATEGY_ROUNDS):
        for s in (order if r % 2 == 0 else order[::-1]):
            times[s].append(cuda_ms(torch, lambda: runs[s]["fn"](*inputs), 1, warmup=0))
    for s, t in times.items():
        runs[s]["ms"], runs[s]["ms_range"] = statistics.median(t), (min(t), max(t))


def check_strategy_launches(title: str, strategy: str, launches: dict) -> None:
    """Rows 1-3 launched on every strategy; rows 4-6 only on ``fused``."""
    for k in SEGMENT_KERNELS:
        if launches[k] < 1:
            raise SmokeFailure(f"{title} {strategy}: {k} was not launched")
    measured = {k: launches[k] for k in MEASURE_KERNELS}
    if strategy == "fused":
        if launches["grouped_stats"] < 1:
            raise SmokeFailure(f"{title} fused: grouped_stats was not launched")
    elif any(measured.values()):
        raise SmokeFailure(f"{title} {strategy}: the measure kernels launched {measured}")


#: the raw sums' hold: each strategy's per-object sum within this
#: relative distance of the float64 sum of the same float32 values
SUM_RTOL = 1e-6
#: features computed in float32 from sums that a change of summation
#: order moves (fractional values, or integers past 2^24) and whose
#: formula then loses digits to cancellation (the second moments, the
#: variance): held object by object against their float64 value from the
#: exact sums, within what the sums' own hold allows (:func:`order_truth`)
ORDER_FEATURES = ("Intensity_sum", "Intensity_mean", "Intensity_std",
                  "Morphology_major_axis_length", "Morphology_minor_axis_length",
                  "Morphology_eccentricity", "Morphology_orientation")
#: the ellipse's angle and eccentricity are held only on cells whose
#: second moments' eigenvalues differ by this ratio (l1 / l2): where they
#: nearly agree the axis is undefined and any order moves it freely
WELL_CONDITIONED = 1.1


def _order_kind(feat: str) -> "str | None":
    return next((k for k in ORDER_FEATURES if feat == k or feat.startswith(k + "_")), None)


def _order_value(kind: str, sums):
    """An :data:`ORDER_FEATURES` feature from its sums (``(K, ...)``
    float64: count, then value and squared value, or y, x, yy, xx, yx),
    by the reference's formulas; also returns ``l1 / l2`` of the second
    moments (None for the intensity features)."""
    import numpy as np

    n = np.maximum(sums[0], 1.0)
    if kind.startswith("Intensity"):
        mean = sums[1] / n
        return {"Intensity_sum": sums[1], "Intensity_mean": mean,
                "Intensity_std": np.sqrt(np.maximum(sums[2] / n - mean * mean, 0.0))}[kind], None
    cy, cx = sums[1] / n, sums[2] / n
    myy = sums[3] / n - cy * cy + 1.0 / 12.0
    mxx = sums[4] / n - cx * cx + 1.0 / 12.0
    myx = sums[5] / n - cy * cx
    common = np.sqrt(np.maximum((myy - mxx) ** 2 + 4.0 * myx * myx, 0.0))
    l1 = (myy + mxx + common) / 2.0
    l2 = np.maximum((myy + mxx - common) / 2.0, 1e-12)
    return {
        "Morphology_major_axis_length": 4.0 * np.sqrt(np.maximum(l1, 0.0)),
        "Morphology_minor_axis_length": 4.0 * np.sqrt(l2),
        "Morphology_eccentricity": np.sqrt(np.clip(1.0 - l2 / np.maximum(l1, 1e-12),
                                                   0.0, 1.0)),
        "Morphology_orientation": 0.5 * np.arctan2(2.0 * myx, mxx - myy)}[kind], l1 / l2


def order_truth(feat: str, labels, images: dict, m: int):
    """``(truth, slack, held)``, each ``(B, m)``, of an
    :data:`ORDER_FEATURES` feature: its float64 value from the exact
    per-object sums (``bincount`` in float64 over the labels and the
    measured image); ``slack``, the most it moves when each sum but the
    count moves by :data:`SUM_RTOL` plus 8 float32 roundings (the sums'
    hold and the float32 formula's own roundings, each sum on its own,
    both signs, the moves added); and ``held``, False for the angle and
    the eccentricity of a cell below :data:`WELL_CONDITIONED`."""
    import numpy as np

    kind = _order_kind(feat)
    b, h, w = labels.shape
    yy, xx = (g.ravel().astype(np.float64) for g in np.mgrid[0:h, 0:w])
    sums = []
    for site in range(b):
        lab = labels[site].ravel()

        def total(weights=None):
            return np.bincount(lab, weights=weights, minlength=m + 1)[1 : m + 1]

        if kind.startswith("Intensity"):
            v = images[feat[len(kind) + 1:]][site].astype(np.float64).ravel()
            sums.append([total(), total(v), total(v * v)])
        else:
            sums.append([total(), total(yy), total(xx), total(yy * yy), total(xx * xx),
                         total(yy * xx)])
    sums = np.moveaxis(np.asarray(sums), 1, 0)  # (K, B, m)
    truth, ratio = _order_value(kind, sums)
    eps = SUM_RTOL + 8 * 2.0 ** -24
    slack = np.zeros_like(truth)
    for k in range(1, sums.shape[0]):
        moved = np.zeros_like(truth)
        for sign in (1.0, -1.0):
            bent = sums.copy()
            bent[k] = sums[k] + sign * eps * np.abs(sums[k])
            moved = np.maximum(moved, _distance(kind, _order_value(kind, bent)[0], truth))
        slack += moved
    held = np.ones(truth.shape, bool)
    if kind in ("Morphology_orientation", "Morphology_eccentricity"):
        held = ratio >= WELL_CONDITIONED
    return truth, slack, held


def _distance(kind: str, a, b):
    import numpy as np

    d = np.abs(a.astype(np.float64) - b)
    if kind == "Morphology_orientation":  # an axis: angles pi apart are one
        d = np.minimum(d, np.pi - d)
    return d


def hold_strategy(title: str, got, want, images: dict,
                  truths: "dict | None" = None) -> tuple[dict, int, dict]:
    """A strategy's batch (``got``, numpy) against the ``fused`` build's
    (``want``) on the same ``images``: labels and counts bit for bit; an
    ``Intensity_sum`` of an integer-valued image below 2^24 bit for bit
    (its partial sums are exact in float32 in any order); each
    :data:`ORDER_FEATURES` feature object by object within ``slack +
    rtol * |truth| + atol`` of its float64 value (:func:`order_truth`;
    the tier from :data:`CARD_TIERS`); every other feature on every
    site's defined rows within its :data:`CARD_TIERS` tier of fused,
    which is exact for min/max, counts, areas and quantiles.  Returns the
    largest |got - want| of each feature family, the number of integral
    sums held exactly, and for each order feature kind the largest
    distance of the strategy and of fused from the float64 value, the
    largest share of its allowance the strategy used, and the cells held
    and left out.  ``truths`` caches the float64 values between calls on
    the same fused build."""
    import numpy as np

    truths = {} if truths is None else truths
    for obj in want.objects:
        if not np.array_equal(got.objects[obj], want.objects[obj]):
            raise SmokeFailure(f"{title}: {obj} labels differ from fused")
        if not np.array_equal(got.counts[obj], want.counts[obj]):
            raise SmokeFailure(f"{title}: {obj} counts differ from fused")
    worst: dict[str, tuple[float, str]] = {}
    order: dict[str, dict] = {}
    exact_sums = 0
    for obj, feats in want.measurements.items():
        if sorted(got.measurements[obj]) != sorted(feats):
            raise SmokeFailure(f"{title}: {obj} features differ from fused")
        rows = np.arange(MAX_OBJECTS)[None, :] < want.counts[obj][:, None]
        for feat, w_all in feats.items():
            g, w = got.measurements[obj][feat][rows], w_all[rows]
            if not np.isfinite(g).all():
                raise SmokeFailure(f"{title}: {obj}/{feat} non-finite values")
            rtol, atol = feature_tier(feat, CARD_TIERS)
            kind = _order_kind(feat)
            image = images.get(feat[len("Intensity_sum_"):]) if kind == "Intensity_sum" \
                else None
            if image is not None and bool((image == np.round(image)).all()):
                integral = np.abs(w) < 2.0 ** 24
                np.testing.assert_array_equal(g[integral], w[integral],
                                              err_msg=f"{title} {obj}/{feat} integral")
                exact_sums += int(integral.sum())
            if kind is not None:
                if (obj, feat) not in truths:
                    truths[obj, feat] = tuple(a[rows] for a in order_truth(
                        feat, want.objects[obj], images, MAX_OBJECTS))
                truth, slack, held = truths[obj, feat]
                d_got, d_fused = _distance(kind, g, truth), _distance(kind, w, truth)
                allow = slack + rtol * np.abs(truth) + atol
                bad = held & (d_got > allow)
                if bad.any():
                    i = int(np.argmax(np.where(bad, d_got / allow, 0.0)))
                    raise SmokeFailure(
                        f"{title} {obj}/{feat}: {int(bad.sum())} cells outside their "
                        f"allowance, e.g. {g[i]!r} against the float64 value {truth[i]!r} "
                        f"(fused {w[i]!r}, allowed {allow[i]:.4g})")
                acc = order.setdefault(kind, {"got": 0.0, "fused": 0.0, "share": 0.0,
                                              "allow": 0.0, "held": 0, "left_out": 0})
                acc["got"] = max(acc["got"], float(d_got[held].max(initial=0.0)))
                acc["fused"] = max(acc["fused"], float(d_fused[held].max(initial=0.0)))
                acc["share"] = max(acc["share"], float((d_got / allow)[held].max(initial=0.0)))
                acc["allow"] = max(acc["allow"], float(allow[held].max(initial=0.0)))
                acc["held"] += int(held.sum())
                acc["left_out"] += int((~held).sum())
            elif rtol == atol == 0.0:
                np.testing.assert_array_equal(g, w, err_msg=f"{title} {obj}/{feat}")
            else:
                np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                           err_msg=f"{title} {obj}/{feat}")
            if g.size:
                family = feat.split("_")[0]
                diff = float(_distance(kind or "", g, w).max())
                worst[family] = max(worst.get(family, (0.0, "")), (diff, feat))
    return worst, exact_sums, order


def hold_sums(torch, title: str, labels: dict, data: dict, strategies) -> dict:
    """The reduction layer on its own: ``grouped_sums`` of each image v
    and v*v and of the pixel grid's y, x, y*y, x*x and y*x over each
    object kind's ``labels`` (on the card), on ``fused`` and on each of
    ``strategies``, against the float64 sums of the same float32 values
    (``bincount``): every strategy but fused within :data:`SUM_RTOL` of
    them, object by object (fused's kernel is held against its plain
    version in phase 2; its distance is printed beside).  Returns the
    largest relative distance of each strategy."""
    import numpy as np

    from tmlibrary_tpu_torch.ops import measure

    imgs = [torch.from_numpy(v).to("cuda") for v in data.values()]
    b, h, w = imgs[0].shape
    yy, xx = (g.expand(b, h, w) for g in torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device="cuda"),
        torch.arange(w, dtype=torch.float32, device="cuda"), indexing="ij"))
    chans = [c for v in imgs for c in (v, v * v)] + [yy, xx, yy * yy, xx * xx, yy * xx]
    worst: dict[str, float] = {}
    for obj, lab in labels.items():
        lab_host = lab.cpu().numpy()
        truth = np.zeros((b, MAX_OBJECTS, len(chans)))
        for c, chan in enumerate(chans):
            host = chan.cpu().numpy()
            for site in range(b):
                truth[site, :, c] = np.bincount(
                    lab_host[site].ravel(), weights=host[site].ravel().astype(np.float64),
                    minlength=MAX_OBJECTS + 1)[1 : MAX_OBJECTS + 1]
        scale = np.abs(truth)
        for strategy in ("fused",) + tuple(strategies):
            got = measure.grouped_sums(lab, chans, MAX_OBJECTS, strategy).cpu().numpy()
            d = np.abs(got.astype(np.float64) - truth)
            rel = np.where(scale > 0, d / np.where(scale > 0, scale, 1.0), np.where(d > 0,
                                                                                   np.inf, 0.0))
            worst[strategy] = max(worst.get(strategy, 0.0), float(rel.max()))
            if strategy != "fused" and bool((rel > SUM_RTOL).any()):
                site, label, c = np.unravel_index(int(np.argmax(rel)), rel.shape)
                raise SmokeFailure(
                    f"{title} {strategy}: {obj} sum {c} of object {label + 1} on site {site} "
                    f"is {got[site, label, c]!r} against the float64 "
                    f"{truth[site, label, c]!r} (relative {rel.max():.3g} > {SUM_RTOL})")
    return worst


def same_result(title: str, a, b) -> None:
    """Two numpy ``SiteResult``s bit for bit."""
    import numpy as np

    for field in ("objects", "counts", "found"):
        x, y = getattr(a, field), getattr(b, field)
        if sorted(x) != sorted(y) or any(not np.array_equal(x[k], y[k]) for k in x):
            raise SmokeFailure(f"{title}: {field} differ between the runs")
    for obj, feats in b.measurements.items():
        for feat, v in feats.items():
            if not np.array_equal(a.measurements[obj][feat], v):
                raise SmokeFailure(f"{title}: {obj}/{feat} differs between the runs")


def strategy_config(torch, pkg, title, desc, data, wrappers, strategies, card) -> dict:
    """One config built on ``fused`` and on each of ``strategies``, each
    held against the fused build (:func:`hold_strategy`) with its launch
    counters (:func:`check_strategy_launches`); ``sort``, where listed,
    run twice and held bit for bit against itself; the raw sums of each
    strategy over the fused build's objects (:func:`hold_sums`).  Prints
    each build's ms a batch (:func:`time_strategies`); returns the runs."""
    pipeline = pkg["pipeline"]
    n = next(iter(data.values())).shape[0]
    inputs = pipeline.from_jax_inputs(data, {}, [[0, 0]] * n, device="cuda")
    runs = {"fused": strategy_batch(torch, pipeline, desc, inputs, wrappers, "fused")}
    truths: dict = {}
    check_strategy_launches(title, "fused", runs["fused"]["launches"])
    for strategy in strategies:
        run = strategy_batch(torch, pipeline, desc, inputs, wrappers, strategy)
        check_strategy_launches(title, strategy, run["launches"])
        worst, exact, order = hold_strategy(f"{title} {strategy}", run["host"],
                                            runs["fused"]["host"], data, truths)
        if strategy == "sort":
            same_result(f"{title} sort", pipeline.site_result_to_numpy(run["fn"](*inputs)),
                        run["host"])
        print(f"  {title} {strategy}: labels and counts exact against fused, {exact} "
              f"integral Intensity_sum rows exact, features by CARD_TIERS (largest "
              f"|{strategy} - fused| by family "
              + ", ".join(f"{k} {d:.3g} ({f})" for k, (d, f) in sorted(worst.items()))
              + (")" if strategy != "sort" else "); sort bit-equal run to run"))
        print(f"  {title} {strategy}: order features object by object against float64 "
              f"(largest distance {strategy} / fused, largest share of the allowance, largest "
              f"allowance, cells held / left out as ill-conditioned) -- " + "; ".join(
                  f"{k} {v['got']:.3g} / {v['fused']:.3g}, {v['share']:.3g}, "
                  f"{v['allow']:.3g}, {v['held']} / {v['left_out']}"
                  for k, v in sorted(order.items())))
        runs[strategy] = run
    sums = hold_sums(torch, title, runs["fused"]["result"].objects, data, strategies)
    print(f"  {title}: raw sums (v, v*v, y, x, yy, xx, yx) object by object within "
          f"{SUM_RTOL} of float64 on " + ", ".join(strategies) + " (largest relative distance "
          + ", ".join(f"{s} {d:.3g}" for s, d in sums.items()) + "; fused not held)")
    time_strategies(torch, runs, inputs)
    print(f"  {title}: ms per batch of {n}, median [least, most] of {STRATEGY_ROUNDS} "
          f"alternating rounds -- " + ", ".join(
              f"{s} {r['ms']:.3f} [{r['ms_range'][0]:.3f}, {r['ms_range'][1]:.3f}]"
              for s, r in runs.items()) + " (launches of rows 1-6: " + "; ".join(
        f"{s} " + " ".join(str(r["launches"][k]) for k in SEGMENT_KERNELS + MEASURE_KERNELS)
        for s, r in runs.items()) + f") on {card}")
    return runs


def strategy_submit(torch, wrappers, card) -> dict:
    """One well of phase 5's plate (2x2 sites) through ``workflow submit
    --device cuda --reduction-strategy scatter`` and through the default
    (fused): the scatter run launches rows 1-3 and not row 4, its perf
    store's jterator program is keyed ``scatter`` (the fused run's
    ``fused``), and its store holds the fused store's labels exactly and
    its features by :data:`CARD_TIERS`."""
    import numpy as np

    from tmlibrary_tpu_torch import benchmarks, capacity, cli, perf, telemetry
    from tmlibrary_tpu_torch.models.experiment import grid_experiment
    from tmlibrary_tpu_torch.models.store import ExperimentStore
    from tmlibrary_tpu_torch.workflow import engine

    base = Path(__file__).resolve().parent / "build" / f"phase16.{os.getpid()}"
    shutil.rmtree(base, ignore_errors=True)
    was_on = telemetry.enabled()
    try:
        telemetry.set_enabled(True)
        exp = grid_experiment("phase16", well_rows=1, well_cols=1,
                              sites_per_well=SITES_PER_WELL, channel_names=("DAPI", "Actin"),
                              site_shape=(SIZE, SIZE))
        n = exp.n_sites
        data = benchmarks.synthetic_cell_painting_batch(n, size=SIZE, seed=SEED)
        roots = {name: base / name for name in ("fused", "scatter")}
        store = ExperimentStore.create(roots["fused"], exp)
        for c, ch in enumerate(("DAPI", "Actin")):
            store.write_sites(data[ch].astype(np.uint16), list(range(n)), channel=c)
        copy_part(roots["fused"], roots["scatter"], "images")
        (base / "cp.pipe.json").write_text(json.dumps(benchmarks.CELL_PAINTING_PIPE))
        desc_path = base / "workflow.json"
        engine.WorkflowDescription.canonical({"jterator": {
            "pipe": str(base / "cp.pipe.json"), "batch_size": STEP_BATCH,
            "max_objects": MAX_OBJECTS}}).save(desc_path)
        out = {}
        for name, extra in (("scatter", ["--reduction-strategy", "scatter"]), ("fused", [])):
            capacity.reset_routing_history()
            perf.reset_profiles()
            for w in wrappers.values():
                w.launches = 0
            run_cli(cli, ["workflow", "submit", "--root", str(roots[name]), "--description",
                          str(desc_path), "--device", "cuda", *extra])
            torch.cuda.synchronize()
            keys = sorted({str(p["strategy"]) for p in perf.perf_profiles()
                           if p["step"] == "jterator"})
            out[name] = {"keys": keys, "launches": {k: wrappers[k].launches
                                                    for k in SEGMENT_KERNELS + MEASURE_KERNELS}}
            if keys != [name]:
                raise SmokeFailure(f"submit --reduction-strategy {name}: perf store keys {keys}")
        check_strategy_launches("submit", "scatter", out["scatter"]["launches"])
        check_strategy_launches("submit", "fused", out["fused"]["launches"])
        _, worst = hold_batch(ExperimentStore.open(roots["scatter"]),
                              ExperimentStore.open(roots["fused"]), list(range(n)), CARD_TIERS,
                              gate=True)
        print(f"  workflow submit --device cuda --reduction-strategy scatter over one well "
              f"({n} sites of {SIZE}x{SIZE}): perf store program keyed {out['scatter']['keys']}"
              f" (default: {out['fused']['keys']}); launches of rows 1-6 "
              f"{out['scatter']['launches']} (default {out['fused']['launches']}); labels "
              f"exact against the default run, features by CARD_TIERS (largest |scatter - "
              f"fused| by family " + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items()))
              + f"); {card}")
        return out
    finally:
        capacity.reset_routing_history()
        perf.reset_profiles()
        telemetry.set_enabled(was_on)
        shutil.rmtree(base, ignore_errors=True)


def image_model_on_card(torch, pkg, run3, data, card) -> None:
    """The image model on the card: a DAPI site through
    ``ChannelImage.correct(stats).align(dy, dx).smooth(1.5)`` equals the
    ops called in turn; ``SegmentationImage(nuclei).n_objects`` equals the
    counts; ``extract_polygons`` of the card's labels equals the CPU
    run's; ``Image.join`` of 4 sites equals ``join_grid``; a tile's PNG
    decodes to the tile."""
    import numpy as np

    from tmlibrary_tpu_torch.io import png
    from tmlibrary_tpu_torch.models.image import (
        ChannelImage, IllumstatsContainer, Image, PyramidTile, SegmentationImage,
    )
    from tmlibrary_tpu_torch.ops import image_ops
    from tmlibrary_tpu_torch.ops.smooth import gaussian_smooth

    pipeline, desc = pkg["pipeline"], pkg["desc3"]
    sites = torch.from_numpy(data["DAPI"][:4]).to("cuda")
    rng = np.random.default_rng(SEED)
    mean_log = (2.5 + 0.3 * rng.random((SIZE, SIZE))).astype(np.float32)
    std_log = (0.1 + 0.2 * rng.random((SIZE, SIZE))).astype(np.float32)
    got = ChannelImage(sites[0], {"site": 0}).correct(
        IllumstatsContainer(mean_log, std_log, {}, 1)).align(3, -5).smooth(1.5)
    m, s = (torch.from_numpy(a).to("cuda") for a in (mean_log, std_log))
    step = image_ops.correct_illumination(sites[0], m, s)
    step = image_ops.align(step[None], torch.tensor([[3, -5]], device="cuda"))[0]
    want = gaussian_smooth(step, 1.5)
    if got.array.device.type != "cuda" or not torch.equal(got.array, want):
        raise SmokeFailure("ChannelImage.correct.align.smooth differs from the ops")
    nuclei = run3["result"].objects["nuclei"]
    n_obj = SegmentationImage(nuclei).n_objects
    if n_obj.device.type != "cuda" or not np.array_equal(n_obj.cpu().numpy(),
                                                         run3["host"].counts["nuclei"]):
        raise SmokeFailure("SegmentationImage.n_objects differs from the counts")
    sub = {k: v[:2] for k, v in data.items()}
    craw, cstats, cshifts = pipeline.from_jax_inputs(sub, {}, [[0, 0]] * 2, device="cpu")
    cpu = pipeline.ImageAnalysisPipeline(desc, MAX_OBJECTS, device="cpu").build_batch_fn()(
        craw, cstats, cshifts)
    n_poly = 0
    for k in range(2):
        a = SegmentationImage(nuclei[k]).extract_polygons()
        b = SegmentationImage(cpu.objects["nuclei"][k]).extract_polygons()
        if [lab for lab, _ in a] != [lab for lab, _ in b] or any(
                not np.array_equal(x, y) for (_, x), (_, y) in zip(a, b)):
            raise SmokeFailure(f"extract_polygons of site {k} differs from the CPU run's")
        n_poly += len(a)
    joined = Image.join([Image(sites[k]) for k in range(4)], 2, 2).array
    if not torch.equal(joined, image_ops.join_grid(sites, 2, 2)):
        raise SmokeFailure("Image.join differs from join_grid")
    tile = torch.clamp(sites[1] / 16.0, 0, 255).to(torch.uint8)
    if not np.array_equal(png.decode(PyramidTile(tile).encode_png()), tile.cpu().numpy()):
        raise SmokeFailure("PyramidTile.encode_png does not decode to the tile")
    print(f"  image model on the card: ChannelImage.correct.align.smooth equals the ops, "
          f"n_objects equals the counts, {n_poly} polygons of 2 sites equal the CPU run's, "
          f"Image.join of 4 sites equals join_grid, a tile's PNG decodes to it; {card}")


def phase_strategies(torch, pkg, wrappers, card) -> dict:
    """Phase 16: the reduction strategies and the image model.  Config 3
    (64 sites of 256x256, ``max_objects=256``) built on ``fused`` and on
    each of onehot, sort and scatter, and config 4 with the quantiles on
    fused, onehot and scatter (:func:`strategy_config`); one well through
    ``workflow submit --reduction-strategy scatter``
    (:func:`strategy_submit`); the image model (:func:`image_model_on_card`).
    Returns each config's ms a batch by strategy."""
    import numpy as np

    from tmlibrary_tpu_torch import benchmarks
    from tmlibrary_tpu_torch.jterator.description import PipelineDescription

    started = time.perf_counter()
    print(f"phase 16: the reduction strategies against fused, and the image model; "
          f"times on {card}")
    # the pixels a store holds: uint16 values (phase 5 writes these sites)
    data3 = {k: np.round(v).clip(0, 65535).astype(np.float32) for k, v in
             benchmarks.synthetic_cell_painting_batch(B, size=SIZE, seed=SEED).items()}
    run3 = strategy_config(torch, pkg, "config 3", pkg["desc3"], data3, wrappers,
                           STRATEGIES_C3, card)
    pipe = benchmarks.full_feature_pipe()
    pipe["pipeline"] = [
        {"handles": {**item["handles"], "input": item["handles"]["input"] + [
            {"name": "quantiles", "type": "Boolean", "value": True}]}}
        if item["handles"]["module"] == "measure_intensity" else item
        for item in pipe["pipeline"]]
    data4 = benchmarks.synthetic_full_stack_batch(B, size=SIZE, seed=SEED)
    run4 = strategy_config(torch, pkg, "config 4 with quantiles",
                           PipelineDescription.from_dict(pipe), data4, wrappers,
                           STRATEGIES_C4, card)
    if not (run4["fused"]["launches"]["intensity_hist"] and run4["fused"]["launches"]["glcm_all"]):
        raise SmokeFailure("config 4 fused: rows 5 and 6 were not launched")
    strategy_submit(torch, wrappers, card)
    image_model_on_card(torch, pkg, run3["fused"], data3, card)
    ms = {"config3": {s: r["ms"] for s, r in run3.items()},
          "config4_quantiles": {s: r["ms"] for s, r in run4.items()}}
    spread = {"config3": {s: r["ms_range"] for s, r in run3.items()},
              "config4_quantiles": {s: r["ms_range"] for s, r in run4.items()}}
    print(f"  phase 16: {time.perf_counter() - started:.1f} s on {card}")
    print("strategies: " + json.dumps({"ms_per_batch": ms, "ms_range": spread,
                                       "rounds": STRATEGY_ROUNDS, "batch": B, "card": card}))
    return ms


if __name__ == "__main__":
    sys.exit(main())
