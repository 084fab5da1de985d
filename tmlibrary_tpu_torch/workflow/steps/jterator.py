"""jterator: run the image-analysis pipeline over all sites.

Counterpart: ``tmlibrary_tpu/workflow/steps/jterator.py``
(``ImageAnalysisRunner``, ``:110-1949``; reference
``tmlib/workflow/jterator/api.py`` ``ImageAnalysisPipeline``).

The sites layout (the default): plan batches of sites (with the
work-aware schedule), load each batch's channels from the store, correct
them with corilla's statistics, align them with the align step's shift
table and crop them to its intersection window, run the pipeline on
``device``, route each batch to an object-capacity bucket (escalating one
rung up when a batch saturates it), write label stacks and feature
shards, and register mapobject types in ``collect``.

The spatial layout (``layout="spatial"``, ``:834-1179``): one batch per
well.  The well's sites are stitched into one mosaic (corrected and
shift-aligned as the sites layout prepares them), smoothed, cut at
Otsu's threshold (over the pixels that carry data when alignment
zero-filled some) and labeled as one image, so an object that crosses a
site seam keeps one id; ``spatial_secondary_channel`` grows secondary
objects from those seeds by the watershed through another channel.  On
one rank the mosaic goes through the CC and watershed kernels whole; on
several, through the halo-exchanged blocks of :mod:`..parallel`.  The
persist writes per-site label stacks carrying the global ids and one
feature shard per well (``site_index`` -1), measured on the host
(:func:`~tmlibrary_tpu_torch.ops.mosaic.mosaic_feature_table`).

The batch arguments are the reference's, with the same names, types,
defaults and choices, so a ``batch_*.json`` written by either package
resolves in the other.  What the port does with them:

- ``n_devices`` is clamped to the process group (0: all of it; without
  a group, one rank).  Above one rank, the sites layout runs each
  member's slice of the batch
  (:meth:`~tmlibrary_tpu_torch.jterator.pipeline.ImageAnalysisPipeline.build_sharded_batch_fn`)
  and the spatial layout each member's block of the mosaic, on the
  largest rows or ``rows x cols`` mesh that divides it
  (``spatial_grid``).  Every rank runs every batch; only rank 0 writes
  to the store.  The engine's window persists on the calling thread at
  several ranks, so the ranks' collectives (the launch's, and an
  escalation's re-launch in the persist) stay in one order.
- ``as_polygons`` writes ``segmentations/<objects>_polygons_<shard>.parquet``
  (:mod:`~tmlibrary_tpu_torch.ops.polygons`) and ``figures``
  segmentation overlays to ``figures/`` (:mod:`~tmlibrary_tpu_torch.jterator.figures`).
- With QC on (the step's ``qc`` argument, else
  :func:`tmlibrary_tpu_torch.qc.enabled`) the batch function also returns
  the per-site image statistics and the DL segmenters' ``__model__``
  streams, and each persisted batch is folded into the QC session
  (``observe_batch``, the reference's ``:1631-1662``); its summary rides
  the batch result as ``"qc"``, from which the engine writes the
  ``qc_batch``/``qc_site`` events.
- A family that measures ``Morphology_area`` on 2-D labels gets
  ``Morphology_solidity`` joined on the host when the batch persists,
  from the exported, padded-back labels
  (:func:`~tmlibrary_tpu_torch.native.solidity_batch`), as the reference does
  (``:1499-1511``).
- ``donate_buffers`` is accepted and has no effect: the port has no
  buffer donation.  ``reduction_strategy`` resolves once a step to a
  name (:func:`~tmlibrary_tpu_torch.ops.reduction.resolve_reduction_strategy`;
  ``auto`` is the setting, then the cuda-scoped tuning verdict, then
  ``fused``) that every batch function of the step is built with
  (``build_batch_fn(reduction_strategy=...)``) and that keys the perf
  store's programs: ``fused`` runs the measure kernels (rows 4-6),
  ``onehot``, ``sort`` and ``scatter`` the reference's PyTorch routes of
  those names (:mod:`tmlibrary_tpu_torch.ops.measure`).
- ``batch_size=0`` is, on the card, the ``best_batch`` of a tuning file
  measured on ``cuda``, else 32; a verdict of another backend (the
  repo's ``tuning/TUNING.json`` is a TPU's) sets nothing
  (:mod:`tmlibrary_tpu_torch.tuning`).  The bucket router's first batch
  takes the cuda-scoped ``object_capacity`` verdict as its hint, and the
  schedule's ``auto`` the cuda-scoped ``schedule`` verdict.
- The reference's compile-ahead speculation (``:1303-1423``) has no
  meaning without a compile step and is left out, as are its bucket
  and schedule gauges.  The step counts ``tmx_jterator_sites_total`` and
  keeps ``tmx_jterator_sites_per_sec`` over the wall time since its
  first batch, as the reference's does; at several ranks
  :meth:`ImageAnalysisRunner.run_batch` gathers each rank's completion
  time on rank 0 (:func:`~tmlibrary_tpu_torch.telemetry.device_wall_times`)
  into ``tmx_device_batch_seconds`` and the straggler skew, and the batch
  summary carries ``device_wall_times``/``straggler_skew_s``.  The first
  batch of each program (description digest and capacity) in a process
  counts cold (:func:`~tmlibrary_tpu_torch.aotstore.note_program`), and
  its first call of each capacity lands in the perf store as the
  program's compile (:func:`~tmlibrary_tpu_torch.perf.instrument_call`:
  that call's wall; its FLOPs and bytes under ``--profile``).
- Feature shards are Parquet
  (:meth:`~tmlibrary_tpu_torch.models.store.ExperimentStore.append_features`),
  built column-wise with the reference's rows, order and values.

The pipeline cache holds one
:class:`~tmlibrary_tpu_torch.jterator.pipeline.ImageAnalysisPipeline` per
(capacity, mesh size, QC gate, weight digests)
(:func:`~tmlibrary_tpu_torch.jterator.pipeline.pipeline_identity`), with
the intersection window read once from the store.  In the
launch/persist split (:mod:`~tmlibrary_tpu_torch.workflow.pipelined`),
:meth:`ImageAnalysisRunner.launch_batch` moves the inputs to the device,
calls the batch function (or segments the well) and records a CUDA
event; ``block_batch`` waits on that event alone, and ``persist_batch``
fetches the results with ``.cpu()`` on the persist worker and writes
them.
"""

from __future__ import annotations

import fcntl
import json
import logging
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

from tmlibrary_tpu_torch import aotstore, capacity, perf, telemetry, tuning
from tmlibrary_tpu_torch import qc as qc_mod
from tmlibrary_tpu_torch.errors import (
    JobDescriptionError,
    PeerFailed,
    PipelineError,
    StoreError,
)
from tmlibrary_tpu_torch.io import parquet
from tmlibrary_tpu_torch.jterator import figures
from tmlibrary_tpu_torch.jterator.description import PipelineDescription
from tmlibrary_tpu_torch.jterator.pipeline import (
    MODEL_QC_KEY,
    ImageAnalysisPipeline,
    description_digest,
    pipeline_identity,
)
from tmlibrary_tpu_torch.models.image import IllumstatsContainer
from tmlibrary_tpu_torch.models.mapobject import (
    MapobjectType,
    MapobjectTypeRegistry,
    min_poly_zoom,
    plate_mosaic_shape,
)
from tmlibrary_tpu_torch.native import solidity_batch
from tmlibrary_tpu_torch.ops import polygons
from tmlibrary_tpu_torch.ops.image_ops import correct_illumination
from tmlibrary_tpu_torch.ops.mosaic import mosaic_feature_table
from tmlibrary_tpu_torch.ops.pyramid import n_pyramid_levels
from tmlibrary_tpu_torch.ops.reduction import resolve_reduction_strategy
from tmlibrary_tpu_torch.parallel import distributed
from tmlibrary_tpu_torch.parallel import label as par_label
from tmlibrary_tpu_torch.parallel.halo import gather_blocks
from tmlibrary_tpu_torch.parallel.mesh import site_mesh, spatial_mesh
from tmlibrary_tpu_torch.utils import create_partitions
from tmlibrary_tpu_torch.workflow import schedule as schedule_mod
from tmlibrary_tpu_torch.workflow.api import Step
from tmlibrary_tpu_torch.workflow.args import Argument, ArgumentCollection
from tmlibrary_tpu_torch.workflow.pipelined import (
    PipelinedExecutor,
    PipelineStats,
    resolve_pipeline_depth,
)
from tmlibrary_tpu_torch.workflow.registry import register_step

logger = logging.getLogger(__name__)

#: the feature table's leading columns, in the reference's order
SITE_COLUMNS = ("site_index", "plate", "well_row", "well_col", "site_y", "site_x")


def to_site_frame(objects: dict, measurements: dict, window) -> tuple[dict, dict]:
    """Labels computed in the cropped intersection frame, back in the
    site frame: each label array's last two axes padded with the window's
    ``(top, bottom, left, right)`` margins, ``Morphology_centroid_y``/``_x``
    shifted by ``top``/``left`` (``tmlibrary_tpu/workflow/steps/jterator.py:1480-1497``).
    ``window=None`` returns the inputs."""
    if window is None:
        return objects, measurements
    top, bottom, left, right = window
    objects = {
        name: np.pad(lab, [(0, 0)] * (lab.ndim - 2) + [(top, bottom), (left, right)])
        for name, lab in objects.items()
    }
    shifted = {}
    for obj, feats in measurements.items():
        feats = dict(feats)
        if "Morphology_centroid_y" in feats:
            feats["Morphology_centroid_y"] = feats["Morphology_centroid_y"] + top
            feats["Morphology_centroid_x"] = feats["Morphology_centroid_x"] + left
        shifted[obj] = feats
    return objects, shifted


def feature_table(counts, feats: dict, site_meta: list[dict], max_objects: int) -> dict:
    """The (objects x features) table of one batch, column by column: for
    each site ``b`` its rows ``label = 1..min(counts[b], max_objects)``,
    the site's metadata repeated, and each feature's ``float(arr[b,
    label - 1])`` as float64; the rows, order and values of the
    reference's row-by-row ``_feature_table`` (``:1685-1702``)."""
    n = np.minimum(np.asarray(counts, np.int64), int(max_objects))
    n = np.maximum(n, 0)
    table: dict[str, np.ndarray] = {}
    for k in SITE_COLUMNS:
        values = [meta[k] for meta in site_meta]
        dtype = str if k == "plate" else np.int64
        table[k] = np.repeat(np.asarray(values, dtype=dtype), n)
    table["label"] = (
        np.concatenate([np.arange(1, c + 1, dtype=np.int64) for c in n])
        if len(n) else np.zeros(0, np.int64)
    )
    for fname, arr in feats.items():
        arr = np.asarray(arr)
        table[fname] = (
            np.concatenate([arr[b, :c] for b, c in enumerate(n)]).astype(np.float64)
            if len(n) else np.zeros(0, np.float64)
        )
    return table


def _well_shard(batch: dict) -> str:
    """The one home of the per-well shard token used by feature shards,
    polygon files and figures alike (``:50-54``)."""
    plate, well_row, well_col = batch["well"]
    return f"well_{plate}_{well_row:02d}_{well_col:02d}"


def _best_spatial_grid(requested: int, hm: int, wm: int) -> tuple[int, int]:
    """Largest ``nr * nc <= requested`` with ``nr`` dividing the mosaic
    rows and ``nc`` the columns; equal products prefer more rows
    (``:57-69``)."""
    best = (1, 1)
    for nr in range(requested, 0, -1):
        if hm % nr:
            continue
        cap = requested // nr
        nc = next(k for k in range(cap, 0, -1) if wm % k == 0)
        if nr * nc > best[0] * best[1]:
            best = (nr, nc)
    return best


class _StageClock:
    """Seconds of the device stages of one spatial batch: a CUDA event is
    recorded when a stage's work has been queued on the card and the
    events are read once the batch has been fetched (the host clock on
    the CPU).  Recording an event does not wait for the card."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._marks = [("start", self._now())]

    def _now(self):
        if not self._cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def __call__(self, stage: str) -> None:
        self._marks.append((stage, self._now()))

    def seconds(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for (_, a), (stage, b) in zip(self._marks, self._marks[1:]):
            if self._cuda:
                b.synchronize()
                dt = a.elapsed_time(b) / 1e3
            else:
                dt = b - a
            out[stage] = out.get(stage, 0.0) + dt
        return out


def _host_shift(img: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """Integer translate with zero fill, the host twin of
    :func:`~tmlibrary_tpu_torch.ops.image_ops.shift_image`."""
    out = np.roll(img, (int(dy), int(dx)), axis=(0, 1))
    h, w = out.shape
    if dy > 0:
        out[:dy, :] = 0
    elif dy < 0:
        out[h + dy:, :] = 0
    if dx > 0:
        out[:, :dx] = 0
    elif dx < 0:
        out[:, w + dx:] = 0
    return out


@register_step("jterator")
class ImageAnalysisRunner(Step):
    collective = True
    batch_args = ArgumentCollection(
        Argument("pipe", str, default="",
                 help="path to the .pipe.yaml pipeline description "
                      "(required for --layout sites)"),
        Argument("layout", str, default="sites", choices=("sites", "spatial"),
                 help="'sites': vmap the module chain over per-site batches; "
                      "'spatial': stitch each well into one mosaic, row-shard "
                      "it over the device mesh and segment it with halo "
                      "exchange + distributed connected components — objects "
                      "crossing site borders get ONE id (the reference splits "
                      "them, SURVEY.md §6 long-context row)"),
        Argument("spatial_channel", str, default="",
                 help="channel segmented in spatial layout "
                      "(default: first experiment channel)"),
        Argument("spatial_sigma", float, default=1.5,
                 help="gaussian sigma for spatial-layout smoothing"),
        Argument("spatial_grid", str, default="auto",
                 choices=("auto", "rows", "grid"),
                 help="spatial-layout mesh shape: 'rows' shards the mosaic "
                      "row axis 1-D; 'grid' tiles it rows x cols (2-D halo "
                      "exchange, corner-exact seams); 'auto' picks whichever "
                      "uses more devices — results are identical either way"),
        Argument("spatial_objects", str, default="mosaic_cells",
                 help="objects name for spatial-layout segmentation output"),
        Argument("spatial_zernike_degree", int, default=9,
                 help="Zernike moment degree for spatial-layout features "
                      "(matches measure_zernike's default; 0 disables)"),
        Argument("spatial_secondary_channel", str, default="",
                 help="grow secondary objects (cells) from the primary "
                      "mosaic objects through THIS channel via distributed "
                      "watershed — ids stay the primary's global ids "
                      "(empty: disabled)"),
        Argument("spatial_secondary_objects", str, default="mosaic_secondary",
                 help="objects name for the spatial secondary segmentation"),
        Argument("spatial_secondary_factor", float, default=1.0,
                 help="otsu correction factor for the secondary mask "
                      "(segment_secondary's correction_factor)"),
        Argument("spatial_secondary_levels", int, default=32,
                 help="watershed flooding levels for the secondary mask "
                      "(segment_secondary's n_levels)"),
        Argument("spatial_align", bool, default=True,
                 help="apply align-step shifts when stitching (the sites "
                      "layout gates this per pipe channel; disable if the "
                      "stored registration is untrusted)"),
        Argument("batch_size", int, default=0,
                 help="sites per device batch (0 = auto: on the card the "
                      "best_batch of a tuning/TUNING.json measured on "
                      "cuda, else 32)"),
        Argument("max_objects", int, default=256,
                 help="static per-site object capacity"),
        Argument("object_buckets", str, default="auto",
                 help="object-capacity bucket ladder (capacity.py): "
                      "'auto' builds a pipeline per power-of-two bucket "
                      "up to max_objects and routes each batch by observed "
                      "object counts (the first batch by the cuda-scoped "
                      "tuned object_capacity, else the smallest bucket); "
                      "'off' pins every batch at max_objects; or an "
                      "explicit comma list of capacities, e.g. '8,32'. "
                      "Results are bit-identical across bucket choices — "
                      "routing is purely a performance decision"),
        Argument("schedule", str, default="auto",
                 choices=("auto", "pack", "off"),
                 help="work-aware site scheduling (workflow/schedule.py): "
                      "'pack' plans cost-model batches (rung-homogeneous "
                      "packing + straggler-balanced shard order) from the "
                      "per-site count history; 'off' keeps directory-order "
                      "batching; 'auto' follows the schedule setting "
                      "(TM_SCHEDULE), then the verdict of a "
                      "tuning/TUNING.json measured on the same backend, "
                      "then packs. Results are "
                      "bit-identical per site either way — scheduling is "
                      "purely a performance decision"),
        Argument("reduction_strategy", str, default="auto",
                 choices=("auto", "onehot", "sort", "scatter", "fused"),
                 help="grouped-reduction strategy name (ops/reduction.py), "
                      "resolved as the argument, then the "
                      "reduction_strategy setting (TM_REDUCTION_STRATEGY), "
                      "then the verdict of a tuning/TUNING.json measured "
                      "on the same backend, then 'fused'. 'fused' runs the "
                      "measure kernels (grouped_stats, intensity_hist, "
                      "glcm_all; their plain versions on the CPU), 'onehot' "
                      "chunked one-hot products, 'sort' a stable sort and "
                      "sorted-run reductions (bit-identical run to run), "
                      "'scatter' index_add/scatter_reduce; the resolved "
                      "name keys the perf store's programs"),
        Argument("donate_buffers", bool, default=True,
                 help="donate each batch's raw-image/stats/shift device "
                      "buffers to the compiled program so XLA reuses "
                      "their memory for outputs (safe: the engine "
                      "transfers fresh arrays per batch)"),
        Argument("auto_resegment", bool, default=True,
                 help="collect re-runs saturated batches at doubled "
                      "max_objects (bounded at 4096) until counts fit; "
                      "disable to keep the manual warn-and-rerun flow"),
        Argument("n_devices", int, default=0, help="mesh size (0 = all)"),
        Argument("cycle", int, default=0),
        Argument("tpoint", int, default=0),
        Argument("zplane", int, default=0),
        Argument("as_polygons", bool, default=False,
                 help="also trace object outlines host-side"),
        Argument("figures", bool, default=False,
                 help="write segmentation-overlay PNGs: per site in the "
                      "sites layout, one downsampled whole-well mosaic per "
                      "object family in the spatial layout (reference: "
                      "jterator module plot/Figure artifacts)"),
    )


    def __init__(self, store, device: "str | torch.device" = "cuda",
                 qc: "bool | None" = None):
        super().__init__(store, device)
        #: QC for this step: None follows qc.enabled() at each build
        self._qc = qc
        # (capacity, pipeline identity) -> batch function; the bucket router
        # builds one pipeline per capacity it routes to, collect's
        # resegmentation one per raised cap
        self._pipelines: dict[tuple, object] = {}
        self._desc = None
        self._program_name: str | None = None
        self._window: tuple[int, int, int, int] | None = None
        self._window_resolved = False
        # prefetch workers read the description while the engine thread
        # builds pipelines; the persist worker routes escalations
        self._pipeline_lock = threading.Lock()
        self._bucket_lock = threading.Lock()
        self._routing_keys: dict[tuple, str] = {}
        self._strategies: dict[str, str] = {}
        #: the last pipelined run's phase times (``PipelineStats.summary``)
        #: and each batch's (``PipelineStats.per_batch``)
        self.pipeline_stats: dict | None = None
        self.pipeline_batch_times: dict | None = None

    # ------------------------------------------------------------------ plan
    def create_batches(self, args):
        if args["layout"] == "spatial":
            # one batch per well: the well mosaic is the sharding unit
            wells: dict[tuple, list[int]] = {}
            for i, r in enumerate(self.store.experiment.sites()):
                wells.setdefault((r.plate, r.well_row, r.well_column), []).append(i)
            return [{"sites": idxs, "well": list(key)} for key, idxs in sorted(wells.items())]
        if not args["pipe"]:
            raise ValueError("--pipe is required for --layout sites")
        sites = list(range(self.store.n_sites))
        batch_size = args["batch_size"] or self._auto_batch_size()
        plan = self._schedule_plan(args, sites, batch_size)
        if plan is not None:
            schedule_mod.write_plan(self._schedule_plan_path, plan)
            return [
                {
                    "sites": b["sites"],
                    "schedule": {
                        "rung": b["rung"],
                        "predicted": b["predicted"],
                        "shard_work": b["shard_work"],
                        "shard_work_naive": b["shard_work_naive"],
                        "plan_digest": plan["digest"],
                    },
                }
                for b in plan["batches"]
            ]
        return [
            {"sites": part} for part in create_partitions(sites, batch_size)
        ]

    def init(self, args=None):
        """Harvest the previous run's persisted per-site object counts
        into the scheduler's cost model before ``delete_previous_output``
        wipes the feature shards they live in."""
        resolved = self.batch_args.resolve(args)
        if resolved.get("layout", "sites") == "sites" and resolved.get("pipe"):
            self._seed_schedule_history(resolved)
        return super().init(args)

    def _seed_schedule_history(self, args) -> None:
        try:
            mode, _ = schedule_mod.resolve_schedule(args.get("schedule"), self.device.type)
            if not schedule_mod.schedule_enabled(mode):
                return
            counts = schedule_mod.harvest_store_counts(self.store)
            if not counts:
                return
            ceiling = int(args["max_objects"])
            ladder = capacity.resolve_bucket_ladder(
                ceiling, args.get("object_buckets", "auto"))
            seeded = capacity.seed_site_counts(
                self._routing_key(args, ceiling, ladder), counts)
            if seeded:
                logger.info("schedule: seeded %d site cost(s) from persisted "
                            "feature shards", seeded)
        except Exception:
            # the cost model is a performance input, never a planning
            # dependency: a broken harvest degrades to the prior
            logger.debug("schedule history harvest failed", exc_info=True)

    def _schedule_plan(self, args, sites: list, batch_size: int):
        """The packing plan for the run, or None when scheduling is off,
        the run is too small to pack, or nothing is known of any site."""
        mode, source = schedule_mod.resolve_schedule(args.get("schedule"), self.device.type)
        if not schedule_mod.schedule_enabled(mode) or len(sites) <= 1:
            schedule_mod.write_plan(self._schedule_plan_path, None)
            return None
        ceiling = int(args["max_objects"])
        ladder = capacity.resolve_bucket_ladder(ceiling, args.get("object_buckets", "auto"))
        key = self._routing_key(args, ceiling, ladder)
        table = capacity.site_count_snapshot(key)
        peak = capacity.observed_peak(key)
        if not table and peak is None:
            # cold start: a uniform prediction cannot beat directory order
            schedule_mod.write_plan(self._schedule_plan_path, None)
            return None
        prior = float(peak) if peak is not None else float(max(table.values()))
        predicted = schedule_mod.predict_site_counts(key, sites, prior)
        return schedule_mod.pack_plan(
            sites, predicted, batch_size, ladder, distributed.clamp_devices(args["n_devices"]),
            seed=description_digest(self._description(args)),
            mode=mode, source=source,
        )

    def _auto_batch_size(self) -> int:
        """``batch_size=0``: on the card the tuning file's ``best_batch``
        when it was measured on ``cuda``, else 32 (a CPU run keeps 32, as
        the reference's does)."""
        if self.device.type != "cpu":
            tuned = tuning.tuned_batch_size(self.device.type)
            if tuned:
                logger.info("batch_size auto: %d sites/batch (source: tuning best_batch)",
                            tuned)
                return tuned
        return 32

    # -------------------------------------------------------------- pipeline
    def _description(self, args) -> PipelineDescription:
        """The parsed pipeline description (a ``.pipe.yaml``, or its JSON
        form; a path relative to the store root resolves there)."""
        with self._pipeline_lock:
            if self._desc is None:
                pipe_path = Path(args["pipe"])
                if not pipe_path.is_absolute():
                    pipe_path = self.store.root / pipe_path
                self._desc = PipelineDescription.load(pipe_path)
            return self._desc

    def _program(self, args) -> str:
        """The perf store's and the cold tally's name of this step's
        program (its description's digest, taken once a step)."""
        desc = self._description(args)
        with self._pipeline_lock:
            if self._program_name is None:
                self._program_name = f"jterator:{description_digest(desc)}"
            return self._program_name

    def _pipeline(self, args, capacity_: int | None = None):
        """``(description, batch function, mesh)`` for ``capacity_``
        (default: the ``max_objects`` ceiling): one
        :class:`ImageAnalysisPipeline` per capacity and mesh size, cropping
        to the intersection window when a channel aligns and the align
        step stored one."""
        desc = self._description(args)
        cap = int(capacity_ if capacity_ is not None else args["max_objects"])
        qc_on = qc_mod.enabled() if self._qc is None else self._qc
        mesh = site_mesh(distributed.clamp_devices(args["n_devices"]))
        strategy = self._strategy(args.get("reduction_strategy", "auto"))
        key = (cap, mesh.size, pipeline_identity(desc, qc_on), strategy)
        with self._pipeline_lock:
            if not self._window_resolved:
                if any(ch.align for ch in desc.channels):
                    try:
                        w = self.store.read_intersection()
                        self._window = (w["top"], w["bottom"], w["left"], w["right"])
                    except StoreError:
                        self._window = None  # align step didn't run: no crop
                    if self._window == (0, 0, 0, 0):
                        self._window = None
                self._window_resolved = True
            if key not in self._pipelines:
                self._pipelines[key] = ImageAnalysisPipeline(
                    desc, max_objects=cap, device=self.device
                ).build_sharded_batch_fn(mesh, self._window, qc=qc_on,
                                         reduction_strategy=strategy)
            return desc, self._pipelines[key], mesh

    # ---------------------------------------------------------------- routing
    def _effective_batch(self, batch: dict) -> dict:
        """Fold in collect's auto-resegmentation cap escalation, which
        lives in a side file (``cap_overrides.json``), not in the batch
        file."""
        override = self._cap_overrides().get(str(batch["index"]))
        if override and override > batch["args"].get("max_objects", 0):
            return {**batch, "args": {**batch["args"], "max_objects": int(override)}}
        return batch

    def _ladder(self, args) -> tuple[int, ...]:
        return capacity.resolve_bucket_ladder(
            int(args["max_objects"]), args.get("object_buckets", "auto"))

    def _route_capacity(self, batch: dict) -> int:
        """The object-capacity bucket of a batch at launch: its planned
        rung when the schedule packed it, else the smallest rung that
        holds the peak count persisted so far, else (a cold router) the
        cuda-scoped tuned ``object_capacity`` when it is a rung, else the
        ladder's smallest rung.  A
        mis-route only costs a re-launch one rung up.  Over several ranks
        the rung is the largest any rank routes: they build pipelines of
        that capacity and gather results shaped by it."""
        args = batch["args"]
        ceiling = int(args["max_objects"])
        ladder = self._ladder(args)
        if len(ladder) == 1:
            return ceiling
        planned = (batch.get("schedule") or {}).get("rung")
        if planned and int(planned) in ladder:
            return int(planned)
        observed = capacity.observed_peak(self._routing_key(args, ceiling, ladder))
        if observed is None:
            hint = tuning.tuned_object_capacity(self.device.type)
            cap = int(hint) if hint and hint in ladder else ladder[0]
        else:
            cap = capacity.select_capacity(observed, ladder)
        if distributed.world_size() > 1:
            cap = distributed.max_over_ranks(cap, self.device)
        return cap

    def _routing_key(self, args, ceiling: int, ladder: tuple[int, ...]) -> str:
        """The pipeline-family key scoping this step's bucket history
        (memoized per (ceiling, ladder))."""
        desc = self._description(args)
        cache_key = (int(ceiling), tuple(ladder))
        with self._bucket_lock:
            key = self._routing_keys.get(cache_key)
            if key is None:
                key = capacity.routing_key(description_digest(desc), ceiling, ladder)
                self._routing_keys[cache_key] = key
            return key

    def _note_peak(self, args, peak: int) -> None:
        """Feed one batch's peak per-site count into the routing history
        (persist-worker side)."""
        ceiling = int(args["max_objects"])
        capacity.note_observed_peak(
            self._routing_key(args, ceiling, self._ladder(args)), peak)

    def _note_site_costs(self, args, sites, site_counts) -> None:
        """Feed one batch's per-site counts into the scheduler's EWMA
        history (persist-worker side; fed whether or not this run packs)."""
        try:
            ceiling = int(args["max_objects"])
            capacity.note_site_counts(
                self._routing_key(args, ceiling, self._ladder(args)),
                {int(s): float(c) for s, c in zip(sites, site_counts)},
            )
        except Exception:
            logger.debug("site-cost history update failed", exc_info=True)

    # -------------------------------------------------------------------- run
    def run_batch(self, batch: dict) -> dict:
        self._mark_work_start()
        batch = self._effective_batch(batch)
        if batch["args"].get("layout", "sites") == "spatial":
            return self._persist_spatial(batch, self._launch_spatial(batch))
        cap = self._route_capacity(batch)
        self._note_program(batch, cap)
        t0 = time.perf_counter()
        result = self._launch(batch, capacity_=cap)
        times = telemetry.device_wall_times(t0, self.device) if telemetry.enabled() else []
        out = self._persist(batch, result, capacity_=cap)
        if len(times) > 1:
            skew = telemetry.record_device_times(times, step=self.name,
                                                 batch=batch.get("index"))
            # rides the summary into batch_done; the engine thread
            # appends the straggler event
            out["device_wall_times"] = {d: round(float(t), 6) for d, t in times}
            out["straggler_skew_s"] = round(float(skew), 6)
        return out

    # -------------------------------------------------- throughput gauge
    # sites/s over the wall time since the first batch, pipelined
    # overlap included
    def _mark_work_start(self) -> None:
        if telemetry.enabled() and getattr(self, "_sites_t0", None) is None:
            self._sites_lock = threading.Lock()
            self._sites_t0 = time.perf_counter()
            self._sites_done = 0

    def _note_sites(self, n: int) -> None:
        if not telemetry.enabled() or getattr(self, "_sites_t0", None) is None:
            return
        with self._sites_lock:
            self._sites_done += int(n)
            elapsed = time.perf_counter() - self._sites_t0
            done = self._sites_done
        reg = telemetry.get_registry()
        reg.counter("tmx_jterator_sites_total").inc(n)
        if elapsed > 0:
            reg.gauge("tmx_jterator_sites_per_sec").set(done / elapsed)

    def _note_program(self, batch: dict, cap: int) -> None:
        """Count the first batch of this program in the process cold."""
        aotstore.note_program(f"{self._program(batch['args'])}:{cap}")

    def run_batches_pipelined(self, batches, depth: int | None = None):
        """Generator over ``(batch, result_summary)`` in batch order, with
        store reads and writes overlapped against the device through
        :class:`~tmlibrary_tpu_torch.workflow.pipelined.PipelinedExecutor`
        (``depth=None``: 8 on the card, 2 on the CPU).  The phase times
        land in :attr:`pipeline_stats` and :attr:`pipeline_batch_times`."""
        if distributed.world_size() > 1:
            # ranks take part in one another's collectives batch by batch
            for batch in batches:
                yield batch, self.run_batch(batch)
            return
        depth, source = resolve_pipeline_depth(depth, self.device)
        stats = PipelineStats(depth, source, step=self.name)
        try:
            yield from PipelinedExecutor(self, depth=depth, stats=stats).run(batches)
        finally:
            self.pipeline_stats = stats.summary()
            self.pipeline_batch_times = stats.per_batch()

    # ------------------------------------------------- launch/persist split
    def prefetch_batch(self, batch: dict) -> dict:
        """Host-side input loading only (store reads, statistics, shift
        rows, the spatial layout's stitch): safe on a prefetch worker."""
        batch = self._effective_batch(batch)
        if batch["args"].get("layout", "sites") == "spatial":
            return self._prefetch_spatial(batch)
        return self._load_inputs(batch)

    def launch_batch(self, batch: dict, prefetched=None):
        """Dispatch; returns ``(effective_batch, ctx)`` with the un-fetched
        results and a CUDA event recorded after the launch in ``ctx``."""
        self._mark_work_start()
        batch = self._effective_batch(batch)
        if batch["args"].get("layout", "sites") == "spatial":
            payload = self._launch_spatial(batch, prefetched)
            cap = None
        else:
            cap = self._route_capacity(batch)
            self._note_program(batch, cap)
            payload = self._launch(batch, prefetched, capacity_=cap)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return batch, (payload, cap, done)

    def block_batch(self, ctx) -> None:
        """Wait for this batch's launched work alone (its event), not for
        the whole device."""
        done = ctx[2]
        if done is not None:
            done.synchronize()

    def persist_batch(self, batch: dict, ctx) -> dict:
        """Fetch and write one launched batch (the effective batch from
        :meth:`launch_batch`)."""
        payload, cap, _ = ctx
        if batch["args"].get("layout", "sites") == "spatial":
            return self._persist_spatial(batch, payload)
        return self._persist(batch, payload, capacity_=cap)

    def _load_inputs(self, batch: dict) -> dict:
        """A batch's store reads, illumination statistics and shift rows,
        all numpy: no device transfer, so a prefetch worker can run it."""
        args = batch["args"]
        sites = list(batch["sites"])
        desc = self._description(args)
        exp = self.store.experiment
        cycle, tpoint, zplane = args["cycle"], args["tpoint"], args["zplane"]

        raw = {}
        for ch in desc.channels:
            idx = exp.channel_index(ch.name)
            if ch.zstack:
                planes = [
                    self.store.read_sites(sites, cycle=cycle, channel=idx,
                                          tpoint=tpoint, zplane=zp)
                    for zp in range(exp.n_zplanes)
                ]
                raw[ch.name] = np.stack(planes, axis=1)  # (B, Z, H, W)
            else:
                raw[ch.name] = self.store.read_sites(sites, cycle=cycle, channel=idx,
                                                     tpoint=tpoint, zplane=zplane)
        for obj in desc.objects_in:
            raw[obj.name] = self.store.read_labels(sites, obj.name, tpoint=tpoint,
                                                   zplane=zplane)

        stats = {}
        for ch in desc.channels:
            # volumes skip correction: don't demand stats they never use
            if ch.correct and not ch.zstack:
                idx = exp.channel_index(ch.name)
                if not self.store.has_illumstats(cycle=cycle, channel=idx):
                    raise PipelineError(
                        f"channel '{ch.name}' wants illumination correction but "
                        f"corilla statistics are missing — run corilla first"
                    )
                cont = IllumstatsContainer.from_store(
                    self.store.read_illumstats(cycle=cycle, channel=idx))
                stats[ch.name] = (cont.mean_log, cont.std_log)

        shifts = np.zeros((len(sites), 2), np.int32)
        if any(ch.align for ch in desc.channels) and self.store.has_shifts(cycle):
            shifts = self.store.read_shifts(cycle)[np.asarray(sites)]
        return {"raw": raw, "stats": stats, "shifts": shifts}

    def _launch(self, batch: dict, inputs: dict | None = None,
                capacity_: int | None = None):
        """Move the (possibly prefetched) inputs to the device and call the
        batch function; on the card this returns once the work is queued
        (less any host syncs inside the pipeline).  With QC on the result
        is ``(SiteResult, qc statistics)``; a rank outside the mesh gets
        None."""
        _, fn, mesh = self._pipeline(batch["args"], capacity_)
        if not mesh.member:
            return None
        if inputs is None:
            inputs = self._load_inputs(batch)
        dev = self.device
        raw = {k: torch.from_numpy(v).to(dev) for k, v in inputs["raw"].items()}
        stats = {k: tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in pair)
                 for k, pair in inputs["stats"].items()}
        shifts = torch.from_numpy(np.ascontiguousarray(inputs["shifts"], np.int32)).to(dev)
        args = batch["args"]
        return perf.instrument_call(
            fn, raw, stats, shifts,
            program=self._program(args),
            capacity=int(capacity_ if capacity_ is not None else args["max_objects"]),
            strategy=self._strategy(args.get("reduction_strategy", "auto")), device=dev)

    def _strategy(self, method: str) -> str:
        """The resolved strategy name of ``method``, once a step (the
        chain reads the settings and the tuning file)."""
        with self._pipeline_lock:
            if method not in self._strategies:
                self._strategies[method] = resolve_reduction_strategy(method,
                                                                      self.device.type)
            return self._strategies[method]

    @staticmethod
    def _host(result, n_valid: int) -> tuple[dict, dict, dict, dict]:
        """The batch's counts, labels, measurements and pre-clip object
        counts on the host, each dict in key order: the reference's jitted
        result comes back with sorted keys, which orders its feature
        columns."""

        def host(d):
            return {k: d[k].detach().cpu().numpy()[:n_valid] for k in sorted(d)}

        return (
            host(result.counts),
            host(result.objects),
            {obj: host(result.measurements[obj]) for obj in sorted(result.measurements)},
            host(result.found),
        )

    @staticmethod
    def _saturates(cap: int, counts: dict, found: dict) -> bool:
        """Whether a run at ``cap`` may have dropped objects: a count AT the
        cap (the reference's rule), or more objects found before the clip
        than the cap holds.  The second catches what the first cannot: the
        area filter runs after the clip, so a site whose found objects
        exceed the cap can still end below it (ROADMAP C)."""
        return any(int(v.max(initial=0)) >= cap for v in counts.values()) or \
            any(int(v.max(initial=0)) > cap for v in found.values())

    def _fetch(self, args: dict, result, n_valid: int, cap: int) -> tuple[tuple, bool]:
        """The batch's results on the host (:meth:`_host`) and whether it
        re-runs at the next rung: saturated below the ceiling.  At several
        ranks the re-run is a collective of the mesh, so below the ceiling
        its members agree first: every member re-runs when any saturated,
        and a fetch that raised on a member raises there and
        :class:`PeerFailed` on the others, so none waits alone."""
        below = cap < int(args["max_objects"])
        if not below or distributed.world_size() == 1:
            host = self._host(result, n_valid)
            return host, below and self._saturates(cap, host[0], host[3])
        err, host, again = None, None, False
        try:
            host = self._host(result, n_valid)
            again = self._saturates(cap, host[0], host[3])
        except Exception as exc:
            err = exc
        code = distributed.max_over_ranks(2 if err is not None else int(again), self.device,
                                          self._pipeline(args, cap)[2].group)
        if err is not None:
            raise err
        if code == 2:
            raise PeerFailed(f"the fetch of a batch at capacity {cap} failed on another rank")
        return host, code == 1

    def _persist(self, batch: dict, result, capacity_: int | None = None) -> dict:
        """Fetch one launched batch's results, escalate its capacity until
        the counts fit, and write labels, feature shards and the
        saturation record."""
        args = batch["args"]
        sites = batch["sites"]
        tpoint, zplane = args["tpoint"], args["zplane"]
        n_valid = len(sites)
        ceiling = int(args["max_objects"])
        cap = int(capacity_) if capacity_ is not None else ceiling
        escalations = 0
        if result is None:  # a rank outside the mesh: nothing ran here
            return {"n_sites": n_valid, "objects": {}}
        result, qc_dev = result if isinstance(result, tuple) else (result, None)
        (counts, objects, measurements, found), again = self._fetch(args, result, n_valid, cap)
        # nothing below the ceiling is persisted from a saturated run, so
        # every rung gives the ceiling's store
        while again:
            new_cap = capacity.select_capacity(cap, self._ladder(args))
            logger.info(
                "batch %s saturated its routed object-capacity bucket "
                "(capacity %d) — re-running at capacity %d",
                batch.get("index"), cap, new_cap,
            )
            escalations += 1
            cap = new_cap
            result = self._launch(batch, capacity_=cap)
            result, qc_dev = result if isinstance(result, tuple) else (result, None)
            (counts, objects, measurements, found), again = self._fetch(args, result,
                                                                        n_valid, cap)

        # every rank keeps the routing history (each holds the whole batch)
        peak = max((int(v.max(initial=0)) for v in counts.values()), default=0)
        self._note_peak(args, peak)
        if counts:
            site_counts = np.maximum.reduce([np.asarray(v) for v in counts.values()])
            self._note_site_costs(args, sites, site_counts)
        if not distributed.is_writer():
            return {"n_sites": n_valid, "objects": {k: int(v.sum()) for k, v in counts.items()}}
        objects, measurements = to_site_frame(objects, measurements, self._window)
        # solidity is hull-based and ragged, so it is measured on the host
        # from the exported labels and joined into the morphology features
        max_obj = args["max_objects"]
        for name, feats in measurements.items():
            if "Morphology_area" in feats and objects.get(name) is not None \
                    and objects[name].ndim == 3:
                feats["Morphology_solidity"] = solidity_batch(objects[name], max_obj)

        for name, labels in objects.items():
            if labels.ndim == 4:  # (B, Z, H, W) volume labels: one stack per z
                for zp in range(labels.shape[1]):
                    self.store.write_labels(labels[:, zp], sites, name,
                                            tpoint=tpoint, zplane=zp)
            else:
                self.store.write_labels(labels, sites, name, tpoint=tpoint, zplane=zplane)

        shard = f"batch_{batch['index']:03d}"
        site_meta = self._site_metadata(sites)
        for name in objects:
            self.store.append_features(
                name, feature_table(counts[name], measurements.get(name, {}), site_meta,
                                    max_obj),
                shard=shard)
            # polygon tracing is 2-D only; volume objects skip it
            if args["as_polygons"] and objects[name].ndim == 3:
                self._write_polygons(name, objects[name], sites, shard)
        if args.get("figures"):
            self._write_site_figures(args, sites, objects)

        summary = {
            "n_sites": n_valid,
            "objects": {k: int(v.sum()) for k, v in counts.items()},
        }
        plan = batch.get("schedule") or {}
        if plan.get("rung"):
            summary["schedule_rung"] = int(plan["rung"])
        total_objects = sum(summary["objects"].values())
        slots = len(counts) * n_valid * cap
        summary["bucket_capacity"] = cap
        summary["bucket_ceiling"] = ceiling
        summary["slot_occupancy"] = round(capacity.slot_occupancy(total_objects, slots), 4)
        if escalations:
            summary["bucket_escalations"] = escalations
        # saturation at the ceiling must be loud: objects beyond the cap
        # were dropped
        saturated = {k: int((v >= max_obj).sum()) for k, v in counts.items()}
        saturated = {k: n for k, n in saturated.items() if n}
        # record unconditionally: a clean re-run clears a stale entry
        self._record_saturation(batch["index"], saturated)
        if saturated:
            summary["saturated"] = saturated
            logger.warning(
                "object capacity saturated (count == max_objects == %d) for "
                "%s — objects beyond the cap were dropped; re-run the step "
                "with a higher max_objects",
                max_obj,
                ", ".join(f"{n} site(s) of '{k}'" for k, n in saturated.items()),
            )
        if qc_dev is not None:
            summary_qc = self._observe_qc(sites, qc_dev, counts, measurements, n_valid,
                                          bool(saturated))
            if summary_qc:
                summary["qc"] = summary_qc
        self._note_sites(n_valid)
        return summary

    def _observe_qc(self, sites, qc_dev: dict, counts: dict, measurements: dict,
                    n_valid: int, saturated: bool) -> dict | None:
        """Fold one persisted batch into the QC session and return its
        summary: the per-site image statistics by channel, the object
        counts, the feature columns (rows past a site's count masked) and
        the modules' ``__model__`` streams, every sample of which counts.
        Channels and statistics go in sorted order, the order in which
        the reference's jitted result hands them over."""
        image_stats = {
            ch: {m: qc_dev[ch][m].detach().cpu().numpy()[:n_valid] for m in sorted(qc_dev[ch])}
            for ch in sorted(qc_dev)
        }
        model_stats = image_stats.pop(MODEL_QC_KEY, None)
        if model_stats:
            measurements = {**measurements, qc_mod.MODEL_OBJECTS: model_stats}
        return qc_mod.get_session(self._qc).observe_batch(
            self.name, sites, image_stats=image_stats, counts=counts,
            measurements=measurements, saturated=saturated)

    def _write_polygons(self, name: str, labels: np.ndarray, sites, shard: str) -> None:
        """One polygon table of the batch's sites (``:1704-1716``)."""
        tables = []
        for b, site in enumerate(sites):
            polys = polygons.labels_to_polygons(labels[b])
            if polys:
                tables.append(polygons.polygons_to_table(polys, site))
        if tables:
            parquet.write_table(
                self.store.root / "segmentations" / f"{name}_polygons_{shard}.parquet",
                polygons.concat_tables(tables))

    def _write_site_figures(self, args, sites, objects: dict) -> None:
        """Segmentation overlays of every 2-D family over the first
        non-z-stack input channel, the raw pixels shifted into the frame
        the labels live in when the channel aligns (``:1534-1561``)."""
        desc = self._description(args)
        first = next((c for c in desc.channels if not c.zstack), None)
        if first is None:
            return
        idx = self.store.experiment.channel_index(first.name)
        base = self.store.read_sites(sites, cycle=args["cycle"], channel=idx,
                                     tpoint=args["tpoint"], zplane=args["zplane"])
        if first.align and self.store.has_shifts(args["cycle"]):
            table = self.store.read_shifts(args["cycle"])
            base = np.stack([_host_shift(base[b], *table[s]) for b, s in enumerate(sites)])
        for name, labels in objects.items():
            if labels.ndim == 3:
                figures.write_figures(self.store.root / "figures", name, base, labels, sites)

    # ------------------------------------------------------------ spatial run
    def _stitched_channel(self, sites, srefs, ch_index: int, args, n_sy: int, n_sx: int,
                          h: int, w: int) -> np.ndarray:
        """One channel's well mosaic (``:749-785``): corrected with
        corilla's statistics when they exist (on ``device``, the sites
        layout's correction), each site shifted by the align step's
        shift when it stored one for the cycle (zero-filled, as the sites
        layout's ``shift_image``; the intersection crop has no meaning at
        mosaic scale)."""
        imgs = self.store.read_sites(sites, cycle=args["cycle"], channel=ch_index,
                                     tpoint=args["tpoint"], zplane=args["zplane"])
        if self.store.has_illumstats(cycle=args["cycle"], channel=ch_index):
            cont = IllumstatsContainer.from_store(
                self.store.read_illumstats(cycle=args["cycle"], channel=ch_index))
            dev = self.device
            imgs = correct_illumination(
                torch.from_numpy(imgs).to(dev),
                torch.from_numpy(np.ascontiguousarray(cont.mean_log)).to(dev),
                torch.from_numpy(np.ascontiguousarray(cont.std_log)).to(dev)).cpu().numpy()
        shifts = None
        if args.get("spatial_align", True) and self.store.has_shifts(args["cycle"]):
            shifts = self.store.read_shifts(args["cycle"])
        mosaic = np.zeros((n_sy * h, n_sx * w), np.float32)
        for img, r, site_idx in zip(imgs, srefs, sites):
            if shifts is not None:
                dy, dx = int(shifts[site_idx][0]), int(shifts[site_idx][1])
                if dy or dx:
                    img = _host_shift(img, dy, dx)
            mosaic[r.site_y * h:(r.site_y + 1) * h, r.site_x * w:(r.site_x + 1) * w] = img
        return mosaic

    def _stitch_validity(self, sites, srefs, args, n_sy: int, n_sx: int, h: int,
                         w: int) -> "np.ndarray | None":
        """The mosaic's pixels that carry data after the alignment shifts
        (``:787-811``); None when no shift moved anything."""
        if not (args.get("spatial_align", True) and self.store.has_shifts(args["cycle"])):
            return None
        shifts = self.store.read_shifts(args["cycle"])
        if not any(int(shifts[s][0]) or int(shifts[s][1]) for s in sites):
            return None
        valid = np.zeros((n_sy * h, n_sx * w), bool)
        for r, site_idx in zip(srefs, sites):
            v = _host_shift(np.ones((h, w), np.float32), int(shifts[site_idx][0]),
                            int(shifts[site_idx][1])) > 0
            valid[r.site_y * h:(r.site_y + 1) * h, r.site_x * w:(r.site_x + 1) * w] = v
        return valid

    def _prefetch_spatial(self, batch: dict) -> dict:
        """The well's geometry and the segmentation channel's stitched
        mosaic and validity (``:816-836``)."""
        args = batch["args"]
        sites = batch["sites"]
        exp = self.store.experiment
        idx = exp.channel_index(args["spatial_channel"] or exp.channels[0].name)
        refs = list(exp.sites())
        srefs = [refs[i] for i in sites]
        h, w = exp.site_height, exp.site_width
        n_sy = max(r.site_y for r in srefs) + 1
        n_sx = max(r.site_x for r in srefs) + 1
        t0 = time.perf_counter()
        return {
            "idx": idx, "srefs": srefs, "h": h, "w": w, "n_sy": n_sy, "n_sx": n_sx,
            "mosaic": self._stitched_channel(sites, srefs, idx, args, n_sy, n_sx, h, w),
            "valid": self._stitch_validity(sites, srefs, args, n_sy, n_sx, h, w),
            "stitch_s": time.perf_counter() - t0,
        }

    def _spatial_mesh(self, args, hm: int, wm: int):
        """The mesh of one well (``:895-952``): as many ranks as
        ``n_devices`` allows that divide the mosaic exactly (padding would
        move the Otsu cut and the border smoothing), as row bands or a
        ``rows x cols`` grid, whichever keeps more ranks busy under
        ``spatial_grid="auto"``; the labels are the same either way."""
        requested = distributed.clamp_devices(args["n_devices"])
        n_rows = next(k for k in range(requested, 0, -1) if hm % k == 0)
        nr, nc = _best_spatial_grid(requested, hm, wm)
        kind = args.get("spatial_grid", "auto")
        use_grid = kind == "grid" or (kind == "auto" and nr * nc > n_rows)
        mesh = spatial_mesh(nr, nc) if use_grid else spatial_mesh(n_rows)
        if mesh.size < requested:
            logger.info("spatial layout: %s mesh uses %d of %d ranks — mosaic %dx%d must "
                        "divide it evenly", "x".join(map(str, mesh.grid)), mesh.size,
                        requested, hm, wm)
        return mesh

    def _launch_spatial(self, batch: dict, prefetched: dict | None = None) -> dict:
        """Segment one well's mosaic (``:838-1002``): Gaussian smoothing,
        Otsu's cut (over the valid pixels when alignment zero-filled some),
        the distributed CC, and with ``spatial_secondary_channel`` the
        distributed watershed from the primary labels through that
        channel's Otsu mask.  Each rank uploads and keeps only its block of
        each image; the label images are gathered on rank 0 alone.  Returns
        the un-fetched labels with what the persist needs; a rank outside
        the mesh, and every rank but 0, gets ``labels`` None."""
        args = batch["args"]
        if prefetched is None:
            prefetched = self._prefetch_spatial(batch)
        mosaic, valid = prefetched["mosaic"], prefetched["valid"]
        dev = self.device
        sites, srefs = batch["sites"], prefetched["srefs"]
        h, w, n_sy, n_sx = (prefetched[k] for k in ("h", "w", "n_sy", "n_sx"))
        stitched = {prefetched["idx"]: mosaic}
        sec_ch = args.get("spatial_secondary_channel", "")

        def get_channel(i: int) -> np.ndarray:
            # with a secondary every mosaic is read at least twice, so they
            # are kept; without one each is read once and let go
            if i in stitched:
                return stitched[i]
            m = self._stitched_channel(sites, srefs, i, args, n_sy, n_sx, h, w)
            if sec_ch:
                stitched[i] = m
            return m

        hm, wm = mosaic.shape
        mesh = self._spatial_mesh(args, hm, wm)
        ctx = {"labels": None, "count": None, "sec": None, "mosaic": mosaic,
               "get_channel": get_channel, "srefs": srefs,
               "mesh_shape": [mesh.grid[0], mesh.grid[1]], "stitch_s": prefetched["stitch_s"]}
        if not mesh.member:
            return ctx
        clock = _StageClock(dev)

        def upload(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(mesh.block(a))).to(dev)

        img, valid_b = upload(mosaic), None if valid is None else upload(valid)
        clock("upload")
        labels, count = par_label.segment_mosaic_block(
            img, mesh, hm, wm, sigma=args["spatial_sigma"], valid=valid_b, mark=clock)
        ctx["count"] = count
        if sec_ch:
            sec_np = np.asarray(get_channel(self.store.experiment.channel_index(sec_ch)),
                                np.float32)
            sec_img = upload(sec_np)
            clock("secondary_upload")
            factor = args["spatial_secondary_factor"]
            t_sec = par_label.sharded_otsu_value(sec_img, mesh, valid_b)
            if valid_b is not None:
                # the same zero-stripe exclusion as the primary cut
                t_sec = torch.tensor(float(t_sec) * factor, dtype=torch.float32, device=dev)
            else:
                t_sec = t_sec * factor
            clock("secondary_otsu")
            sec = par_label.watershed_block(sec_img, labels, sec_img > t_sec, mesh,
                                            n_levels=args["spatial_secondary_levels"])
            clock("watershed")
            ctx["sec"] = (args["spatial_secondary_objects"], sec_np,
                          gather_blocks(sec, mesh, hm, wm, dst=0))
        ctx["labels"] = gather_blocks(labels, mesh, hm, wm, dst=0)
        clock("gather")
        ctx["clock"] = clock
        return ctx

    def _persist_spatial(self, batch: dict, ctx: dict) -> dict:
        """Fetch one well's labels and write them out (``:1004-1052``):
        the primary family, then the secondary one, which keeps the
        primary's ids and count.  The summary's ``stages`` holds the
        seconds of each stage: the host stitch, the device stages on the
        card's clock (:class:`_StageClock`), and the fetch, the host
        features and the writes on the host's."""
        args = batch["args"]
        sites = batch["sites"]
        summary = {"n_sites": len(sites), "layout": "spatial", "mesh_shape": ctx["mesh_shape"]}
        if ctx["labels"] is None or not distributed.is_writer():
            return summary
        # waits for the device stages, so that the fetch is the copy alone
        stages = {"stitch": ctx["stitch_s"], **ctx["clock"].seconds()}
        t0 = time.perf_counter()
        labels = ctx["labels"].cpu().numpy()
        count = int(ctx["count"])
        shard = _well_shard(batch)
        name = args["spatial_objects"]
        families = [(name, labels, ctx["mosaic"])]
        if ctx["sec"] is not None:
            sec_name, sec_np, sec_labels = ctx["sec"]
            families.append((sec_name, sec_labels.cpu().numpy(), sec_np))
        stages.update(fetch=time.perf_counter() - t0, features=0.0)
        t0 = time.perf_counter()
        for fam, fam_labels, fam_mosaic in families:
            stages["features"] += self._persist_mosaic_objects(fam, fam_labels, count, batch,
                                                               ctx, shard)
            if args.get("figures"):
                figures.write_mosaic_figure(self.store.root / "figures", fam, fam_mosaic,
                                            fam_labels, shard)
        stages["writes"] = time.perf_counter() - t0 - stages["features"]
        self._note_sites(len(sites))
        return {"n_sites": len(sites),
                "objects": {fam: count for fam, _, _ in families},
                "mosaic_shape": [int(labels.shape[0]), int(labels.shape[1])],
                "layout": "spatial", "mesh_shape": ctx["mesh_shape"], "stages": stages}

    def _persist_mosaic_objects(self, name: str, labels: np.ndarray, count: int,
                                batch: dict, ctx: dict, shard: str) -> float:
        """One mosaic family (``:1054-1179``): per-site label stacks with
        the global ids, the well's feature shard and, with
        ``as_polygons``, the mosaic-frame polygons (``site`` -1).  Returns
        the seconds the feature table took."""
        args = batch["args"]
        exp = self.store.experiment
        h, w = exp.site_height, exp.site_width
        per_site = np.stack([labels[r.site_y * h:(r.site_y + 1) * h,
                                    r.site_x * w:(r.site_x + 1) * w] for r in ctx["srefs"]])
        self.store.write_labels(per_site, batch["sites"], name, tpoint=args["tpoint"],
                                zplane=args["zplane"])
        channels = [(ch.name, lambda i=ch.index: ctx["get_channel"](i)) for ch in exp.channels]
        t0 = time.perf_counter()
        table = mosaic_feature_table(labels, count, tuple(batch["well"]), channels,
                                     args["spatial_zernike_degree"])
        seconds = time.perf_counter() - t0
        self.store.append_features(name, table, shard=shard)
        if args.get("as_polygons"):
            polys = polygons.labels_to_polygons(labels)
            if polys:
                parquet.write_table(
                    self.store.root / "segmentations" / f"{name}_polygons_{shard}.parquet",
                    polygons.polygons_to_table(polys, site_index=-1))
        return seconds

    # ---------------------------------------------------------------- helpers
    def _site_metadata(self, sites: list[int]) -> list[dict]:
        refs = list(self.store.experiment.sites())
        return [
            {
                "site_index": s,
                "plate": refs[s].plate,
                "well_row": refs[s].well_row,
                "well_col": refs[s].well_column,
                "site_y": refs[s].site_y,
                "site_x": refs[s].site_x,
            }
            for s in sites
        ]

    def collect(self) -> dict:
        """Register mapobject types and summarize counts per object type
        (the reference's collect creates ``MapobjectType`` rows with their
        polygon-zoom threshold)."""
        # resegment first: min_poly_zoom below comes from the mean object
        # area, which capped shards would misstate
        resegmented = self._resegment_saturated()

        registry = MapobjectTypeRegistry(self.store.root)
        exp = self.store.experiment
        n_levels = 1
        for plate in exp.plates:
            n_levels = max(n_levels, n_pyramid_levels(*plate_mosaic_shape(exp, plate.name)))
        summary = {}
        for name in self.store.list_objects():
            try:
                feats = self.store.read_features(name)
            except Exception:
                continue
            summary[name] = int(len(feats["site_index"]))
            mean_px = 0.0
            area_col = next((c for c in ("Morphology_area", "area") if c in feats), None)
            if area_col is not None:
                mean_px = float(feats[area_col].mean())
            registry.register(MapobjectType(
                name=name, ref_type="segmented",
                min_poly_zoom=min_poly_zoom(n_levels, mean_px)))
        out = {"objects_total": summary}
        if resegmented:
            out["resegmented"] = resegmented
        totals = self._saturation_totals()
        if totals:
            out["saturated_sites"] = totals
            logger.warning(
                "object capacity was saturated during this run: %s — those "
                "sites' feature tables and label stacks are missing the "
                "objects beyond the cap; re-run with a higher "
                "max_objects to recover them",
                ", ".join(f"'{k}': {n} site(s)" for k, n in totals.items()),
            )
        if self.pipeline_stats is not None:
            out["pipeline_stats"] = self.pipeline_stats
        return out

    # ------------------------------------------------- saturation bookkeeping
    #: bounded escalation: up to 4 doublings of the init-time cap, never
    #: past the absolute ceiling
    _RESEGMENT_DOUBLINGS = 4
    _RESEGMENT_CEILING = 4096

    def _resegment_plan(self) -> tuple[list[tuple[str, int]], bool]:
        """Rank 0's next round of re-segmentation: the saturated batches
        to re-run with their doubled caps (written to
        ``cap_overrides.json``), in batch order, and whether to stop after
        them -- a batch in manual mode (``auto_resegment: false``) ends the
        escalation and leaves the saturation warning standing."""
        state = self._saturation_state()
        plan: list[tuple[str, int]] = []
        for bidx_str in sorted(state):
            try:
                batch = self.load_batch(int(bidx_str))
            except JobDescriptionError:
                continue  # batches re-planned since; stale entry
            args = batch.get("args", {})
            if not args.get("auto_resegment", True):
                return plan, True
            cap = max(int(args.get("max_objects", 256)),
                      self._cap_overrides().get(bidx_str, 0))
            new_cap = min(cap * 2, self._RESEGMENT_CEILING)
            if new_cap <= cap:
                continue  # ceiling reached; the collect warning fires
            self._write_cap_override(bidx_str, new_cap)
            logger.warning("auto-resegmenting batch %s at max_objects=%d (saturated: %s)",
                           bidx_str, new_cap, state[bidx_str])
            plan.append((bidx_str, new_cap))
        return plan, False

    def _resegment_saturated(self) -> dict:
        """Re-run just the saturated batches at a doubled ``max_objects``
        until their counts fit, the doubling budget runs out or the
        ceiling is hit.  The raised cap lives in ``cap_overrides.json``
        and is applied by :meth:`_effective_batch`.  Over several ranks
        rank 0 reads the saturation state and sends each round's plan to
        every rank; all ranks re-run those batches together (the routed
        capacity agreed by :meth:`_route_capacity`) and rank 0 alone
        persists them.  Every rank calls this: rank 0 from
        :meth:`collect`, the others from :meth:`collective_collect`."""
        done: dict[str, int] = {}
        for _ in range(self._RESEGMENT_DOUBLINGS):
            plan, stop = (self._resegment_plan() if distributed.is_writer()
                          else (None, None))
            plan, stop = distributed.broadcast_object((plan, stop))
            for bidx_str, new_cap in plan:
                self.run(int(bidx_str))  # re-records/clears saturation
                done[bidx_str] = new_cap
            if stop or not plan:
                break
        return done

    def collective_collect(self) -> dict:
        """The part of :meth:`collect` every rank runs together: the
        engine calls it on the ranks other than 0 while rank 0 collects."""
        return self._resegment_saturated()

    @property
    def _schedule_plan_path(self) -> Path:
        return self.step_dir / "schedule_plan.json"

    def schedule_plan_info(self) -> dict | None:
        """The recorded packing plan's summary (the engine's
        ``schedule_plan`` ledger event), re-read from the side file so a
        resume records the digest that ``init`` planned."""
        plan = schedule_mod.load_plan(self._schedule_plan_path)
        return schedule_mod.plan_event(plan) if plan else None

    @property
    def _cap_override_path(self) -> Path:
        return self.step_dir / "cap_overrides.json"

    def _cap_overrides(self) -> dict:
        try:
            return json.loads(self._cap_override_path.read_text())
        except (OSError, ValueError):
            return {}

    def _write_cap_override(self, bidx_str: str, cap: int) -> None:
        state = self._cap_overrides()
        state[bidx_str] = int(cap)
        tmp = self._cap_override_path.with_suffix(f".tmp{os.getpid()}")
        tmp.write_text(json.dumps(state, sort_keys=True))
        os.replace(tmp, self._cap_override_path)

    @property
    def _saturation_path(self) -> Path:
        return self.step_dir / "saturation.json"

    def _record_saturation(self, batch_index: int, saturated: dict) -> None:
        """Persist per-batch saturation keyed by batch index, so collect
        sees it from a fresh process and a re-run overwrites (or clears)
        its own entry; the read-modify-write is flock-serialized and the
        write atomic, since batches may run as concurrent processes."""
        path = self._saturation_path
        if not saturated and not path.exists():
            return
        with open(path.with_suffix(".lock"), "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                state = json.loads(path.read_text()) if path.exists() else {}
            except ValueError:
                state = {}  # torn by a crashed writer; rebuilt from here on
            if saturated:
                state[str(batch_index)] = saturated
            else:
                state.pop(str(batch_index), None)
            tmp = path.with_suffix(f".tmp{os.getpid()}")
            tmp.write_text(json.dumps(state, sort_keys=True))
            os.replace(tmp, path)

    def _saturation_state(self) -> dict:
        """Raw per-batch saturation map: {batch_index_str: {objects: n}}."""
        path = self._saturation_path
        if not path.exists():
            return {}
        try:
            return json.loads(path.read_text())
        except ValueError:
            logger.warning("saturation.json is unreadable (crashed writer?)")
            return {}

    def _saturation_totals(self) -> dict:
        totals: dict[str, int] = {}
        for per_batch in self._saturation_state().values():
            for k, n in per_batch.items():
                totals[k] = totals.get(k, 0) + n
        return totals

    def delete_previous_output(self) -> None:
        for sub in ("segmentations", "features", "figures"):
            d = self.store.root / sub
            if d.exists():
                shutil.rmtree(d)
            d.mkdir()
        # the saturation record, cap escalations and the packing plan
        # belong to the deleted outputs
        self._saturation_path.unlink(missing_ok=True)
        self._saturation_path.with_suffix(".lock").unlink(missing_ok=True)
        self._cap_override_path.unlink(missing_ok=True)
        self._schedule_plan_path.unlink(missing_ok=True)
