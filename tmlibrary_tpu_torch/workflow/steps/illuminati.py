"""illuminati: multi-resolution pyramid tiles for the viewer.

Counterpart: ``tmlibrary_tpu/workflow/steps/illuminati.py`` (reference
``tmlib/workflow/illuminati/api.py`` ``PyramidBuilder``): one batch per
(plate, channel).  The sites are read in batches of ``batch_size``,
prepared on ``device`` (:func:`~tmlibrary_tpu_torch.ops.image_ops.make_batch_prep`:
corilla's correction when ``correct`` and the statistics exist, the
align step's shift when ``align``) and stitched into the plate mosaic,
which stays on the device; the levels are its 2x2 means
(:func:`~tmlibrary_tpu_torch.ops.pyramid.pyramid_levels`).  Each level
is stretched to uint8 on the device, fetched, cut into 256-px tiles and
written as PNG (:mod:`~tmlibrary_tpu_torch.io.png`) by a thread pool to
``pyramids/channel<NN>/<level>/<row>_<col>.png``, beside ``layer.json``
(:class:`~tmlibrary_tpu_torch.models.metadata.ChannelLayer`); the tiles
decode to the JAX package's pixel for pixel.

The display range is corilla's 0.1 and ``clip_percent`` percentiles when
``correct`` is set and the statistics hold them, else ``np.percentile``
of the mosaic on the host.  ``collect`` writes the static Plates, Wells
and Sites outlines as Parquet shards with LIST columns
(:func:`~tmlibrary_tpu_torch.io.parquet.write_table`) and registers their
mapobject types.  With ``n_devices > 1`` on a process group (clamped to
it) the levels are computed row-sharded over that many ranks
(:func:`~tmlibrary_tpu_torch.parallel.halo.sharded_pyramid_levels`,
``:119-127``), bit-identical to one rank's; every member stitches the
plate, and only rank 0 writes the tiles.  The tiles/s telemetry of the
JAX package is not ported (ROADMAP A item 11).
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import shutil

import numpy as np
import torch

from tmlibrary_tpu_torch.io import parquet, png
from tmlibrary_tpu_torch.models.experiment import SiteRef
from tmlibrary_tpu_torch.models.image import IllumstatsContainer
from tmlibrary_tpu_torch.models.mapobject import (
    STATIC_REF_TYPES,
    MapobjectType,
    MapobjectTypeRegistry,
    plate_grid,
    plate_mosaic_shape,
    static_mapobjects,
)
from tmlibrary_tpu_torch.models.metadata import ChannelLayer
from tmlibrary_tpu_torch.ops import image_ops
from tmlibrary_tpu_torch.ops.pyramid import cut_tiles, pyramid_levels, to_uint8
from tmlibrary_tpu_torch.parallel import distributed
from tmlibrary_tpu_torch.parallel.halo import sharded_pyramid_levels
from tmlibrary_tpu_torch.parallel.mesh import spatial_mesh
from tmlibrary_tpu_torch.utils import create_partitions
from tmlibrary_tpu_torch.workflow.api import Step
from tmlibrary_tpu_torch.workflow.args import Argument, ArgumentCollection
from tmlibrary_tpu_torch.workflow.registry import register_step


@register_step("illuminati")
class PyramidBuilder(Step):
    collective = True
    batch_args = ArgumentCollection(
        Argument("correct", bool, default=True, help="apply illumination stats"),
        Argument("align", bool, default=False, help="apply cycle-0 alignment"),
        Argument("clip_percent", float, default=99.9,
                 help="upper clip percentile for display rescale"),
        Argument("batch_size", int, default=32, help="sites per device batch"),
        Argument("cycle", int, default=0, help="cycle to tile"),
        Argument("n_devices", int, default=1,
                 help="row-shard the mosaic pyramid over this many devices "
                      "(mosaics larger than one chip's HBM)"),
    )

    def create_batches(self, args):
        exp = self.store.experiment
        return [
            {"plate": p.name, "channel": ch.index}
            for p in exp.plates
            for ch in exp.channels
            if self.store.has_plane(cycle=args["cycle"], channel=ch.index)
        ]

    # ------------------------------------------------------------------ run
    def _mosaic(self, plate, channel: int, args, stats) -> torch.Tensor:
        """The plate's prepared sites stitched on the device."""
        exp = self.store.experiment
        dev = self.device
        prep = image_ops.make_batch_prep(
            None if stats is None else torch.from_numpy(stats.mean_log).to(dev),
            None if stats is None else torch.from_numpy(stats.std_log).to(dev),
            None, apply_shift=args["align"])
        _, _, spw_y, spw_x = plate_grid(exp, plate.name)
        h, w = exp.site_height, exp.site_width
        mosaic = torch.zeros(plate_mosaic_shape(exp, plate.name), dtype=torch.float32,
                             device=dev)
        refs = [(w_, s) for w_ in plate.wells for s in w_.sites]
        shifts_table = (
            self.store.read_shifts(args["cycle"])
            if args["align"] and self.store.has_shifts(args["cycle"])
            else np.zeros((self.store.n_sites, 2), np.int32)
        )
        for part in create_partitions(refs, args["batch_size"]):
            idx = [self.store.site_linear_index(SiteRef(plate.name, w_.row, w_.column, s.y, s.x))
                   for w_, s in part]
            stack = torch.from_numpy(
                self.store.read_sites(idx, cycle=args["cycle"], channel=channel)).to(dev)
            prepped = prep(stack, torch.from_numpy(shifts_table[idx]).to(dev))
            for (w_, s), img in zip(part, prepped):
                y0 = (w_.row * spw_y + s.y) * h
                x0 = (w_.column * spw_x + s.x) * w
                mosaic[y0:y0 + h, x0:x0 + w] = img
        return mosaic

    def run_batch(self, batch: dict) -> dict:
        args = batch["args"]
        exp = self.store.experiment
        mesh = spatial_mesh(max(1, min(int(args["n_devices"]), distributed.world_size())))
        if not mesh.member:
            return {"channel": batch["channel"]}
        channel, cycle = batch["channel"], args["cycle"]
        plate = next(p for p in exp.plates if p.name == batch["plate"])

        stats = None
        if args["correct"] and self.store.has_illumstats(cycle=cycle, channel=channel):
            stats = IllumstatsContainer.from_store(
                self.store.read_illumstats(cycle=cycle, channel=channel))
        # display range from corilla's percentiles (reference: scale step)
        if stats is not None and stats.percentiles:
            upper = stats.percentiles.get(args["clip_percent"])
            lower = stats.percentiles.get(0.1, 0.0)
        else:
            upper = lower = None

        mosaic = self._mosaic(plate, channel, args, stats)
        levels = sharded_pyramid_levels(mosaic, mesh) if mesh.size > 1 else pyramid_levels(mosaic)
        if not distributed.is_writer():
            return {"channel": channel, "n_levels": len(levels)}
        if upper is None:
            # one call takes both quantiles of the host mosaic, as the
            # reference does
            lo_up = np.percentile(mosaic.cpu().numpy(), [0.1, args["clip_percent"]])
            lower, upper = float(lo_up[0]), float(lo_up[1])

        out_dir = self.store.root / "pyramids" / f"channel{channel:02d}"
        # PNG encoding is host work and zlib releases the interpreter's
        # lock: a thread pool encodes a level's tiles concurrently, drained
        # before the next level is fetched (one uint8 level held at a time)
        n_tiles = 0
        with cf.ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
            for li, level in enumerate(levels):
                level8 = to_uint8(level, float(lower), float(upper)).cpu().numpy()
                ldir = out_dir / f"{len(levels) - 1 - li}"
                ldir.mkdir(parents=True, exist_ok=True)
                futures = [pool.submit(png.write, ldir / f"{ty}_{tx}.png", tile)
                           for (ty, tx), tile in cut_tiles(level8).items()]
                for fut in futures:
                    fut.result()
                n_tiles += len(futures)
        layer = ChannelLayer(
            channel=f"channel{channel:02d}",
            height=int(mosaic.shape[0]),
            width=int(mosaic.shape[1]),
            max_zoom=len(levels) - 1,
        )
        (out_dir / "layer.json").write_text(json.dumps(layer.to_dict()))
        return {
            "channel": channel,
            "mosaic_shape": list(mosaic.shape),
            "n_levels": len(levels),
            "n_tiles": n_tiles,
        }

    def collect(self) -> dict:
        """Register the static Plates/Wells/Sites mapobject types with their
        grid outlines (reference: the static ``MapobjectType`` rows created
        alongside the pyramid so the viewer can overlay plate geometry)."""
        registry = MapobjectTypeRegistry(self.store.root)
        out_dir = self.store.root / "segmentations"
        out_dir.mkdir(exist_ok=True)
        counts: dict[str, int] = {}
        for plate in self.store.experiment.plates:
            geo = static_mapobjects(self.store.experiment, plate.name)
            for type_name, outlines in geo.items():
                rects = [rect for _, rect in outlines]
                parquet.write_table(out_dir / f"{type_name}_polygons_{plate.name}.parquet", {
                    "plate": np.asarray([plate.name] * len(outlines), dtype=str),
                    "name": np.asarray([label for label, _ in outlines], dtype=str),
                    "centroid_y": np.asarray([float(r[:-1, 0].mean()) for r in rects]),
                    "centroid_x": np.asarray([float(r[:-1, 1].mean()) for r in rects]),
                    "contour_y": parquet.list_column([r[:, 0].tolist() for r in rects]),
                    "contour_x": parquet.list_column([r[:, 1].tolist() for r in rects]),
                })
                counts[type_name] = counts.get(type_name, 0) + len(outlines)
        for type_name in counts:
            registry.register(
                MapobjectType(
                    name=type_name,
                    ref_type=STATIC_REF_TYPES[type_name],
                    min_poly_zoom=0,
                )
            )
        return {"static_mapobjects": counts}

    def delete_previous_output(self) -> None:
        root = self.store.root / "pyramids"
        if root.exists():
            shutil.rmtree(root)
        root.mkdir()
