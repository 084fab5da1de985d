"""Hold the parallel layer on the process group it is launched in.

    torchrun --standalone --nproc-per-node N -m tmlibrary_tpu_torch.parallel.check \\
        [--device cuda|cpu] [--grid 8] [--size 256]

Every rank makes the same well (``benchmarks.synthetic_mosaic_well``,
``grid x grid`` sites of ``size``; its side must divide by the ranks),
and the ranks run, on a row mesh of all ranks and on the squarest
``rows x cols`` grid of them:
the halo-exchanged Gaussian, the distributed CC of the smoothed Otsu
mask and the distributed watershed from its labels, each gathered on
every rank, and the same chain as the spatial step runs it, on blocks
that stay on their ranks and gathered on rank 0 alone; then the sharded
pyramid levels, the sharded Welford of the site stack and an all-to-all
round trip of it; then the jterator step's spatial layout through the
workflow engine at ``n_devices=N`` over a store under ``build/``, which
rank 0 alone writes and removes at the end.  Rank 0 holds each result against
the single-device op on the whole image, on its own device: exact, but
the Welford fields within ``STATS_TIERS`` (another merge order).  Rank 0
prints one line per check with its seconds (host clock, each call ended
by a synchronise), the spatial step's stage times from its ledger and,
last, a JSON summary; any mismatch exits 1 on every rank.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

from tmlibrary_tpu_torch import benchmarks
from tmlibrary_tpu_torch.ops import label as label_ops
from tmlibrary_tpu_torch.ops.pyramid import pyramid_levels
from tmlibrary_tpu_torch.ops.segment_secondary import watershed_from_seeds
from tmlibrary_tpu_torch.ops.smooth import gaussian_smooth
from tmlibrary_tpu_torch.ops.stats import welford_scan
from tmlibrary_tpu_torch.ops.threshold import otsu_value, threshold_otsu
from tmlibrary_tpu_torch.parallel import distributed, halo, label, reshard, stats
from tmlibrary_tpu_torch.parallel.mesh import shard_batch, site_mesh, spatial_mesh

#: the Welford fields' (rtol, atol) against one rank's scan, as
#: ``chip_smoke.STATS_TIERS`` holds them (the merge order differs)
WELFORD_TIERS = {"mean": (0.0, 2e-6), "m2": (1e-5, 1e-4)}


def _timed(dev, fn):
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _spatial_step(dev, tiles, grid, size, world) -> dict:
    """The jterator step's spatial layout through the engine on every rank;
    rank 0's store's labels of the one well, as a mosaic."""
    import os

    from tmlibrary_tpu_torch.models.experiment import grid_experiment
    from tmlibrary_tpu_torch.models.store import ExperimentStore
    from tmlibrary_tpu_torch.workflow.engine import Workflow, WorkflowDescription

    base = Path(__file__).resolve().parents[2] / "build" / f"parallel_check.{os.getpid()}"
    box = [str(base) if distributed.is_writer() else None]
    if world > 1:
        torch.distributed.broadcast_object_list(box, src=0)
    root = os.path.join(box[0], "store")
    if distributed.is_writer():
        exp = grid_experiment("check", well_rows=1, well_cols=1, sites_per_well=(grid, grid),
                              channel_names=("DAPI",), site_shape=(size, size))
        ExperimentStore.create(root, exp).write_sites(tiles, list(range(len(tiles))))
    distributed.sync_hosts("store written")
    store = ExperimentStore.open(root)
    desc = WorkflowDescription.canonical({"jterator": {
        "layout": "spatial", "spatial_secondary_channel": "DAPI", "n_devices": world,
        "spatial_zernike_degree": 0}})
    for stage in desc.stages:
        for sd in stage.steps:
            sd.active = sd.name == "jterator"
    summary, seconds = _timed(dev, lambda: Workflow(store, desc, device=dev).run())
    out = {"seconds": seconds}
    if distributed.is_writer():
        out["summary"] = summary
        events = [json.loads(line) for line in
                  (Path(root) / "workflow" / "ledger.jsonl").read_text().splitlines()]
        out["stages"] = next(e["result"]["stages"] for e in events
                             if e.get("event") == "batch_done")
        for fam in ("mosaic_cells", "mosaic_secondary"):
            stack = store.read_labels(None, fam)
            out[fam] = (stack.reshape(grid, grid, size, size).transpose(0, 2, 1, 3)
                        .reshape(grid * size, grid * size))
    distributed.sync_hosts("spatial step read")
    if distributed.is_writer():
        shutil.rmtree(box[0], ignore_errors=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--grid", type=int, default=8)
    parser.add_argument("--size", type=int, default=256)
    args = parser.parse_args(argv)
    distributed.initialize(device=args.device)
    world, rank = distributed.world_size(), distributed.rank()
    dev = torch.device(args.device) if args.device == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())
    failures: list[str] = []
    lines: dict = {"world": world, "device": args.device}
    if dev.type == "cuda":
        lines["card"] = torch.cuda.get_device_name(dev)

    def hold(name: str, ok: bool, seconds: float) -> None:
        if rank == 0:
            print(f"  {name}: {'exact' if ok else 'DIFFERS'}, {seconds:.4f} s on {world} ranks",
                  flush=True)
            lines[name] = seconds
        if not ok:
            failures.append(name)

    mosaic, tiles = benchmarks.synthetic_mosaic_well(args.grid, args.grid, args.size)
    img = torch.from_numpy(mosaic.astype(np.float32)).to(dev)
    hm, wm = img.shape
    sm = gaussian_smooth(img, 1.5)
    mask = sm > otsu_value(sm[None])[0]
    want, count = label_ops.connected_components(mask[None])
    sec_mask = threshold_otsu(img[None])[0]
    flood = watershed_from_seeds(img[None], want, sec_mask[None])[0]
    # the squarest tile grid of all ranks (2x2 on four, 1x2 on two)
    nc = next(k for k in range(1, world + 1) if world % k == 0 and k * k >= world)
    nr = world // nc
    for key, mesh in (("rows", spatial_mesh(world)), ("grid", spatial_mesh(nr, nc))):
        got, s = _timed(dev, lambda: halo.sharded_gaussian_smooth(img, mesh, 1.5))
        hold(f"{key}{mesh.grid} smooth", torch.equal(got, sm), s)
        (lab, n), s = _timed(dev, lambda: label.sharded_segment_mosaic(img, mesh))
        hold(f"{key}{mesh.grid} segment", torch.equal(lab, want[0]) and int(n) == int(count[0]),
             s)
        got, s = _timed(dev, lambda: label.distributed_watershed_from_seeds(
            img, want[0], sec_mask, mesh))
        hold(f"{key}{mesh.grid} watershed", torch.equal(got, flood), s)

        def chain(mesh=mesh):
            # the spatial step's chain: blocks stay on their ranks, and the
            # two label images are gathered on rank 0 alone
            img_b, sec_b = (mesh.block(t).contiguous() for t in (img, sec_mask))
            lab_b, n_b = label.segment_mosaic_block(img_b, mesh, hm, wm)
            flood_b = label.watershed_block(img_b, lab_b, sec_b, mesh)
            return [halo.gather_blocks(b, mesh, hm, wm, dst=0) for b in (lab_b, flood_b)], n_b

        (full, n), s = _timed(dev, chain)
        ok = int(n) == int(count[0])
        if rank == 0:
            ok = ok and torch.equal(full[0], want[0]) and torch.equal(full[1], flood)
        hold(f"{key}{mesh.grid} block chain", ok, s)

    mesh = site_mesh(world)
    levels, s = _timed(dev, lambda: halo.sharded_pyramid_levels(img, mesh))
    hold("pyramid levels", all(torch.equal(a, b) for a, b in
                               zip(levels, pyramid_levels(img))), s)
    stack = torch.from_numpy(tiles).to(dev)
    state, s = _timed(dev, lambda: stats.sharded_welford(stack, mesh))
    one = welford_scan(stack)
    ok = torch.equal(state.n, one.n) and torch.equal(state.hist, one.hist) and all(
        torch.allclose(getattr(state, f), getattr(one, f), rtol=r, atol=a)
        for f, (r, a) in WELFORD_TIERS.items())
    hold("welford", ok, s)
    pad = -stack.shape[0] % world
    batch = torch.cat([stack, stack[:pad]]).to(torch.int32) if pad else stack.to(torch.int32)
    mine = shard_batch(batch, mesh)
    rows = reshard.sites_to_rows(mine, mesh) if batch.shape[1] % world == 0 else None
    ok = rows is None or torch.equal(reshard.rows_to_sites(rows, mesh), mine)
    hold("sites_to_rows round trip", ok, 0.0)

    out = _spatial_step(dev, tiles, args.grid, args.size, world)
    if rank == 0:
        ok = (np.array_equal(out["mosaic_cells"], want[0].cpu().numpy())
              and np.array_equal(out["mosaic_secondary"], flood.cpu().numpy()))
        hold("jterator spatial step", ok, out["seconds"])
        print("  spatial step stages (s): " + ", ".join(
            f"{k} {v:.4f}" for k, v in out["stages"].items()), flush=True)
        lines["spatial_stages"] = out["stages"]
        lines["objects"] = int(count[0])
        lines["mpix"] = hm * wm / 1e6
        print(json.dumps(lines))
    bad = distributed.any_rank(bool(failures), dev)
    distributed.shutdown()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
