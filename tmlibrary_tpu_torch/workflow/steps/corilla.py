"""corilla: online illumination statistics per channel.

Counterpart: ``tmlibrary_tpu/workflow/steps/corilla.py`` (reference
``tmlib/workflow/corilla/api.py`` ``IlluminationStatisticsCalculator``):
one batch per (cycle, channel), folding every site of the channel through
the Welford scan and writing the statistics with
``ExperimentStore.write_illumstats``.

Sites are read in chunks of ``chunk_size`` through
:func:`~tmlibrary_tpu_torch.workflow.pipelined.prefetch_iter` (the store
read of chunk N+1 runs while the device scans chunk N), scanned with
:func:`~tmlibrary_tpu_torch.ops.stats.welford_scan` and merged with
:func:`~tmlibrary_tpu_torch.ops.stats.welford_merge` in chunk order, the
reference's order (``:105-146``).  With ``n_devices > 1`` on a process
group (clamped to it, 0: all of it), the largest prefix of sites that
divides the mesh is scanned sharded, each rank reading only its own
contiguous slice, and the ranks' states are merged in rank order
(:func:`~tmlibrary_tpu_torch.parallel.stats.merge_shard_states`); the
rest follows in chunks, merged last, the reference's order
(``:85-100``).  Only rank 0 writes.  Each channel's exact
percentiles are folded into the QC session
(:meth:`~tmlibrary_tpu_torch.qc.QCSession.observe_illumination`, one
no-op call when QC is off), as the reference does (``:148-158``).
"""

from __future__ import annotations

import torch

from tmlibrary_tpu_torch import qc as qc_mod
from tmlibrary_tpu_torch.ops.smooth import gaussian_smooth
from tmlibrary_tpu_torch.ops.stats import (
    welford_finalize,
    welford_init,
    welford_merge,
    welford_scan,
)
from tmlibrary_tpu_torch.parallel import distributed
from tmlibrary_tpu_torch.parallel.mesh import site_mesh
from tmlibrary_tpu_torch.parallel.stats import merge_shard_states
from tmlibrary_tpu_torch.utils import create_partitions
from tmlibrary_tpu_torch.workflow.api import Step
from tmlibrary_tpu_torch.workflow.args import Argument, ArgumentCollection
from tmlibrary_tpu_torch.workflow.pipelined import prefetch_iter
from tmlibrary_tpu_torch.workflow.registry import register_step


@register_step("corilla")
class IlluminationStatisticsCalculator(Step):
    collective = True
    batch_args = ArgumentCollection(
        Argument("chunk_size", int, default=32,
                 help="sites per device-resident chunk"),
        Argument("n_devices", int, default=0,
                 help="mesh size (0 = all visible devices)"),
        Argument("smooth_sigma", float, default=0.0,
                 help="pre-smooth stat fields before storing (0 = off)"),
        Argument("prefetch_chunks", int, default=2,
                 help="site chunks read ahead on worker threads while the "
                      "device scans the current chunk (1 = sequential)"),
    )

    def create_batches(self, args):
        # one batch per (cycle, channel), exactly the reference's job split
        exp = self.store.experiment
        return [
            {"cycle": cycle, "channel": ch.index}
            for cycle in range(exp.n_cycles)
            for ch in exp.channels
            if self.store.has_plane(cycle=cycle, channel=ch.index)
        ]

    def run_batch(self, batch: dict) -> dict:
        args = batch["args"]
        cycle, channel = batch["cycle"], batch["channel"]
        exp = self.store.experiment
        n_sites = self.store.n_sites
        site_indices = list(range(n_sites))
        state = None
        mesh = site_mesh(distributed.clamp_devices(args["n_devices"]))
        if mesh.size > 1:
            if not mesh.member:
                return {"cycle": cycle, "channel": channel, "n_sites": n_sites}
            even = n_sites - n_sites % mesh.size
            if even:
                mine = site_indices[distributed.local_site_slice(even, mesh.rank, mesh.size)]
                local = welford_scan(torch.from_numpy(
                    self.store.read_sites(mine, cycle=cycle, channel=channel)).to(self.device))
                state = merge_shard_states(local, mesh)
                site_indices = site_indices[even:]
            if not distributed.is_writer():
                return {"cycle": cycle, "channel": channel, "n_sites": n_sites}
        chunks = create_partitions(site_indices, max(args["chunk_size"], 1))
        loaded = prefetch_iter(
            chunks,
            lambda part: self.store.read_sites(part, cycle=cycle, channel=channel),
            depth=max(args.get("prefetch_chunks", 2), 1),
        )
        tail = None
        for stack in loaded:
            part = welford_scan(torch.from_numpy(stack).to(self.device))
            tail = part if tail is None else welford_merge(tail, part)
        if tail is not None:
            state = tail if state is None else welford_merge(state, tail)
        if state is None:
            state = welford_init((exp.site_height, exp.site_width), self.device)
        out = welford_finalize(state)
        if args["smooth_sigma"] > 0:
            out["mean_log"] = gaussian_smooth(out["mean_log"], args["smooth_sigma"])
            out["std_log"] = gaussian_smooth(out["std_log"], args["smooth_sigma"])
        out.pop("hist", None)
        # sorted keys: the reference's file lists its fields in that order
        host = {k: out[k].cpu().numpy() for k in sorted(out)}
        ch_name = next((c.name for c in exp.channels if c.index == channel), str(channel))
        qc_mod.get_session().observe_illumination(
            ch_name, host["percentile_keys"], host["percentile_values"])
        self.store.write_illumstats(host, cycle=cycle, channel=channel)
        return {"cycle": cycle, "channel": channel, "n_sites": int(host["n"])}

    def delete_previous_output(self) -> None:
        for p in (self.store.root / "illumstats").glob("*.npz"):
            p.unlink()
