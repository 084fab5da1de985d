"""align: register acquisition cycles per site.

Counterpart: ``tmlibrary_tpu/workflow/steps/align.py`` (reference
``tmlib/workflow/align/`` ``ImageRegistrator``): per-site shifts of every
cycle against a reference cycle on one channel, through the port's
:func:`~tmlibrary_tpu_torch.ops.registration.batch_phase_correlation_quality`
and :func:`~tmlibrary_tpu_torch.ops.registration.filter_shifts` (a shift
beyond ``max_shift``, or a peak below ``min_quality``, is zeroed), an
``(n_sites, 2)`` shift table per cycle, and in ``collect`` the
intersection window of all cycles.
"""

from __future__ import annotations

import numpy as np
import torch

from tmlibrary_tpu_torch.ops.registration import (
    batch_phase_correlation_quality,
    filter_shifts,
    intersection_window,
)
from tmlibrary_tpu_torch.utils import create_partitions
from tmlibrary_tpu_torch.workflow.api import Step
from tmlibrary_tpu_torch.workflow.args import Argument, ArgumentCollection
from tmlibrary_tpu_torch.workflow.registry import register_step


@register_step("align")
class ImageRegistrator(Step):
    batch_args = ArgumentCollection(
        Argument("ref_cycle", int, default=0, help="reference cycle"),
        Argument("ref_channel", int, default=0, help="channel used to register"),
        Argument("batch_size", int, default=32, help="sites per device batch"),
        Argument("max_shift", int, default=50,
                 help="shifts larger than this are treated as failures (zeroed)"),
        Argument("min_quality", float, default=0.0,
                 help="zero shifts whose correlation peak falls below this "
                      "(0 = off); peak is 1.0 for identical shifted content"),
    )

    def create_batches(self, args):
        exp = self.store.experiment
        if exp.n_cycles < 2:
            return []
        sites = list(range(self.store.n_sites))
        return [
            {"cycle": cycle, "sites": part}
            for cycle in range(exp.n_cycles)
            if cycle != args["ref_cycle"]
            for part in create_partitions(sites, args["batch_size"])
        ]

    def _read(self, sites, cycle: int, channel: int) -> torch.Tensor:
        stack = self.store.read_sites(sites, cycle=cycle, channel=channel)
        return torch.from_numpy(stack).to(self.device).to(torch.float32)

    def run_batch(self, batch: dict) -> dict:
        args = batch["args"]
        cycle, sites = batch["cycle"], batch["sites"]
        ref = self._read(sites, args["ref_cycle"], args["ref_channel"])
        tgt = self._read(sites, cycle, args["ref_channel"])
        dev_shifts, dev_quality = batch_phase_correlation_quality(ref, tgt)
        kept, bad = filter_shifts(dev_shifts, dev_quality, max_shift=args["max_shift"],
                                  min_quality=args["min_quality"])
        # np.array (a copy): on the CPU .numpy() shares the tensor's memory
        shifts = np.array(kept.cpu().numpy(), dtype=np.int32)
        n_failed = int(bad.sum())

        # accumulate into the per-cycle shift table (idempotent slice write)
        table = (
            self.store.read_shifts(cycle)
            if self.store.has_shifts(cycle)
            else np.zeros((self.store.n_sites, 2), np.int32)
        )
        table[np.asarray(sites)] = shifts
        self.store.write_shifts(table, cycle)
        return {"cycle": cycle, "n_sites": len(sites), "n_failed": n_failed}

    def collect(self) -> dict:
        exp = self.store.experiment
        args = self.batch_args.resolve(
            self.load_batch(0)["args"] if self.list_batches() else None
        )
        all_shifts = [
            self.store.read_shifts(c)
            for c in range(exp.n_cycles)
            if c != args["ref_cycle"] and self.store.has_shifts(c)
        ]
        window = intersection_window(
            np.concatenate(all_shifts) if all_shifts else np.zeros((0, 2))
        )
        self.store.write_intersection(window)
        return {"window": window}

    def delete_previous_output(self) -> None:
        for p in (self.store.root / "alignment").glob("*"):
            p.unlink()
