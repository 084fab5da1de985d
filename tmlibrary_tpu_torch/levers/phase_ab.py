"""Phases 3-5 of ``chip_smoke.py`` from two checkouts in turns: the A/B
of a change against its parent on paths it may not touch.

Each run is a fresh process that imports the ``chip_smoke.py`` and the
package of one tree, builds its kernels from that tree's sources (the
kernel-library store off) and drives, as ``chip_smoke.py`` does on the
card: config 3 and its declumping form (phase 3, ``pipeline:`` lines),
corilla (phase 4, ``corilla:`` lines) and the steps over phase 5's
store (``jterator step`` lines: cold, warm and buckets off).  Runs go in
the order given, so a drift of the card within the call shows as a
drift between runs of one tree.

Run on a card from the root of a checkout, with the parent unpacked
under a directory ``.gitignore`` lists::

    git archive <parent> | tar -x -C build/parent_tree
    python3 -m tmlibrary_tpu_torch.levers.phase_ab P=build/parent_tree C=. P C C P
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

CHILD = r"""
import os, sys, time
tree, tag = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree)
os.chdir(tree)
os.environ["TMX_AOT_STORE"] = "0"
import torch
import chip_smoke as cs
from tmlibrary_tpu_torch import benchmarks, native, shootout
from tmlibrary_tpu_torch.jterator import pipeline
from tmlibrary_tpu_torch.ops import _cuda, fused_measure, kernels, stats, volume
t0 = time.perf_counter()
_cuda.lib(); native.lib()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
card = cs.card_line()
print(f"[{tag}] tree {tree}, built in {time.perf_counter() - t0:.1f} s; {card}", flush=True)
wrappers = {n: getattr(m, n) for m, names in (
    (kernels, ("fill_holes_flood", "cc_min_propagate", "watershed_flood", "distance_transform")),
    (fused_measure, ("grouped_stats", "intensity_hist", "glcm_all")),
    (volume, ("cc3d_min_propagate", "watershed3d_flood"))) for n in names}
on_chip = {"fill_holes_flood": "onchip", "watershed_flood": "onchip"}
data = shootout.main_path_inputs(torch.device("cuda"), cs.B, cs.SIZE, cs.MAX_OBJECTS, cs.SEED)["data"]
cs.drive_path(torch, pipeline, "config 3", benchmarks.cell_painting_description(), data, wrappers,
              need=["fill_holes_flood", "cc_min_propagate", "watershed_flood", "grouped_stats"],
              card=card, expect={"fill_holes_flood": 1, "watershed_flood": 1,
                                 "cc_min_propagate": 1}, only=on_chip)
cs.drive_path(torch, pipeline, "declump", benchmarks.cell_painting_declump_description(), data,
              wrappers, need=[], card=card,
              expect={"fill_holes_flood": 1, "cc_min_propagate": 1, "distance_transform": 1,
                      "watershed_flood": 2, "grouped_stats": 2}, only=on_chip)
cs.phase_corilla(torch, stats, benchmarks, shootout.hbm_rate(torch.cuda.get_device_name(0)), card)
cs.phase_steps(torch, wrappers, card, on_chip, 0.0)
print(f"[{tag}] done in {time.perf_counter() - t0:.1f} s", flush=True)
"""

#: the lines of a run that carry its numbers
KEEP = ("[", "  pipeline:", "  corilla: 8", "  jterator step (", "    executor at depth")


def main(argv: list[str]) -> int:
    trees = dict(a.split("=", 1) for a in argv if "=" in a)
    order = [a for a in argv if "=" not in a]
    if not trees or not order or any(tag not in trees for tag in order):
        print(__doc__, file=sys.stderr)
        return 2
    failed = 0
    for i, tag in enumerate(order):
        tree = str(Path(trees[tag]).resolve())
        done = subprocess.run([sys.executable, "-c", CHILD, tree, f"{tag}{i}"],
                              capture_output=True, text=True)
        failed += done.returncode != 0
        print(f"{tag}{i} rc={done.returncode}")
        for line in done.stdout.splitlines():
            if line.startswith(KEEP):
                print(line, flush=True)
        if done.returncode:
            print(done.stderr[-2000:], file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
