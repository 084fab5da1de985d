"""The port's illuminati step against the JAX package's.

Both packages run the step over copies of one store: a plate of 2x2
wells at 3x3 sites of 64x64 (a 384x384 mosaic, two levels, five tiles a
channel), DAPI and Actin.  Without corilla's statistics (``correct`` on,
no statistics, so the display range comes from the host mosaic's
percentiles) and with the align step's shifts, every tile decoded by cv2
is equal pixel for pixel, and so is ``layer.json``.  With corilla's
statistics each package corrects with its own (their percentiles are
equal, but the steps' lookup of ``clip_percent`` misses corilla's
float32 keys in both, so the display range is the corrected mosaic's,
ROADMAP C): the port corrects in float64, the reference in float32
(ROADMAP C), so a pixel whose corrected value sits within an ulp of a
display step may land one step apart; the tiles are then equal to the
reference's chain run on the port's corrected mosaic, pixel for pixel,
and within one display step of the reference's own.
``pd.read_parquet`` of each static mapobject shard gives the reference's
frame, list cells compared elementwise, and both registries agree.
"""

import json
import shutil
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from chip_smoke import CORRECTION_TIER
from tmlibrary_tpu.models.experiment import grid_experiment as j_grid
from tmlibrary_tpu.models.image import IllumstatsContainer as JStats
from tmlibrary_tpu.models.store import ExperimentStore as JStore
from tmlibrary_tpu.ops import image_ops as j_img
from tmlibrary_tpu.ops import pyramid as j_pyr
from tmlibrary_tpu.workflow.registry import get_step as j_get_step
from tmlibrary_tpu_torch import benchmarks
from tmlibrary_tpu_torch.models.experiment import grid_experiment
from tmlibrary_tpu_torch.models.mapobject import MapobjectTypeRegistry
from tmlibrary_tpu_torch.models.store import ExperimentStore
from tmlibrary_tpu_torch.workflow import get_step

torch.set_num_threads(1)

GEOMETRY = dict(well_rows=2, well_cols=2, sites_per_well=(3, 3),
                channel_names=("DAPI", "Actin"), site_shape=(64, 64))


def make_stores(base, corilla: bool, shifts: bool):
    """Two stores of the same pixels; corilla run in each package on its
    own when asked; the same shift table in both when asked."""
    port = ExperimentStore.create(base / "port", grid_experiment("ill", **GEOMETRY))
    ref = JStore.create(base / "ref", j_grid("ill", **GEOMETRY))
    n = port.n_sites
    data = benchmarks.synthetic_cell_painting_batch(n, size=64, seed=3)
    for c, ch in enumerate(GEOMETRY["channel_names"]):
        px = np.clip(data[ch], 0, 65535).astype(np.uint16)
        port.write_sites(px, list(range(n)), channel=c)
        ref.write_sites(px, list(range(n)), channel=c)
    if shifts:
        table = np.random.default_rng(5).integers(-6, 7, (n, 2)).astype(np.int32)
        port.write_shifts(table, 0)
        ref.write_shifts(table, 0)
    if corilla:
        run_step(get_step("corilla")(port, device="cpu"), {"chunk_size": 16})
        run_step(j_get_step("corilla")(ref), {"chunk_size": 16})
    return ref, port


def run_step(step, args):
    step.init(args)
    results = [step.run(i) for i in step.list_batches()]
    return results, step.collect()


def tiles(root):
    return {p.relative_to(root): cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
            for p in sorted((root / "pyramids").rglob("*.png"))}


def assert_same_layers(ref_root, port_root):
    layers = sorted(p.relative_to(ref_root) for p in (ref_root / "pyramids").rglob("layer.json"))
    assert len(layers) == 2
    for rel in layers:
        assert json.loads((port_root / rel).read_text()) == json.loads((ref_root / rel).read_text())


def assert_same_shards(ref_root, port_root):
    shards = sorted(p.name for p in (ref_root / "segmentations").glob("*_polygons_*.parquet"))
    assert shards == sorted(p.name for p in (port_root / "segmentations").glob("*.parquet"))
    assert len(shards) == 3
    for name in shards:
        want = pd.read_parquet(ref_root / "segmentations" / name)
        got = pd.read_parquet(port_root / "segmentations" / name)
        assert list(got.columns) == list(want.columns)
        assert list(got.dtypes) == list(want.dtypes)
        for col in want.columns:
            if col.startswith("contour_"):
                for g, w in zip(got[col], want[col]):
                    assert g.dtype == w.dtype
                    np.testing.assert_array_equal(g, w)
            else:
                assert got[col].tolist() == want[col].tolist(), (name, col)
    assert json.loads((port_root / MapobjectTypeRegistry.FILENAME).read_text()) == \
        json.loads((ref_root / MapobjectTypeRegistry.FILENAME).read_text())


@pytest.mark.parametrize("case", ["no_statistics", "aligned"])
def test_tiles_equal_the_references(tmp_path, case):
    ref, port = make_stores(tmp_path, corilla=False, shifts=case == "aligned")
    args = {"batch_size": 7, "align": case == "aligned"}
    want, want_collect = run_step(j_get_step("illuminati")(ref), args)
    got, got_collect = run_step(get_step("illuminati")(port, device="cpu"), args)
    assert got == want and got_collect == want_collect
    assert [r["n_tiles"] for r in got] == [5, 5] and got[0]["mosaic_shape"] == [384, 384]
    t_ref, t_port = tiles(ref.root), tiles(port.root)
    assert sorted(t_port) == sorted(t_ref) and len(t_ref) == 10
    for rel, img in t_ref.items():
        assert t_port[rel].dtype == np.uint8 and t_port[rel].shape == (256, 256)
        np.testing.assert_array_equal(t_port[rel], img, err_msg=str(rel))
    assert_same_layers(ref.root, port.root)
    assert_same_shards(ref.root, port.root)


def test_tiles_with_corilla_statistics(tmp_path):
    ref, port = make_stores(tmp_path, corilla=True, shifts=False)
    for ch in range(2):
        np.testing.assert_array_equal(port.read_illumstats(0, ch)["percentile_values"],
                                      ref.read_illumstats(0, ch)["percentile_values"])
    want, _ = run_step(j_get_step("illuminati")(ref), {})
    got, _ = run_step(get_step("illuminati")(port, device="cpu"), {})
    assert got == want
    t_ref, t_port = tiles(ref.root), tiles(port.root)
    assert sorted(t_port) == sorted(t_ref) and len(t_ref) == 10
    assert_same_layers(ref.root, port.root)
    differ = 0
    for ch in range(2):
        # the reference's chain on the port's corrected mosaic: every tile
        stats = port.read_illumstats(0, ch)
        # corilla's keys are float32 (99.9000015258789), so both steps'
        # lookup of 99.9 misses and the display range is the host mosaic's
        assert 99.9 not in JStats.from_store(stats).percentiles
        mosaic = port_mosaic(port, ch, stats)
        lower, upper = np.percentile(mosaic, [0.1, 99.9])
        levels = j_pyr.pyramid_levels(jnp.asarray(mosaic))
        for li, level in enumerate(levels):
            level8 = np.asarray(j_pyr.to_uint8(level, float(lower), float(upper)))
            for (ty, tx), tile in j_pyr.cut_tiles(level8).items():
                rel = Path(f"pyramids/channel{ch:02d}/{len(levels) - 1 - li}/{ty}_{tx}.png")
                np.testing.assert_array_equal(t_port[rel], tile, err_msg=str(rel))
                step = np.abs(t_port[rel].astype(int) - t_ref[rel])
                assert step.max() <= 1, rel
                differ += int((step > 0).sum())
    # the float64 correction moves few pixels across a display step
    print(f"corrected tiles: {differ} of {10 * 256 * 256} pixels one display step from the "
          "reference's")
    assert differ <= 10 * 256 * 256 // 1000, differ


def port_mosaic(store, channel, stats):
    """The plate mosaic the port's step stitches (its float64 correction),
    as a host array."""
    from tmlibrary_tpu_torch.ops import image_ops

    prep = image_ops.make_batch_prep(torch.from_numpy(stats["mean_log"]),
                                     torch.from_numpy(stats["std_log"]), None, apply_shift=False)
    stack = torch.from_numpy(np.array(store.read_sites(None, channel=channel)))
    sites = prep(stack, torch.zeros((len(stack), 2), dtype=torch.int32)).numpy()
    exp = store.experiment
    mosaic = np.zeros((384, 384), np.float32)
    for i, ref in enumerate(exp.sites()):
        y0 = (ref.well_row * 3 + ref.site_y) * 64
        x0 = (ref.well_column * 3 + ref.site_x) * 64
        mosaic[y0:y0 + 64, x0:x0 + 64] = sites[i]
    # the same sites through the reference's float32 correction stay
    # within the correction tier of them
    j_stats = JStats.from_store(stats)
    want = np.asarray(j_img.make_batch_prep(j_stats)(jnp.asarray(stack.numpy()),
                                                     jnp.zeros((len(stack), 2), jnp.int32)))
    np.testing.assert_allclose(sites, want, rtol=CORRECTION_TIER[0], atol=CORRECTION_TIER[1])
    return mosaic


def test_refusals_and_reruns(tmp_path):
    _, port = make_stores(tmp_path, corilla=False, shifts=False)
    step = get_step("illuminati")(port, device="cpu")
    # n_devices > 1 used to be refused; it clamps to the process group
    # (one rank here) and writes the tiles of n_devices=1
    run_step(step, {"correct": False, "n_devices": 2})
    sharded = tiles(port.root)
    run_step(step, {"correct": False})
    first = tiles(port.root)
    assert sorted(sharded) == sorted(first)
    for rel in first:
        np.testing.assert_array_equal(sharded[rel], first[rel])
    (port.root / "pyramids" / "stale.png").write_bytes(b"x")
    run_step(step, {"correct": False})  # a re-run replaces the previous tiles
    again = tiles(port.root)
    assert sorted(again) == sorted(first)
    for rel in first:
        np.testing.assert_array_equal(again[rel], first[rel])
    shutil.rmtree(port.root / "pyramids")
