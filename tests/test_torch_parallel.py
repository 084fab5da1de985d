"""The port's parallel layer (``tmlibrary_tpu_torch/parallel/``) on gloo
ranks against the JAX package's on a CPU mesh of the same shape.

Two and four ranks are spawned once each (``torch.multiprocessing``,
``file://`` init under a temporary directory); every rank runs every
case below on the same numpy-seeded inputs and writes its results, and
the tests hold them (every rank's the same) against the reference's
function on ``tests/conftest.py``'s 8-device CPU mesh cut to the same
shape: row meshes of 2 and 4, and a 2x2 grid.  A rank imports only the
port; each checks that neither ``jax`` nor ``tmlibrary_tpu`` came in.

- Halo smoothing: bit-exact against the port's single-device blur,
  reflected at the mosaic's edges, and within 1e-6 relative (an ulp or
  two: XLA-CPU contracts the reference's multiply-adds into FMAs) of the
  reference's single-device blur and (at sigma 1.5) its sharded one,
  seams and borders included; a block with fewer rows than the halo
  raises.
- Downsample and pyramid levels (and the odd-rows fallback): bit-exact.
- Distributed CC, rows and grid: random masks at connectivity 4 and 8
  (bit-exact against the reference's and ``scipy.ndimage.label``), a bar
  across every shard, a serpentine component and single-row shards
  (against scipy, the reference's own golden), the root-table overflow
  and indivisible-rows errors.
- Distributed watershed, rows and grid: bit-exact; the smooth-Otsu-CC
  chain end to end; the same chain on blocks (Otsu's cut from summed
  histograms, over valid pixels too) gathered on rank 0 alone.
- ``sharded_welford`` within ``STATS_TIERS`` (``n`` and the histogram
  exact), ``sites_to_rows``/``rows_to_sites`` round trips, and each
  rank's slice of a batch gathered back whole.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch
import torch.multiprocessing as mp

from chip_smoke import STATS_TIERS

torch.set_num_threads(1)

SIGMAS = (1.5, 3.0)


def _inputs() -> dict:
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:64, 0:48]
    ws = rng.normal(100, 10, (64, 48)).astype(np.float32)
    for cy, cx in ((8, 10), (30, 30), (52, 12), (36, 36), (31, 24)):
        ws += 2000 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 30.0)
    blobs = rng.normal(200, 15, (64, 64)).astype(np.float32)
    y2, x2 = np.mgrid[0:64, 0:64]
    for cy, cx in ((10, 12), (30, 40), (52, 20), (33, 33), (31, 31)):
        blobs += 3000 * np.exp(-((y2 - cy) ** 2 + (x2 - cx) ** 2) / 18.0)
    bar = np.zeros((64, 32), bool)
    bar[:, 10] = True
    bar[5, 20] = True
    serpentine = np.zeros((64, 40), bool)
    for i, x in enumerate(range(2, 38, 4)):
        serpentine[:, x] = True
        if x + 4 < 40:
            serpentine[63 if i % 2 == 0 else 0, x:x + 4] = True
    single = np.zeros((4, 16), bool)
    single[:, 5] = True
    single[1, 9:12] = True
    dots = np.zeros((64, 64), bool)
    dots[::2, ::2] = True
    seeds, _ = ndi.label(ws > 1500)
    valid = np.ones((64, 64), bool)  # no valid pixel in the first row band
    valid[:20] = False
    valid[40:, 50:] = False
    return {
        "valid": valid,
        "img": (rng.random((64, 48)) * 1000).astype(np.float32),
        "masks": {c: rng.random((64, 48)) > 0.62 for c in (4, 8)},
        "bar": bar, "serpentine": serpentine, "single": single, "dots": dots,
        "ws": ws, "seeds": seeds.astype(np.int32), "ws_mask": ws > 300, "blobs": blobs,
        "stack": rng.integers(0, 4000, (10, 16, 16)).astype(np.uint16),
        "batch": rng.random((8, 8, 4)).astype(np.float32),
        "mosaic": rng.normal(500, 100, (1024, 768)).astype(np.float32),
        "odd": rng.normal(500, 100, (300, 260)).astype(np.float32),
    }


def _error(fn) -> str:
    try:
        fn()
    except Exception as e:  # the class name is what the tests hold
        return type(e).__name__
    return "none"


def _cases(world: int) -> dict:
    """Every case on this rank; numpy results keyed by case."""
    from tmlibrary_tpu_torch.parallel import distributed, halo, label, reshard, stats
    from tmlibrary_tpu_torch.parallel.mesh import shard_batch, site_mesh, spatial_mesh

    inp = _inputs()
    t = torch.from_numpy
    out = {}
    layouts = {"rows": spatial_mesh(world)}
    if world == 4:
        layouts["grid"] = spatial_mesh(2, 2)
    for key, mesh in layouts.items():
        grid = key == "grid"
        smooth = halo.sharded_gaussian_smooth_2d if grid else halo.sharded_gaussian_smooth
        cc = label.distributed_connected_components_2d if grid else \
            label.distributed_connected_components
        flood = label.distributed_watershed_from_seeds_2d if grid else \
            label.distributed_watershed_from_seeds
        segment = label.sharded_segment_mosaic_2d if grid else label.sharded_segment_mosaic
        for sigma in SIGMAS:
            out[key, "smooth", sigma] = smooth(t(inp["img"]), mesh, sigma).numpy()
        for conn in (4, 8):
            lab, n = cc(t(inp["masks"][conn]), mesh, connectivity=conn)
            out[key, "cc", conn] = (lab.numpy(), int(n))
        for name in ("bar", "serpentine", "single"):
            lab, n = cc(t(inp[name]), mesh)
            out[key, "cc", name] = (lab.numpy(), int(n))
        out[key, "overflow"] = _error(lambda: cc(t(inp["dots"]), mesh, max_roots_per_shard=64))
        out[key, "indivisible"] = _error(lambda: cc(torch.zeros(63, 8, dtype=torch.bool), mesh))
        out[key, "watershed"] = flood(t(inp["ws"]), t(inp["seeds"]), t(inp["ws_mask"]), mesh,
                                      n_levels=8).numpy()
        lab, n = segment(t(inp["blobs"]), mesh, sigma=1.5)
        out[key, "segment"] = (lab.numpy(), int(n))

        def block(a):
            return t(np.ascontiguousarray(mesh.block(a)))

        img, valid = block(inp["blobs"]), block(inp["valid"])
        out[key, "otsu"] = [float(label.sharded_otsu_value(img, mesh, v)) for v in (None, valid)]
        lab, n = label.segment_mosaic_block(img, mesh, 64, 64, sigma=1.5, valid=valid)
        sec = label.watershed_block(img, lab, block(inp["blobs"] > 400), mesh, n_levels=8)
        full = [halo.gather_blocks(x, mesh, 64, 64, dst=0) for x in (lab, sec)]
        out[key, "chain"] = (None if full[0] is None else [x.numpy() for x in full], int(n))
    mesh = site_mesh(world)
    out["short_halo"] = _error(lambda: halo.sharded_gaussian_smooth(
        torch.zeros(2 * world, 16), mesh, 3.0))
    out["downsample"] = halo.sharded_downsample_2x(t(inp["mosaic"]), mesh).numpy()
    out["pyramid"] = [x.numpy() for x in halo.sharded_pyramid_levels(t(inp["mosaic"]), mesh)]
    out["pyramid_odd"] = [x.numpy() for x in halo.sharded_pyramid_levels(t(inp["odd"]), mesh)]
    out["welford"] = {k: v.numpy() for k, v in
                      stats.sharded_welford(t(inp["stack"]), mesh)._asdict().items()}
    mine = shard_batch(t(inp["batch"]), mesh)
    rows = reshard.sites_to_rows(mine, mesh)
    out["rows"] = rows.numpy()
    out["round_trip"] = bool(torch.equal(reshard.rows_to_sites(rows, mesh), mine))
    local = distributed.global_to_host_local(t(inp["batch"]))
    out["host_local"] = (local.shape[0], bool(torch.equal(
        distributed.host_local_to_global(local), t(inp["batch"]))))
    return out


def _worker(rank: int, world: int, init: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    from tmlibrary_tpu_torch.parallel import distributed

    distributed.initialize(f"file://{init}", world, rank, device="cpu")
    try:
        res = _cases(world)
        res["jax_free"] = not any(m == "jax" or m.startswith(("jax.", "tmlibrary_tpu."))
                                  or m == "tmlibrary_tpu" for m in sys.modules)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        distributed.shutdown()


def spawn(world: int, tmp) -> list[dict]:
    """Run :func:`_worker` on ``world`` gloo ranks; each rank's results."""
    mp.spawn(_worker, args=(world, str(tmp / "init"), str(tmp)), nprocs=world)
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    return request.param, spawn(request.param, tmp_path_factory.mktemp(f"w{request.param}"))


def layouts(world):
    return ["rows", "grid"] if world == 4 else ["rows"]


def j_mesh(devices, key, world):
    from jax.sharding import Mesh

    if key == "grid":
        return Mesh(np.asarray(devices[:4]).reshape(2, 2), ("rows", "cols"))
    return Mesh(np.asarray(devices[:world]), ("rows",))


def golden(mask, connectivity=8):
    return ndi.label(mask, ndi.generate_binary_structure(2, 1 if connectivity == 4 else 2))


def assert_same_on_every_rank(results, key):
    first = results[0][key]
    for r, res in enumerate(results[1:], 1):
        got = res[key]
        if isinstance(first, tuple):
            np.testing.assert_array_equal(got[0], first[0], err_msg=f"{key} rank {r}")
            assert got[1] == first[1]
        elif isinstance(first, list):
            for a, b in zip(got, first):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(got, first, err_msg=f"{key} rank {r}")


# ------------------------------------------------------------------- tests
def test_ranks_import_no_jax(ranks):
    _, results = ranks
    assert all(r["jax_free"] for r in results)


def test_halo_smoothing_is_exact(ranks, devices):
    import jax.numpy as jnp

    from tmlibrary_tpu.ops.smooth import gaussian_smooth as j_smooth
    from tmlibrary_tpu.parallel.halo import sharded_gaussian_smooth, sharded_gaussian_smooth_2d
    from tmlibrary_tpu_torch.ops.smooth import gaussian_smooth

    world, results = ranks
    img = _inputs()["img"]
    for key in layouts(world):
        for sigma in SIGMAS:
            assert_same_on_every_rank(results, (key, "smooth", sigma))
            got = results[0][key, "smooth", sigma]
            np.testing.assert_array_equal(got, gaussian_smooth(torch.from_numpy(img), sigma))
            np.testing.assert_allclose(got, np.asarray(j_smooth(jnp.asarray(img), sigma)),
                                       rtol=1e-6, atol=0)
            if sigma != SIGMAS[0]:
                continue  # one jitted reference program a layout is enough
            fn = sharded_gaussian_smooth_2d if key == "grid" else sharded_gaussian_smooth
            want = np.asarray(fn(jnp.asarray(img), j_mesh(devices, key, world), sigma))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
            # the reflected border rows and the seams
            bh = 64 // (2 if key == "grid" else world)
            seams = [0, 1, bh - 1, bh, bh + 1, 62, 63]
            np.testing.assert_allclose(got[seams], want[seams], rtol=1e-6, atol=0)
    assert {r["short_halo"] for r in results} == {"ShardingError"}


def test_downsample_and_pyramid_levels_are_exact(ranks, devices):
    import jax.numpy as jnp

    from tmlibrary_tpu.ops.pyramid import downsample_2x, pyramid_levels
    from tmlibrary_tpu.parallel.halo import sharded_pyramid_levels

    world, results = ranks
    inp = _inputs()
    for key in ("downsample", "pyramid", "pyramid_odd"):
        assert_same_on_every_rank(results, key)
    np.testing.assert_array_equal(results[0]["downsample"],
                                  np.asarray(downsample_2x(jnp.asarray(inp["mosaic"]))))
    mesh = j_mesh(devices, "rows", world)
    for key, src, n in (("pyramid", "mosaic", 3), ("pyramid_odd", "odd", None)):
        want = sharded_pyramid_levels(jnp.asarray(inp[src]), mesh)
        plain = pyramid_levels(jnp.asarray(inp[src]))
        got = results[0][key]
        assert len(got) == len(want) == len(plain) and (n is None or len(got) == n)
        for g, w, p in zip(got, want, plain):
            np.testing.assert_array_equal(g, np.asarray(w))
            np.testing.assert_array_equal(g, np.asarray(p))


@pytest.mark.parametrize("case", [4, 8, "bar", "serpentine", "single"])
def test_distributed_cc_matches_the_reference_and_scipy(ranks, devices, case):
    from tmlibrary_tpu.parallel.label import (
        distributed_connected_components,
        distributed_connected_components_2d,
    )

    world, results = ranks
    inp = _inputs()
    mask = inp["masks"][case] if case in (4, 8) else inp[case]
    conn = case if case in (4, 8) else 8
    gold, n = golden(mask, conn)
    for key in layouts(world):
        assert_same_on_every_rank(results, (key, "cc", case))
        lab, count = results[0][key, "cc", case]
        assert count == n
        np.testing.assert_array_equal(lab, gold)
        if case not in (4, 8):
            continue  # scipy is the reference's own golden for the shapes
        fn = distributed_connected_components_2d if key == "grid" else \
            distributed_connected_components
        j_lab, j_count = fn(mask, j_mesh(devices, key, world), connectivity=conn)
        assert int(j_count) == count
        np.testing.assert_array_equal(lab, np.asarray(j_lab))
    if case in ("bar", "serpentine", "single"):
        assert n == {"bar": 2, "serpentine": 1, "single": 2}[case]


def test_distributed_cc_errors_match_the_reference(ranks, devices):
    """The root-table overflow and indivisible rows raise
    ``ShardingError`` on every rank, as the reference's do
    (``tests/test_distributed_label.py``, held here on the rows mesh)."""
    from tmlibrary_tpu.errors import ShardingError as JShardingError
    from tmlibrary_tpu.parallel.label import distributed_connected_components

    world, results = ranks
    for key in layouts(world):
        assert {r[key, "overflow"] for r in results} == {"ShardingError"}
        assert {r[key, "indivisible"] for r in results} == {"ShardingError"}
    with pytest.raises(JShardingError):
        distributed_connected_components(np.zeros((63, 8), bool),
                                         j_mesh(devices, "rows", world))


def test_distributed_watershed_matches_the_reference(ranks, devices):
    import jax.numpy as jnp

    from tmlibrary_tpu.ops.segment_secondary import watershed_from_seeds
    from tmlibrary_tpu.parallel.label import (
        distributed_watershed_from_seeds,
        distributed_watershed_from_seeds_2d,
    )

    world, results = ranks
    inp = _inputs()
    single = np.asarray(watershed_from_seeds(
        jnp.asarray(inp["ws"]), jnp.asarray(inp["seeds"]), jnp.asarray(inp["ws_mask"]),
        n_levels=8, method="xla"))
    assert single.max() > 0
    for key in layouts(world):
        assert_same_on_every_rank(results, (key, "watershed"))
        fn = distributed_watershed_from_seeds_2d if key == "grid" else \
            distributed_watershed_from_seeds
        want = np.asarray(fn(inp["ws"], inp["seeds"], inp["ws_mask"],
                             j_mesh(devices, key, world), n_levels=8))
        np.testing.assert_array_equal(results[0][key, "watershed"], want)
        np.testing.assert_array_equal(results[0][key, "watershed"], single)


def test_sharded_segment_mosaic_matches_the_reference(ranks, devices):
    from tmlibrary_tpu.parallel.label import sharded_segment_mosaic, sharded_segment_mosaic_2d

    world, results = ranks
    blobs = _inputs()["blobs"]
    for key in layouts(world):
        assert_same_on_every_rank(results, (key, "segment"))
        lab, n = results[0][key, "segment"]
        fn = sharded_segment_mosaic_2d if key == "grid" else sharded_segment_mosaic
        j_lab, j_n = fn(blobs, j_mesh(devices, key, world), sigma=1.5)
        assert n == int(j_n) > 0
        np.testing.assert_array_equal(lab, np.asarray(j_lab))


def test_block_chain_stays_sharded_and_gathers_on_rank_0(ranks):
    """The spatial step's chain on blocks (``sharded_otsu_value``, over
    the valid pixels too, with a block that holds none;
    ``segment_mosaic_block``, ``watershed_block``) equals the
    single-device ops on the whole mosaic, and ``gather_blocks(dst=0)``
    assembles it on rank 0 alone.  The Otsu cuts equal the reference's."""
    import jax.numpy as jnp

    from tmlibrary_tpu.ops.threshold import otsu_value as j_otsu
    from tmlibrary_tpu_torch.ops.label import connected_components
    from tmlibrary_tpu_torch.ops.segment_secondary import watershed_from_seeds
    from tmlibrary_tpu_torch.ops.smooth import gaussian_smooth
    from tmlibrary_tpu_torch.ops.threshold import otsu_value

    world, results = ranks
    inp = _inputs()
    blobs, valid = torch.from_numpy(inp["blobs"]), torch.from_numpy(inp["valid"])
    cuts = [float(otsu_value(blobs[None])[0]), float(otsu_value(blobs[valid][None])[0])]
    assert cuts == [float(j_otsu(jnp.asarray(inp["blobs"]))),
                    float(j_otsu(jnp.asarray(inp["blobs"][inp["valid"]])))]
    sm = gaussian_smooth(blobs, 1.5)
    lab, n = connected_components((sm > otsu_value(sm[valid][None])[0])[None])
    sec = watershed_from_seeds(blobs[None], lab, (blobs > 400)[None], n_levels=8)
    for key in layouts(world):
        assert [r[key, "otsu"] for r in results] == [cuts] * world
        assert all(r[key, "chain"][0] is None for r in results[1:])
        got, count = results[0][key, "chain"]
        assert {r[key, "chain"][1] for r in results} == {count} and count == int(n[0]) > 0
        np.testing.assert_array_equal(got[0], lab[0].numpy())
        np.testing.assert_array_equal(got[1], sec[0].numpy())


def test_sharded_welford_and_resharding_match_the_reference(ranks, devices):
    import jax.numpy as jnp

    from tmlibrary_tpu.parallel.stats import sharded_welford

    world, results = ranks
    inp = _inputs()
    want = sharded_welford(jnp.asarray(inp["stack"]), j_mesh(devices, "rows", world),
                           axis="rows")._asdict()
    for r in results:
        got = r["welford"]
        for k in ("n", "hist"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        for k, (rtol, atol) in (("mean", STATS_TIERS["mean_log"]), ("m2", (1e-5, 1e-4)),
                                ("offset", STATS_TIERS["mean_log"])):
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=rtol, atol=atol,
                                       err_msg=k)
        assert r["round_trip"]
        assert r["host_local"] == (8 // world, True)
    rows = np.concatenate([r["rows"] for r in results], axis=1)
    np.testing.assert_array_equal(rows, inp["batch"])
