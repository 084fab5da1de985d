"""The port's repairs against the reference, on the CPU.

- NaN: the plain versions of ``watershed_flood``, ``watershed3d_flood``
  and ``grouped_stats`` propagate a NaN intensity as the JAX package does
  (Pallas in interpret mode, the XLA twin, the scatter reductions): in
  the floods a NaN in ``mask | seeds > 0`` makes every level NaN, so only
  the mop-up admits a pixel; in ``grouped_stats`` it makes its own
  object's min, max and sum NaN and no other row.  The card kernels are
  held to these plain versions by ``chip_smoke.py``.
- Size: the planner that lets the card take any ``max_objects`` for
  ``grouped_stats``, and the plain versions of it and of
  ``distance_transform`` at those sizes against the reference.
- Rounding: ``_exact.sqrt``, the correctly rounded float32 root the
  exact-tier features take on both devices (PyTorch's vectorised CPU
  root is an ulp off on some inputs).
"""

import numpy as np
import pytest
import torch

from test_torch_floods import NEVER, ws_bands, ws_levels, ws_onchip_model, ws_site
from tmlibrary_tpu.ops import pallas_kernels as jpk
from tmlibrary_tpu.ops.measure import grouped_minmax as j_minmax
from tmlibrary_tpu.ops.measure import grouped_sums as j_sums
from tmlibrary_tpu.ops.segment_primary import distance_transform_approx as j_dist
from tmlibrary_tpu.ops.segment_secondary import watershed_from_seeds as j_ws
from tmlibrary_tpu_torch.errors import DeviceError
from tmlibrary_tpu_torch.ops import fused_measure as fm
from tmlibrary_tpu_torch.ops import kernels as tk
from tmlibrary_tpu_torch.ops import volume as tv

torch.set_num_threads(1)

NAN_CASES = ["pixel", "seed", "outside", "all"]


def _with_nan(img, seeds, mask, case):
    """``img`` with NaN placed by ``case``: one free pixel of the mask, a
    seed pixel, only pixels outside ``mask | seeds > 0``, or the whole
    mask."""
    img = img.copy()
    mp = mask | (seeds > 0)
    if case == "pixel":
        free = np.argwhere(mask & (seeds == 0))
        img[tuple(free[len(free) // 2])] = np.nan
    elif case == "seed":
        img[tuple(np.argwhere(seeds > 0)[0])] = np.nan
    elif case == "outside":
        img[~mp] = np.nan
    else:
        img[mp] = np.nan
    return img


@pytest.mark.parametrize("case", NAN_CASES)
@pytest.mark.parametrize("connectivity", [4, 8])
def test_watershed_flood_plain_propagates_nan_as_the_reference(case, connectivity):
    """The plain 2-D watershed equals the Pallas kernel (interpret mode)
    and the XLA twin on NaN intensities, and so does the numpy model of
    the on-chip design; with a NaN in the mask every free pixel's band is
    the mop-up's."""
    rng = np.random.default_rng(5)
    img, seeds, mask = ws_site("blobs", rng)
    img = _with_nan(img, seeds, mask, case)
    n_levels = 16
    want = tk.watershed_flood_plain(*(torch.from_numpy(a[None]) for a in (img, seeds, mask)),
                                    n_levels, connectivity).numpy()[0]
    pallas = np.asarray(jpk.watershed_flood(img, seeds, mask, n_levels=n_levels,
                                            connectivity=connectivity, interpret=True))
    np.testing.assert_array_equal(want, pallas)
    xla = np.asarray(j_ws(img, seeds, mask, n_levels=n_levels, connectivity=connectivity,
                          method="xla"))
    np.testing.assert_array_equal(want, xla)
    got, _ = ws_onchip_model(img, seeds, mask, n_levels, connectivity,
                             tk.watershed_plan(img.shape, n_levels).cap, rng)
    np.testing.assert_array_equal(got, want)
    levels = ws_levels(img, seeds, mask, n_levels)
    band = ws_bands(img, seeds, mask, levels)
    free = (seeds == 0) & mask
    if case != "outside":
        assert np.isnan(levels).all()
        assert (band[free] == n_levels).all() and (band[~free] == NEVER).all()
    else:
        assert not np.isnan(levels).any()


@pytest.mark.parametrize("case", NAN_CASES)
def test_watershed3d_flood_plain_propagates_nan_as_the_reference(case):
    """The plain 3-D watershed equals the Pallas kernel (interpret mode,
    ``chunk=1``) on NaN intensities of an 8x32x32 volume."""
    rng = np.random.default_rng(7)
    img = rng.random((8, 32, 32), dtype=np.float32)
    mask = img > 0.3
    seeds = np.zeros(img.shape, np.int32)
    seeds[2, 5, 5], seeds[5, 20, 24], seeds[6, 28, 3] = 1, 2, 3
    img = _with_nan(img, seeds, mask, case)
    want = tv.watershed3d_flood_plain(*(torch.from_numpy(a[None]) for a in (img, seeds, mask)),
                                      8).numpy()[0]
    pallas = np.asarray(jpk.watershed3d_flood(img, seeds, mask, n_levels=8, interpret=True,
                                              chunk=1))
    np.testing.assert_array_equal(want, pallas)
    assert (want[seeds > 0] == seeds[seeds > 0]).all()


def _objects(rng, shape, n):
    lab = np.zeros(shape, np.int32)
    for k in range(1, n + 1):
        y, x = rng.integers(0, shape[0] - 12), rng.integers(0, shape[1] - 12)
        h, w = rng.integers(3, 12, size=2)
        lab[y : y + h, x : x + w] = k
    return lab


@pytest.mark.parametrize("where", ["one_object", "background", "every_object"])
def test_grouped_stats_plain_propagates_nan_as_the_scatter_reference(where):
    """NaN pixels make their own object's sum, min and max NaN and leave
    every other row as it was, as the reference's scatter sums and
    min/max do."""
    rng = np.random.default_rng(3)
    lab = _objects(rng, (72, 80), 9)
    v1 = (rng.random(lab.shape, dtype=np.float32) * 4000 + 200).astype(np.float32)
    v2 = (v1 * v1).astype(np.float32)
    if where == "one_object":
        v1[np.argwhere(lab == 3)[0][0], np.argwhere(lab == 3)[0][1]] = np.nan
    elif where == "background":
        v1[lab == 0] = np.nan
    else:
        for k in range(1, 10):
            y, x = np.argwhere(lab == k)[-1]
            v1[y, x] = np.nan
    sums, mins, maxs = (t.numpy()[0] for t in fm.grouped_stats_plain(
        torch.from_numpy(lab[None]), [torch.from_numpy(v1[None]), torch.from_numpy(v2[None])],
        16))
    ref_sums = np.asarray(j_sums(lab, [v1, v2], 16, method="scatter"))
    np.testing.assert_array_equal(sums, ref_sums)
    for c, v in enumerate((v1, v2)):
        mn, mx = (np.asarray(a) for a in j_minmax(lab, v, 16, method="scatter"))
        np.testing.assert_array_equal(mins[:, c], mn)
        np.testing.assert_array_equal(maxs[:, c], mx)
    nan_rows = np.isnan(mins[:, 0])
    assert nan_rows.sum() == {"one_object": 1, "background": 0, "every_object": 9}[where]
    assert not np.isnan(mins[:, 1]).any()


def test_grouped_stats_plain_at_4096_objects_matches_the_scatter_reference():
    """A 96x96 site with 4200 two-pixel objects at ``max_objects=4096``
    (ids above it dropped), where the card once refused more than 3072."""
    rng = np.random.default_rng(9)
    lab = (np.arange(96 * 96, dtype=np.int32) // 2 + 1).reshape(96, 96)
    lab[lab > 4200] = 0
    img = (rng.random(lab.shape, dtype=np.float32) * 4000).astype(np.float32)
    sums, mins, maxs = (t.numpy()[0] for t in fm.grouped_stats_plain(
        torch.from_numpy(lab[None]), [torch.from_numpy(img[None])], 4096))
    np.testing.assert_array_equal(sums, np.asarray(j_sums(lab, [img], 4096, method="scatter")))
    mn, mx = (np.asarray(a) for a in j_minmax(lab, img, 4096, method="scatter"))
    np.testing.assert_array_equal(mins[:, 0], mn)
    np.testing.assert_array_equal(maxs[:, 0], mx)
    assert sums.shape == (4096, 1) and (sums[:, 0] > 0).sum() == 4096


@pytest.mark.parametrize("phases", [tk.DT_COLUMNS, tk.DT_ROW_PASS, tk.DT_PHASES])
def test_distance_launcher_raises_off_the_card(phases):
    with pytest.raises(DeviceError):
        tk.distance_transform_launcher(torch.zeros((1, 16, 16), dtype=torch.bool), 64,
                                       phases=phases)


def test_distance_transform_plain_on_a_site_past_shared_memory():
    """At 483x483 (past one block's shared memory as a byte plane) the
    plain version equals the reference's XLA fixpoint."""
    rng = np.random.default_rng(4)
    m = np.zeros((483, 483), bool)
    for _ in range(40):
        y, x = rng.integers(0, 460, size=2)
        m[y : y + rng.integers(5, 40), x : x + rng.integers(5, 40)] = True
    got = tk.distance_transform(torch.from_numpy(m[None])).numpy()[0]
    np.testing.assert_array_equal(got, np.asarray(j_dist(m)))


@pytest.mark.parametrize("shape, bands", [((64, 256, 256), 9),  # ceil(528 / 64)
                                          ((16, 2048, 128), 33), ((16, 16, 128, 128), 33),
                                          ((1, 32, 32), 1),  # 2048 pixels a band at least
                                          ((1, 2, 32, 64), 2), ((600, 512, 512), 1)])
def test_stats_plan_routes(shape, bands):
    """One box route for any ``max_objects``; the bands follow the shape,
    a volume's as its ``(B, Z*H, W)`` view's."""
    assert fm.stats_plan(shape) == fm.StatsPlan(bands)
    if len(shape) == 4:
        assert fm.stats_plan((shape[0], shape[1] * shape[2], shape[3])) == fm.StatsPlan(bands)


def test_grouped_stats_launcher_checks():
    lab = torch.zeros((1, 8, 8), dtype=torch.int32)
    img = torch.zeros((1, 8, 8))
    with pytest.raises(DeviceError):
        fm.grouped_stats_launcher(lab, [img], 4)
    with pytest.raises(ValueError):
        fm.grouped_stats_launcher(lab, [img] * 33, 4)
    with pytest.raises(ValueError):
        fm.grouped_stats(lab, [img.reshape(1, 2, 4, 8)], 4)  # channel shape differs
    with pytest.raises(ValueError):
        fm.grouped_stats(lab[None, None], [img[None, None]], 4)  # 5-D


@pytest.mark.parametrize("n_levels, route", [(1, "cluster"), (254, "cluster"),
                                             (255, "global"), (1000, "global")])
def test_watershed3d_plan_routes(n_levels, route):
    assert tv.watershed3d_plan(n_levels) == tk.FloodPlan(route)


@pytest.mark.parametrize("plan", [tk.FloodPlan("cluster"), tk.FloodPlan("global")])
def test_watershed3d_launcher_raises_off_the_card(plan):
    vol = torch.zeros((1, 2, 4, 4))
    with pytest.raises(DeviceError):
        tv.watershed3d_flood_launcher(vol, vol.int(), vol.bool(), 8, plan)


def test_exact_sqrt_is_the_correctly_rounded_float32_root():
    """``_exact.sqrt`` (the exact-tier features' root) equals numpy's IEEE
    float32 root on a million random values of the features' range, on
    subnormal, tiny, huge and special values -- where PyTorch's own CPU
    root may be an ulp off."""
    from tmlibrary_tpu_torch.ops._exact import sqrt

    rng = np.random.default_rng(0)
    x = np.concatenate([rng.random(1_000_000, dtype=np.float32) * 5000,
                        rng.random(1000, dtype=np.float32) * np.float32(1e-40),
                        np.array([0.0, -0.0, 1e-45, 1e-38, 3.4e38, np.inf, -1.0, np.nan],
                                 np.float32)])
    got = sqrt(torch.from_numpy(x))
    assert got.dtype == torch.float32
    with np.errstate(invalid="ignore"):
        np.testing.assert_array_equal(got.numpy(), np.sqrt(x))
