"""The port's point-pattern features against the JAX package, on the CPU.

Parents are cells (touching objects) and nuclei; points are spots of 1-9
pixels, some on the background, some on a parent's border, one parent
with a single point, centroids that fall on half pixels (rounded half to
even), and more points than ``max_points``.  Batches of 3 sites whose
scenes differ, held site by site against the reference computed alone.
Tolerances: ``FEATURE_TIERS`` -- count and density exact; the per-parent
means at ``rtol`` 1e-6 (the port sums each parent's points in another
order); their std at the sumsq envelope.  The distances themselves
(nearest neighbour, centroid, border) are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import assert_feature
from tmlibrary_tpu.benchmarks import synthetic_cell_painting_batch
from tmlibrary_tpu.jterator import modules as ref_modules
from tmlibrary_tpu.ops import measure as jm
from tmlibrary_tpu_torch.jterator import modules as port_modules
from tmlibrary_tpu_torch.ops import measure as tm

torch.set_num_threads(1)


def spots(rng, n_sites, size, n, max_r=1):
    """``n`` square spots a site of side 1..2*max_r+1 at random places,
    numbered 1..n (later spots overwrite earlier ones)."""
    out = np.zeros((n_sites, size, size), np.int32)
    for s in range(n_sites):
        for k in range(n):
            y, x = rng.integers(0, size, 2)
            r = int(rng.integers(0, max_r + 1))
            out[s, max(y - r, 0) : y + r + 1, max(x - r, 0) : x + r + 1] = k + 1
    return out


@pytest.fixture(scope="module")
def scene():
    data = synthetic_cell_painting_batch(3, size=64, n_cells=7, seed=5)
    seg = port_modules.get_module("segment_primary")
    nuclei = seg(torch.from_numpy(data["DAPI"]), min_area=5, max_objects=32)["objects"]
    cells = port_modules.get_module("segment_secondary")(
        nuclei, torch.from_numpy(data["Actin"]), correction_factor=0.8,
        n_levels=16)["objects"].numpy()
    rng = np.random.default_rng(9)
    points = spots(rng, 3, 64, 40, max_r=1)
    points[1] = spots(rng, 1, 64, 90, max_r=0)[0]  # more points than max_points
    # a 2-px spot whose centroid sits on a half pixel (rounds half to even)
    points[2, 30, 30:32] = 41
    return cells, nuclei.numpy(), points


def ref_features(parents, points, m, p):
    outs = [jm.point_pattern_features(jnp.asarray(parents[i]), jnp.asarray(points[i]), m, p)
            for i in range(parents.shape[0])]
    return {k: np.stack([np.asarray(o[k]) for o in outs]) for k in outs[0]}


def hold(got, want, counts):
    assert sorted(got) == sorted(want) and len(want) == 9
    for name, arr in want.items():
        g = got[name].numpy()
        assert g.shape == arr.shape and g.dtype == np.float32
        for s, n in enumerate(counts):
            assert_feature(name, g[s, :n], arr[s, :n])
        # rows of absent parents are zero on both sides
        np.testing.assert_array_equal(g[:, counts.max():], 0.0)


@pytest.mark.parametrize("parents_kind", ["cells", "nuclei"])
@pytest.mark.parametrize("max_points", [64, 48])
def test_point_pattern_matches_jax(scene, parents_kind, max_points):
    cells, nuclei, points = scene
    parents = cells if parents_kind == "cells" else nuclei
    m = 32
    got = tm.point_pattern_features(torch.from_numpy(parents), torch.from_numpy(points), m,
                                    max_points)
    want = ref_features(parents, points, m, max_points)
    hold(got, want, parents.reshape(3, -1).max(axis=1))
    assert (got["PointPattern_count"].sum(dim=1) > 0).all()


def test_distances_are_exact(scene):
    """The per-point distances behind the means (nearest neighbour,
    centroid, border) equal the reference's: with one point a parent
    the mean is the distance itself."""
    cells, _, _ = scene
    points = np.zeros_like(cells)
    for s in range(3):  # one 1-px point in each of the first parents
        for k in range(1, int(cells[s].max()) + 1):
            ys, xs = np.nonzero(cells[s] == k)
            points[s, ys[len(ys) // 3], xs[len(xs) // 3]] = k
    got = tm.point_pattern_features(torch.from_numpy(cells), torch.from_numpy(points), 32, 32)
    want = ref_features(cells, points, 32, 32)
    for name in ("PointPattern_count", "PointPattern_centroid_dist_mean",
                 "PointPattern_border_dist_mean", "PointPattern_nn_dist_mean"):
        np.testing.assert_array_equal(got[name].numpy(), want[name], err_msg=name)


def test_single_point_and_points_outside_every_parent():
    """A parent with one point has no nearest neighbour (NN stats and the
    Clark-Evans index 0); points on the background belong to no parent;
    a site with no parent gives zero rows."""
    parents = np.zeros((3, 32, 32), np.int32)
    parents[0, 4:16, 4:16] = 1
    parents[0, 18:30, 4:30] = 2
    parents[1, 2:30, 2:30] = 1
    points = np.zeros((3, 32, 32), np.int32)
    points[0, 8, 8] = 1          # alone in parent 1
    points[0, 25, 25] = 2        # parent 2
    points[0, 20, 10] = 3        # parent 2
    points[0, 17, 31] = 4        # background
    points[1, 0, 0] = 1          # background of site 1
    points[2, 5:7, 5:7] = 1      # site 2 has no parent
    got = tm.point_pattern_features(torch.from_numpy(parents), torch.from_numpy(points), 3, 4)
    want = ref_features(parents, points, 3, 4)
    hold(got, want, parents.reshape(3, -1).max(axis=1))
    f = {k: v.numpy() for k, v in got.items()}
    assert f["PointPattern_count"][0].tolist() == [1.0, 2.0, 0.0]
    assert f["PointPattern_nn_dist_mean"][0, 0] == 0.0 and f["PointPattern_clark_evans"][0, 0] == 0.0
    assert f["PointPattern_count"][1:].sum() == 0
    assert f["PointPattern_centroid_dist_mean"][0, 0] > 0


def test_two_parents_by_hand():
    """The reference's hand-computed scene (tests/test_measure.py): NN
    distances 8 and 5, border distance 8, the Clark-Evans index from
    independent arithmetic."""
    parents = np.zeros((1, 48, 48), np.int32)
    parents[0, 2:22, 2:42] = 1
    parents[0, 26:46, 2:42] = 2
    points = np.zeros((1, 48, 48), np.int32)
    points[0, 10, 10], points[0, 10, 18], points[0, 10, 26] = 1, 2, 3
    points[0, 32, 10], points[0, 35, 14] = 4, 5
    f = {k: v.numpy()[0] for k, v in tm.point_pattern_features(
        torch.from_numpy(parents), torch.from_numpy(points), 4, 8).items()}
    assert f["PointPattern_count"][:2].tolist() == [3.0, 2.0]
    assert f["PointPattern_nn_dist_mean"][:2].tolist() == [8.0, 5.0]
    assert f["PointPattern_border_dist_mean"][0] == 8.0
    for k, (n, nn) in enumerate([(3.0, 8.0), (2.0, 5.0)]):
        assert np.isclose(f["PointPattern_clark_evans"][k], nn / (0.5 / np.sqrt(n / 800.0)),
                          rtol=1e-6)


@pytest.mark.parametrize("size", [64, 130])
def test_border_chunks_cover_the_site(size):
    """The border min runs over row chunks of ``BORDER_CHUNK`` pixels; a
    site of several chunks with its only inner boundary in the last
    one (and a width that does not divide the chunk) gives the same
    distance as the reference's."""
    parents = np.ones((1, size, size), np.int32)
    parents[0, size - 3, size // 2] = 0
    points = np.zeros((1, size, size), np.int32)
    points[0, size // 2, size // 2] = 1
    got = tm.point_pattern_features(torch.from_numpy(parents), torch.from_numpy(points), 2, 2)
    want = ref_features(parents, points, 2, 2)
    np.testing.assert_array_equal(got["PointPattern_border_dist_mean"].numpy(),
                                  want["PointPattern_border_dist_mean"])


def test_measure_point_pattern_module(scene):
    cells, _, points = scene
    out = port_modules.get_module("measure_point_pattern")(
        torch.from_numpy(cells), torch.from_numpy(points), max_objects=32, max_points=64)
    ref = ref_modules.get_module("measure_point_pattern")
    for s in range(3):
        want = ref(jnp.asarray(cells[s]), jnp.asarray(points[s]), max_objects=32,
                   max_points=64)["measurements"]
        n = int(cells[s].max())
        for name, arr in want.items():
            assert_feature(name, out["measurements"][name][s, :n].numpy(), np.asarray(arr)[:n])
