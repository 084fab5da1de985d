"""The port's median and bilateral smoothing against the JAX package, on
the CPU, alone and through the ``smooth`` module.

Tolerances: the median is exact (a median of an odd count is one of the
window's values; a window holding NaN gives NaN on both sides); the
bilateral within ``chip_smoke.BILATERAL_TIER`` of the site's largest
|image| (the port evaluates its weights and sums in float64 and rounds
once, the reference in float32 with its own ``exp``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import BILATERAL_TIER
from tmlibrary_tpu.benchmarks import synthetic_cell_painting_batch
from tmlibrary_tpu.jterator import modules as ref_modules
from tmlibrary_tpu.ops import smooth as j_smooth
from tmlibrary_tpu_torch.jterator import modules as port_modules
from tmlibrary_tpu_torch.ops import smooth as t_smooth

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sites():
    """3 sites of 64x56 whose intensity ranges differ."""
    dapi = synthetic_cell_painting_batch(3, size=64, n_cells=6, seed=3)["DAPI"][:, :, :56]
    return np.ascontiguousarray(dapi * np.array([1.0, 0.25, 4.0], np.float32)[:, None, None])


def ref_stack(fn, imgs):
    return np.stack([np.asarray(fn(jnp.asarray(x))) for x in imgs])


@pytest.mark.parametrize("size", [1, 3, 5, 9])
def test_median_matches_jax(sites, size):
    got = t_smooth.median_smooth(torch.from_numpy(sites), size).numpy()
    want = ref_stack(lambda x: j_smooth.median_smooth(x, size), sites)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [2, 4])
def test_median_even_size_raises(sites, size):
    with pytest.raises(ValueError, match="odd"):
        t_smooth.median_smooth(torch.from_numpy(sites), size)
    with pytest.raises(ValueError, match="odd"):
        j_smooth.median_smooth(jnp.asarray(sites[0]), size)


def test_median_of_a_window_with_nan_is_nan(sites):
    """``torch.median`` along a dimension returns NaN for a window that
    holds one, as ``jnp.median`` does: the same pixels are NaN."""
    img = sites.copy()
    img[0, 10, 10] = np.nan
    img[2, 0, 55] = np.nan  # a corner: the symmetric pad repeats it
    got = t_smooth.median_smooth(torch.from_numpy(img), 3).numpy()
    want = ref_stack(lambda x: j_smooth.median_smooth(x, 3), img)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0, 9:12, 9:12]).all() and np.isnan(got[2, 0:2, 54:56]).all()
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


def test_median_on_integer_steps_and_ties():
    """Plateaus and repeated values: the middle element is still exact."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 4, (2, 20, 17)).astype(np.float32)
    got = t_smooth.median_smooth(torch.from_numpy(img), 5).numpy()
    np.testing.assert_array_equal(got, ref_stack(lambda x: j_smooth.median_smooth(x, 5), img))


@pytest.mark.parametrize("size,sigma_space,sigma_range", [
    (5, 2.0, 50.0), (3, 1.0, 50.0), (7, 3.0, 200.0), (5, 2.0, 5.0)])
def test_bilateral_within_tier(sites, size, sigma_space, sigma_range):
    got = t_smooth.bilateral_smooth(torch.from_numpy(sites), size, sigma_space,
                                    sigma_range).numpy()
    want = ref_stack(lambda x: j_smooth.bilateral_smooth(x, size, sigma_space, sigma_range),
                     sites)
    scale = np.abs(sites).reshape(3, -1).max(axis=1)[:, None, None]
    assert (np.abs(got - want) <= BILATERAL_TIER * scale).all(), \
        float((np.abs(got - want) / scale).max())


def test_bilateral_preserves_a_step_and_a_flat_site():
    """A flat site stays flat; a step far above ``sigma_range`` keeps its
    edge (the range weight of the far side underflows)."""
    img = np.full((2, 16, 16), 500.0, np.float32)
    img[1, :, 8:] = 5000.0
    got = t_smooth.bilateral_smooth(torch.from_numpy(img), 5, 2.0).numpy()
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("method,kwargs", [
    ("median", {"size": 3}), ("median", {"size": 7}),
    ("bilateral", {"size": 5, "sigma": 2.0}), ("bilateral", {"size": 3, "sigma": 1.0})])
def test_smooth_module_methods_match_jax(sites, method, kwargs):
    ref = ref_modules.get_module("smooth")
    want = ref_stack(lambda x: ref(x, method=method, **kwargs)["smoothed_image"], sites)
    got = port_modules.get_module("smooth")(
        torch.from_numpy(sites), method=method, **kwargs)["smoothed_image"].numpy()
    if method == "median":
        np.testing.assert_array_equal(got, want)
    else:
        scale = np.abs(sites).reshape(3, -1).max(axis=1)[:, None, None]
        assert (np.abs(got - want) <= BILATERAL_TIER * scale).all()


def test_smooth_unknown_method_raises(sites):
    with pytest.raises(ValueError, match="unknown smooth method"):
        port_modules.get_module("smooth")(torch.from_numpy(sites), method="mode")
