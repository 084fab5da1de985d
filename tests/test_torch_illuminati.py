"""illuminati's pyramid, the stitching prep and the align step's
registration in the port, against the JAX package.

The pyramid is float-exact (the 2x2 sums in XLA-CPU's order), its uint8
levels and tiles exact; shifts are exact on rolled content, the peak's
height and the subpixel peak within ``REGISTRATION_TIERS``, the
correction within ``CORRECTION_TIER`` (``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import CORRECTION_TIER, REGISTRATION_TIERS
from tmlibrary_tpu import benchmarks as j_bench
from tmlibrary_tpu.models.image import IllumstatsContainer
from tmlibrary_tpu.ops import image_ops as j_img
from tmlibrary_tpu.ops import pyramid as j_pyr
from tmlibrary_tpu.ops import registration as j_reg
from tmlibrary_tpu_torch import benchmarks
from tmlibrary_tpu_torch.ops import image_ops, pyramid, registration

torch.set_num_threads(1)


def _img(shape, seed=0, scale=5000.0):
    return (np.random.default_rng(seed).random(shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ pyramid
@pytest.mark.parametrize("shape", [
    (64, 66), (65, 67), (64, 64), (96, 128), (33, 2), (7, 1), (1, 1), (2, 2), (5, 9),
    (130, 96), (512, 512), (257, 255),
])
def test_downsample_2x_float_exact(shape):
    img = _img(shape, seed=sum(shape))
    want = np.asarray(j_pyr.downsample_2x_jit(jnp.asarray(img)))
    got = pyramid.downsample_2x(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(j_pyr.downsample_2x(jnp.asarray(img))))


def test_downsample_2x_batched_equals_per_image():
    imgs = _img((3, 37, 64), seed=4)
    got = pyramid.downsample_2x(torch.from_numpy(imgs)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], pyramid.downsample_2x(torch.from_numpy(imgs[i])))


@pytest.mark.parametrize("shape", [(600, 530), (512, 512), (257, 1024), (256, 256), (100, 40)])
def test_pyramid_levels_and_uint8_exact(shape):
    img = _img(shape, seed=1)
    want = j_pyr.pyramid_levels(jnp.asarray(img))
    got = pyramid.pyramid_levels(torch.from_numpy(img))
    assert len(got) == len(want) == pyramid.n_pyramid_levels(*shape)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(pyramid.to_uint8(g, 12.5, 4800.3).numpy(),
                                      np.asarray(j_pyr.to_uint8(w, 12.5, 4800.3)))
    fixed = pyramid.pyramid_levels(torch.from_numpy(img), n_levels=2)
    assert len(fixed) == 2


@pytest.mark.parametrize("size", [(1, 1), (256, 256), (257, 256), (2048, 2048), (3000, 700),
                                  (513, 4100)])
def test_n_pyramid_levels(size):
    assert pyramid.n_pyramid_levels(*size) == j_pyr.n_pyramid_levels(*size)


@pytest.mark.parametrize("bounds", [(0.0, 255.0), (12.5, 4800.3), (300.0, 300.0),
                                    (1000.0, 900.0), (-5.0, 1e5)])
def test_to_uint8_exact(bounds):
    img = _img((40, 50), seed=2) - 100.0
    np.testing.assert_array_equal(pyramid.to_uint8(torch.from_numpy(img), *bounds).numpy(),
                                  np.asarray(j_pyr.to_uint8(jnp.asarray(img), *bounds)))


@pytest.mark.parametrize("shape", [(256, 256), (300, 530), (10, 700), (0, 5)])
def test_cut_tiles(shape):
    level = np.random.default_rng(3).integers(0, 255, shape).astype(np.uint8)
    got = pyramid.cut_tiles(torch.from_numpy(level))
    want = j_pyr.cut_tiles(level)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_join_grid_exact():
    tiles = _img((6, 5, 7), seed=5)
    got = image_ops.join_grid(torch.from_numpy(tiles), 2, 3).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_img.join_grid(jnp.asarray(tiles), 2, 3)))
    with pytest.raises(ValueError):
        image_ops.join_grid(torch.from_numpy(tiles), 2, 2)


def _stats(size, seed=6):
    rng = np.random.default_rng(seed)
    mean_log = (2.5 + 0.3 * rng.random((size, size))).astype(np.float32)
    std_log = (0.1 + 0.2 * rng.random((size, size))).astype(np.float32)
    std_log[0, :4] = 0.0  # the guarded near-zero branch
    return mean_log, std_log


@pytest.mark.parametrize("stats_seed", [6, 9])
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("window", [(0, 0, 0, 0), (3, 1, 0, 2)])
def test_make_batch_prep(stats_seed, shift, window):
    """The port's prep (correction, shift, crop) against the reference's
    with all three on: within the correction's tier, and the shift and
    crop exact against the reference's applied to the port's correction."""
    stack = np.random.default_rng(7).integers(0, 4000, (4, 32, 32)).astype(np.float32)
    shifts = np.array([[0, 0], [3, -2], [-4, 5], [1, 1]], np.int32) * shift
    mean_log, std_log = _stats(32, stats_seed)
    j_stats = IllumstatsContainer(jnp.asarray(mean_log), jnp.asarray(std_log), {}, 1)
    want = np.asarray(j_img.make_batch_prep(j_stats, True, window)(
        jnp.asarray(stack), jnp.asarray(shifts)))
    got = image_ops.make_batch_prep(torch.from_numpy(mean_log), torch.from_numpy(std_log),
                                    window)(torch.from_numpy(stack), torch.from_numpy(shifts))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=CORRECTION_TIER[0],
                               atol=CORRECTION_TIER[1])
    corrected = image_ops.correct_illumination(torch.from_numpy(stack),
                                               torch.from_numpy(mean_log),
                                               torch.from_numpy(std_log))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_img.make_batch_prep(
        None, True, window)(jnp.asarray(corrected.numpy()), jnp.asarray(shifts))))


# ------------------------------------------------------------- registration
def _sites(n, size, seed=0):
    return j_bench.synthetic_cell_painting_batch(n, size=size, seed=seed, dapi_only=True)["DAPI"]


def _rolled(sites, seed):
    shifts = np.random.default_rng(seed).integers(-40, 41, (len(sites), 2))
    return np.stack([np.roll(s, tuple(d), axis=(0, 1)) for s, d in zip(sites, shifts)]), shifts


@pytest.mark.parametrize("size", [64, 96])
def test_batch_phase_correlation_exact_on_rolled_content(size):
    sites = _sites(6, size, seed=size)
    target, drift = _rolled(sites, seed=size)
    drift = np.where(np.abs(drift) > size // 2, drift % size, drift)  # within the window
    got, quality = registration.batch_phase_correlation_quality(torch.from_numpy(sites),
                                                                torch.from_numpy(target))
    want, want_q = j_reg.batch_phase_correlation_quality(jnp.asarray(sites), jnp.asarray(target))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and got.shape == (6, 2)
    rtol, atol = REGISTRATION_TIERS["quality"]
    np.testing.assert_allclose(quality.numpy(), np.asarray(want_q), rtol=rtol, atol=atol)
    np.testing.assert_array_equal(
        registration.batch_phase_correlation(torch.from_numpy(sites), torch.from_numpy(target)),
        np.asarray(j_reg.batch_phase_correlation(jnp.asarray(sites), jnp.asarray(target))))
    # the stored correction undoes the drift, modulo the site
    h = size
    np.testing.assert_array_equal(got.numpy() % h, (-drift) % h)


@pytest.mark.parametrize("shift", [(0, 0), (5, -7), (-7, 11), (20, 20), (-32, 31)])
def test_phase_correlation_sign_convention(shift):
    base = _img((64, 64), seed=11)
    target = np.roll(base, shift, axis=(0, 1))
    dy, dx = registration.phase_correlation(torch.from_numpy(base), torch.from_numpy(target))
    j_dy, j_dx = j_reg.phase_correlation(jnp.asarray(base), jnp.asarray(target))
    assert (int(dy), int(dx)) == (int(j_dy), int(j_dx))
    assert (int(dy) % 64, int(dx) % 64) == (-shift[0] % 64, -shift[1] % 64)


def test_quality_of_unrelated_images():
    a, b = _img((64, 64), seed=12), _img((64, 64), seed=13)
    dy, dx, q = registration.phase_correlation_quality(torch.from_numpy(a), torch.from_numpy(b))
    j_dy, j_dx, j_q = j_reg.phase_correlation_quality(jnp.asarray(a), jnp.asarray(b))
    rtol, atol = REGISTRATION_TIERS["quality"]
    np.testing.assert_allclose(float(q), float(j_q), rtol=rtol, atol=atol)
    assert float(q) < 0.5


@pytest.mark.parametrize("shift", [(3, -4), (-17, 9), (0, 0)])
def test_phase_correlation_subpixel(shift):
    base = _sites(1, 64, seed=21)[0]
    target = np.roll(base, shift, axis=(0, 1))
    got = registration.phase_correlation_subpixel(torch.from_numpy(base), torch.from_numpy(target))
    want = j_reg.phase_correlation_subpixel(jnp.asarray(base), jnp.asarray(target))
    rtol, atol = REGISTRATION_TIERS["subpixel"]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(float(g), float(w), rtol=rtol, atol=atol)
    assert (float(got[0]), float(got[1])) == (-shift[0], -shift[1])


@pytest.mark.parametrize("shifts", [[[3, -2], [-1, 4], [0, 0]], [[0, 0]], [], [[-5, -6], [-1, -2]]])
def test_intersection_window(shifts):
    s = np.asarray(shifts, np.int32).reshape(-1, 2)
    assert registration.intersection_window(s) == j_reg.intersection_window(s)
    assert registration.intersection_window(torch.from_numpy(s)) == j_reg.intersection_window(s)


def _reference_filter(shifts, quality, max_shift, min_quality):
    """The align step's rule as ``tmlibrary_tpu/workflow/steps/align.py:
    63-70`` writes it."""
    shifts = np.array(shifts)
    bad = np.abs(shifts).max(axis=1) > max_shift
    if min_quality > 0.0:
        bad |= quality < min_quality
    shifts[bad] = 0
    return shifts, bad


@pytest.mark.parametrize("max_shift,min_quality", [(50, 0.0), (10, 0.0), (50, 0.5), (3, 0.9)])
def test_align_filter(max_shift, min_quality):
    shifts = np.array([[0, 0], [12, -3], [-51, 2], [4, 50], [2, 2]], np.int32)
    quality = np.array([1.0, 0.95, 1.0, 0.3, 0.49], np.float32)
    got, bad = registration.filter_shifts(torch.from_numpy(shifts), torch.from_numpy(quality),
                                          max_shift, min_quality)
    want, want_bad = _reference_filter(shifts, quality, max_shift, min_quality)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(bad.numpy(), want_bad)


# ------------------------------------------------------------ bench helpers
def test_mosaic_and_pyramid_helpers_are_the_references():
    tiles = benchmarks.synthetic_channel_stack(1, 6, 32, seed=3)[0]
    for g, w in zip(benchmarks.cpu_reference_pyramid(tiles, (2, 3), 3, 250.0, 3000.0),
                    j_bench.cpu_reference_pyramid(tiles, (2, 3), 3, 250.0, 3000.0)):
        np.testing.assert_array_equal(g, w)


def test_device_chain_against_the_numpy_pyramid_job():
    """join, levels and stretch on the port against the numpy job: level 0
    exact, higher levels within one display step (numpy sums in its own
    order)."""
    tiles = benchmarks.synthetic_channel_stack(1, 4, 64, seed=5)[0]
    want = benchmarks.cpu_reference_pyramid(tiles, (2, 2), 2, 250.0, 3000.0)
    mosaic = image_ops.join_grid(torch.from_numpy(tiles), 2, 2)
    got = [pyramid.to_uint8(lv, 250.0, 3000.0).numpy()
           for lv in pyramid.pyramid_levels(mosaic, 2)]
    np.testing.assert_array_equal(got[0], want[0])
    assert np.abs(got[1].astype(int) - want[1]).max() <= 1
