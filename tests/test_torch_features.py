"""The config-4 feature kernels and families against the JAX package, on
the CPU.

``intensity_hist`` and ``glcm_all`` are held bit for bit, in their plain
versions (what the wrappers run for a CPU tensor), against the TPU
kernels in interpret mode, against the JAX scatter paths and against a
loop over the pixels written here.  Every count is an integer, so every
route agrees exactly, and so do the quantiles read off the counts.
Tolerances of the feature families (``chip_smoke.FEATURE_TIERS``):
morphology exact but for the ``atan2`` orientation, Haralick within its
tier (``log``/``exp`` differ by ulps between libraries), Zernike against
the reference's device formulation (``method="xla"``) at the tolerance
stated in its test.  The CUDA kernels are held against the plain versions
on the card by ``chip_smoke.py``.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from test_torch_pipeline import assert_feature
from tmlibrary_tpu.ops import fused_measure as jfm
from tmlibrary_tpu.ops import measure as jm
from tmlibrary_tpu_torch.errors import DeviceError, NotSupportedError
from tmlibrary_tpu_torch.ops import fused_measure as tfm
from tmlibrary_tpu_torch.ops import measure as tm
from tmlibrary_tpu_torch.ops.kernels import shift_with_fill

torch.set_num_threads(1)

SIZE = 64
#: label ids in the edge-case site: 1-7 present, 8-12 absent, 13 and 15
#: above the capacity and dropped
EDGE_M = 12
OFFSETS = [(0, 1), (1, 0), (1, 1), (1, -1)]
GOLDEN = Path(__file__).parent / "golden" / "cell_painting.npz"
GOLDEN_FAMILIES = Path(__file__).parent / "golden" / "feature_families.npz"


def edge_site(rng):
    """Objects touching the border, two abutting objects, a constant one
    (span 0), one whose values lie on and just below bucket edges, a
    single pixel in the corner, and ids above the capacity."""
    lab = np.zeros((SIZE, SIZE), np.int32)
    img = (rng.random((SIZE, SIZE)) * 4096).astype(np.float32)
    yy, xx = np.mgrid[:SIZE, :SIZE]
    lab[(yy - 10) ** 2 + (xx - 10) ** 2 <= 36] = 1
    lab[0:8, 40:52] = 2  # top border
    lab[30:40, 0:10] = 3  # left border, abuts 4
    lab[30:40, 10:20] = 4
    lab[50:56, 30:40] = 5
    img[50:56, 30:40] = 777.0  # constant: span 0
    lab[20:28, 50:64] = 6  # right border
    edges = np.float32(100.0) + np.float32(10.0) * np.arange(16, dtype=np.float32)
    below = np.nextafter(edges[1:], np.float32(0.0))
    vals = np.concatenate([edges, below])
    img[20:28, 50:64] = np.resize(vals, (8, 14))
    lab[63, 63] = 7  # one pixel, in the corner
    lab[56:64, 0:8] = EDGE_M + 3
    lab[44:48, 44:48] = EDGE_M + 1
    return lab, img


def cells_site(rng):
    """Dense random blobs, labelled 8-connected, ids in raster order."""
    smooth = ndi.gaussian_filter(rng.random((SIZE, SIZE)), 2.5)
    lab, _ = ndi.label(smooth > np.quantile(smooth, 0.55), np.ones((3, 3)))
    img = (ndi.gaussian_filter(rng.random((SIZE, SIZE)), 1.0) * 3000
           + rng.random((SIZE, SIZE)) * 50).astype(np.float32)
    return lab.astype(np.int32), img


@pytest.fixture(scope="module")
def sites():
    rng = np.random.default_rng(7)
    return [edge_site(rng), cells_site(rng)]


def t(*arrays):
    return torch.from_numpy(np.stack(arrays))


def raw_bounds(lab, img, m):
    """The raw per-object (min, max) the kernels take, as the port computes
    it, of one site (H, W) or a batch (B, H, W)."""
    lab, img = (torch.as_tensor(np.asarray(a)) for a in (lab, img))
    if lab.dim() == 2:
        lab, img = lab[None], img[None]
    return tm.grouped_minmax(lab, img, m)


# ------------------------------------------------------ hand-written loops
def loop_hist(lab, img, m, bins):
    lo_full, span_full = (np.asarray(a) for a in jfm._masked_bounds(
        jm.grouped_minmax(jnp.asarray(lab), jnp.asarray(img), m, method="scatter")))
    out = np.zeros((m, bins), np.float32)
    for (y, x), l in np.ndenumerate(lab):
        if 1 <= l <= m:
            out[l - 1, quantize_one(img[y, x], lo_full[l], span_full[l], bins)] += 1
    return out


def quantize_one(v, lo, span, levels):
    q = np.floor(np.float32(np.float32(v - lo) * np.float32(levels - 1))
                 / np.maximum(span, np.float32(1e-6)))
    return int(np.clip(q, 0, levels - 1))


def loop_glcm(lab, img, m, levels, offset):
    lo_full, span_full = (np.asarray(a) for a in jfm._masked_bounds(
        jm.grouped_minmax(jnp.asarray(lab), jnp.asarray(img), m, method="scatter")))
    dy, dx = offset
    out = np.zeros((m, levels, levels), np.float32)
    for (y, x), l in np.ndenumerate(lab):
        y2, x2 = y - dy, x - dx
        if not 1 <= l <= m or not (0 <= y2 < SIZE and 0 <= x2 < SIZE) or lab[y2, x2] != l:
            continue
        q1 = quantize_one(img[y, x], lo_full[l], span_full[l], levels)
        q2 = quantize_one(img[y2, x2], lo_full[l], span_full[l], levels)
        out[l - 1, q1, q2] += 1
    return out + out.transpose(0, 2, 1)


# ------------------------------------------------------------- bounds
@pytest.mark.parametrize("levels", [8, 16, 32, 256])
def test_bounds_and_quantize_match_jax(sites, levels):
    for lab, img in sites:
        lo, hi = raw_bounds(lab, img, EDGE_M)
        j_lo, j_hi = jm.grouped_minmax(jnp.asarray(lab), jnp.asarray(img), EDGE_M,
                                       method="scatter")
        np.testing.assert_array_equal(lo.numpy()[0], np.asarray(j_lo))
        np.testing.assert_array_equal(hi.numpy()[0], np.asarray(j_hi))
        for got, want in zip(tfm.masked_bounds(lo, hi), jfm._masked_bounds((j_lo, j_hi))):
            np.testing.assert_array_equal(got.numpy()[0], np.asarray(want))
        q = tm.quantize_per_object(t(lab), t(img), EDGE_M, levels).numpy()[0]
        np.testing.assert_array_equal(
            q, np.asarray(jm.quantize_per_object(jnp.asarray(lab), jnp.asarray(img),
                                                 EDGE_M, levels)))


def test_edge_values_land_on_their_bucket(sites):
    """Values on a bucket edge go up, one ulp below go down; a constant
    object is all bucket 0."""
    lab, img = sites[0]
    q = tm.quantize_per_object(t(lab), t(img), EDGE_M, 16).numpy()[0]
    vals, qs = img[lab == 6], q[lab == 6]
    for k in range(16):
        assert (qs[vals == np.float32(100 + 10 * k)] == k).all()
        if k:
            assert (qs[vals == np.nextafter(np.float32(100 + 10 * k), 0)] == k - 1).all()
    assert (q[lab == 5] == 0).all()


# ---------------------------------------------------------- intensity_hist
@pytest.mark.parametrize("bins", [16, 256])
def test_intensity_hist_matches_pallas_and_loop(sites, bins):
    labs, imgs = zip(*sites)
    got = tfm.intensity_hist(t(*labs), t(*imgs), EDGE_M, bins,
                             raw_bounds(np.stack(labs), np.stack(imgs), EDGE_M)).numpy()
    for i, (lab, img) in enumerate(sites):
        bounds = jm.grouped_minmax(jnp.asarray(lab), jnp.asarray(img), EDGE_M,
                                   method="scatter")
        pallas = np.asarray(jfm.intensity_hist(jnp.asarray(lab), jnp.asarray(img),
                                               EDGE_M, bins, bounds, interpret=True))
        np.testing.assert_array_equal(got[i], pallas)
        np.testing.assert_array_equal(got[i], loop_hist(lab, img, EDGE_M, bins))
        n_in = np.bincount(lab.ravel(), minlength=EDGE_M + 1)[1 : EDGE_M + 1]
        np.testing.assert_array_equal(got[i].sum(axis=1), n_in)  # ids > M dropped


@pytest.mark.parametrize("bins", [16, 256])
@pytest.mark.parametrize("method", ["scatter", "fused"])
def test_intensity_quantiles_match_jax(sites, bins, method):
    labs, imgs = zip(*sites)
    got = tm.intensity_quantiles(t(*labs), t(*imgs), EDGE_M, bins=bins)
    assert sorted(got) == ["Intensity_median", "Intensity_p25", "Intensity_p75"]
    for i, (lab, img) in enumerate(sites):
        want = jm.intensity_quantiles(jnp.asarray(lab), jnp.asarray(img), EDGE_M,
                                      bins=bins, method=method)
        for name, arr in want.items():
            np.testing.assert_array_equal(got[name].numpy()[i], np.asarray(arr), name)
    lab, img = sites[0]
    assert got["Intensity_median"][0, 4] == 777.0  # span 0
    assert (got["Intensity_p75"][0, 7:] == 0).all()  # absent


# ---------------------------------------------------------------- glcm_all
@pytest.mark.parametrize("levels", [8, 16, 32])
def test_glcm_all_matches_pallas_scatter_and_loop(sites, levels):
    labs, imgs = zip(*sites)
    got = tfm.glcm_all(t(*labs), t(*imgs), EDGE_M, levels, OFFSETS,
                       raw_bounds(np.stack(labs), np.stack(imgs), EDGE_M))
    assert len(got) == 4 and got[0].shape == (2, EDGE_M, levels, levels)
    for i, (lab, img) in enumerate(sites):
        jl, ji = jnp.asarray(lab), jnp.asarray(img)
        bounds = jm.grouped_minmax(jl, ji, EDGE_M, method="scatter")
        pallas = jfm.glcm_all(jl, ji, EDGE_M, levels, OFFSETS, bounds, interpret=True)
        q = jm.quantize_per_object(jl, ji, EDGE_M, levels)
        for d, off in enumerate(OFFSETS):
            g = got[d].numpy()[i]
            np.testing.assert_array_equal(g, np.asarray(pallas[d]), f"pallas {off}")
            scatter = jm._glcm_scatter(jl, q, EDGE_M, levels, off, "scatter")
            np.testing.assert_array_equal(g, np.asarray(scatter), f"scatter {off}")
            if levels == 16:
                np.testing.assert_array_equal(g, loop_glcm(lab, img, EDGE_M, levels, off))


def test_glcm_pairs_stay_inside_objects_and_image(sites):
    """Border pixels pair with nothing outside the image, abutting
    objects never pair across their edge: each object's pair count is
    twice its inner pairs."""
    lab, img = sites[0]
    got = tfm.glcm_all(t(lab), t(img), EDGE_M, 16, OFFSETS, raw_bounds(lab, img, EDGE_M))
    for d, (dy, dx) in enumerate(OFFSETS):
        same = shift_with_fill(t(lab), -dy, -dx, 0).numpy()[0] == lab
        for obj in range(1, EDGE_M + 1):
            pairs = int(((lab == obj) & same).sum())
            assert got[d][0, obj - 1].sum() == 2 * pairs, (obj, dy, dx)
    assert got[0][0, 6].sum() == 0  # the single pixel has no partner


def test_feature_kernels_capacity_invariant(sites):
    """Rows 1..8 are the same at max_objects 8 and 32 (ids 9 and up are
    dropped at 8)."""
    labs, imgs = zip(*sites)
    lab, img = t(*labs), t(*imgs)
    small_b, large_b = raw_bounds(lab, img, 8), raw_bounds(lab, img, 32)
    for bins in (16, 256):
        small = tfm.intensity_hist(lab, img, 8, bins, small_b)
        large = tfm.intensity_hist(lab, img, 32, bins, large_b)
        np.testing.assert_array_equal(small.numpy(), large.numpy()[:, :8])
    small = tfm.glcm_all(lab, img, 8, 16, OFFSETS, small_b)
    large = tfm.glcm_all(lab, img, 32, 16, OFFSETS, large_b)
    for a, b in zip(small, large):
        np.testing.assert_array_equal(a.numpy(), b.numpy()[:, :8])


# ------------------------------------------- full capacity and table edges
#: every object slot of the capacity site is present
CAP_M = 256


@pytest.fixture(scope="module")
def capacity_sites():
    """A 16x16 grid of 4x4 blocks labelled 1..256 over noise, and one
    object covering the whole site at one value (4,096 pixels in one
    bucket)."""
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[:SIZE, :SIZE]
    grid = ((yy // 4) * 16 + xx // 4 + 1).astype(np.int32)
    noise = (rng.random((SIZE, SIZE)) * 4096).astype(np.float32)
    whole = np.ones((SIZE, SIZE), np.int32)
    return [(grid, noise), (whole, np.full((SIZE, SIZE), 777.0, np.float32))]


def jax_bounds(lab, img, m, kind):
    """The reference's raw bounds; ``"absent"`` calls every third object
    absent (min +inf, max -inf) though its pixels are there."""
    lo, hi = (np.array(a) for a in jm.grouped_minmax(
        jnp.asarray(lab), jnp.asarray(img), m, method="scatter"))
    if kind == "absent":
        lo[::3], hi[::3] = np.inf, -np.inf
    return lo, hi


@pytest.mark.parametrize("bounds_kind", ["true", "absent"])
@pytest.mark.parametrize("bins", [2, 16, 256])
def test_intensity_hist_full_capacity_matches_pallas(capacity_sites, bins, bounds_kind):
    """All 256 slots present, a site-sized object, bounds that call
    present objects absent: the plain version equals the TPU kernel in
    interpret mode, and counts every pixel of ids 1..M."""
    labs, imgs = zip(*capacity_sites)
    bounds = [jax_bounds(lab, img, CAP_M, bounds_kind) for lab, img in capacity_sites]
    got = tfm.intensity_hist(t(*labs), t(*imgs), CAP_M, bins,
                             tuple(t(*b) for b in zip(*bounds))).numpy()
    for i, (lab, img) in enumerate(capacity_sites):
        pallas = jfm.intensity_hist(jnp.asarray(lab), jnp.asarray(img), CAP_M, bins,
                                    tuple(jnp.asarray(b) for b in bounds[i]), interpret=True)
        np.testing.assert_array_equal(got[i], np.asarray(pallas))
        np.testing.assert_array_equal(
            got[i].sum(axis=1), np.bincount(lab.ravel(), minlength=CAP_M + 1)[1:])
    assert got[1, 0].max() == SIZE * SIZE  # the whole site in one cell


@pytest.mark.parametrize("bounds_kind", ["true", "absent"])
@pytest.mark.parametrize("levels", [16, 32])
def test_glcm_all_full_capacity_matches_pallas_and_scatter(capacity_sites, levels,
                                                           bounds_kind):
    labs, imgs = zip(*capacity_sites)
    bounds = [jax_bounds(lab, img, CAP_M, bounds_kind) for lab, img in capacity_sites]
    got = tfm.glcm_all(t(*labs), t(*imgs), CAP_M, levels, OFFSETS,
                       tuple(t(*b) for b in zip(*bounds)))
    for i, (lab, img) in enumerate(capacity_sites):
        jl, ji = jnp.asarray(lab), jnp.asarray(img)
        jb = tuple(jnp.asarray(b) for b in bounds[i])
        pallas = jfm.glcm_all(jl, ji, CAP_M, levels, OFFSETS, jb, interpret=True)
        q = jm.quantize_per_object(jl, ji, CAP_M, levels, bounds=jb)
        for d, off in enumerate(OFFSETS):
            g = got[d].numpy()[i]
            np.testing.assert_array_equal(g, np.asarray(pallas[d]), f"pallas {off}")
            scatter = jm._glcm_scatter(jl, q, CAP_M, levels, off, "scatter")
            np.testing.assert_array_equal(g, np.asarray(scatter), f"scatter {off}")
    # the site-sized constant object: every horizontal pair in one diagonal cell, doubled
    assert got[0][1, 0].max() == 2 * SIZE * (SIZE - 1)


# --------------------------------------------------- count-table planner
def _check_plan(plan, budget):
    assert plan.smem_bytes <= budget
    ranges = plan.ranges()
    assert len(ranges) == plan.windows and ranges[-1][1] == plan.total
    assert all(stop - first <= plan.window for first, stop in ranges)
    covered = [u for first, stop in ranges for u in range(first, stop)]
    assert covered == list(range(plan.total))  # every row in exactly one window
    assert all(stop > first for first, stop in ranges)  # and no window empty


@pytest.mark.parametrize("budget", [tfm.SMEM_BYTES, tfm.SMEM_BYTES // 2, 8192, 512])
@pytest.mark.parametrize("m,bins", [(256, 256), (255, 256), (256, 2), (1, 16), (300, 17),
                                    (3, 70000)])
def test_plan_hist_puts_each_row_in_one_window(m, bins, budget):
    """Every object row lies in exactly one window, and no window exceeds
    the per-block budget; where one row does, windows of single cells."""
    plan = tfm.plan_hist(m, bins, budget)
    _check_plan(plan, budget)
    if bins + 2 <= budget // 4 - 3:  # a row and its staged bounds fit
        assert (plan.total, plan.row_words, plan.flat) == (m, bins, False)
    else:
        assert (plan.total, plan.row_words, plan.flat) == (m * bins, 1, True)
        assert plan.window % 4 == 0


@pytest.mark.parametrize("budget", [tfm.SMEM_BYTES, tfm.SMEM_BYTES // 2, 8192])
@pytest.mark.parametrize("m,levels,n_dirs", [(256, 16, 4), (256, 32, 4), (255, 8, 1),
                                             (12, 32, 2), (2, 241, 1)])
def test_plan_glcm_puts_each_object_in_one_window(m, levels, n_dirs, budget):
    """An object's row (its block for every direction, padded to L x
    (L + 1) words) lies in exactly one window; a row above the budget
    switches to windows of single cells of the table c + cᵀ."""
    plan = tfm.plan_glcm(m, levels, n_dirs, budget)
    _check_plan(plan, budget)
    row = n_dirs * levels * (levels + 1)
    assert plan.flat == (row + 2 > budget // 4 - 3)
    if plan.flat:
        assert (plan.total, plan.row_words) == (n_dirs * m * levels**2, 1)
    else:
        assert (plan.total, plan.row_words) == (m, row)


def test_plans_at_the_main_path_shapes():
    """In half a block's shared memory, the histogram's 256 rows go in
    three windows of 86 (87 KB a block with the staged bounds), config
    4's GLCM objects in ten windows of 26 (111 KB), L=32's in 43 of 6."""
    hist = tfm.plan_hist(256, 256)
    assert (hist.window, hist.windows, hist.smem_bytes) == (86, 3, (86 * 256 + 172) * 4)
    glcm = tfm.plan_glcm(256, 16, 4)
    assert (glcm.window, glcm.windows, glcm.flat) == (26, 10, False)
    assert glcm.smem_bytes == (26 * 4 * 16 * 17 + 52) * 4 <= tfm.SMEM_BYTES // 2
    assert (tfm.plan_glcm(256, 32, 4).window, tfm.plan_glcm(256, 32, 4).windows) == (6, 43)


def test_planner_refuses_what_no_launch_takes():
    with pytest.raises(ValueError):
        tfm.plan_hist(0, 256)
    with pytest.raises(ValueError):
        tfm.plan_hist(256, 256, budget=8)


# ------------------------------------------------- grouped_stats channel split
@pytest.mark.parametrize("n_channels", [9, 32, 33, 64])
def test_grouped_stats_channel_split_is_per_channel(sites, n_channels):
    """Channels are independent: one launch of up to ``MAX_CHANNELS``
    (9, 32), and more split into groups (33, 64), equal one call per
    channel bit for bit."""
    rng = np.random.default_rng(n_channels)
    labs, _ = zip(*sites)
    lab = t(*labs)
    chans = [torch.from_numpy(rng.normal(size=lab.shape).astype(np.float32))
             for _ in range(n_channels)]
    assert (n_channels > tfm.MAX_CHANNELS) == (n_channels > 32)
    sums, mins, maxs = tfm.grouped_stats(lab, chans, EDGE_M)
    assert sums.shape == (2, EDGE_M, n_channels)
    for c, ch in enumerate(chans):
        one = tfm.grouped_stats(lab, [ch], EDGE_M)
        for whole, part in zip((sums, mins, maxs), one):
            np.testing.assert_array_equal(whole[..., c].numpy(), part[..., 0].numpy())


def test_grouped_helpers_match_jax(sites):
    """``grouped_sums``, ``grouped_minmax_multi`` and ``lookup_by_label``
    (a gather) equal the JAX functions on the scatter route bit for bit."""
    labs, imgs = zip(*sites)
    lab, img = t(*labs), t(*imgs)
    chans = [img, img * img, torch.ones_like(img)]
    sums = tm.grouped_sums(lab, chans, EDGE_M).numpy()
    mins, maxs = (a.numpy() for a in tm.grouped_minmax_multi(lab, chans[:2], EDGE_M))
    table = np.random.default_rng(3).random((2, EDGE_M + 1, 2)).astype(np.float32)
    looked = tm.lookup_by_label(lab, torch.from_numpy(table)).numpy()
    for i, (jl, ji) in enumerate((jnp.asarray(a), jnp.asarray(b)) for a, b in sites):
        jc = [ji, ji * ji, jnp.ones_like(ji)]
        np.testing.assert_array_equal(
            sums[i], np.asarray(jm.grouped_sums(jl, jc, EDGE_M, method="scatter")))
        j_min, j_max = jm.grouped_minmax_multi(jl, jc[:2], EDGE_M, method="scatter")
        np.testing.assert_array_equal(mins[i], np.asarray(j_min))
        np.testing.assert_array_equal(maxs[i], np.asarray(j_max))
        want = np.asarray(jm.lookup_by_label(jnp.clip(jl, 0, EDGE_M), jnp.asarray(table[i])))
        np.testing.assert_array_equal(looked[i], want)


# ---------------------------------------------------------- feature families
def _assert_family(got, want, n_rows, tier=None):
    for name, arr in want.items():
        g, w = got[name].numpy()[:, :n_rows], np.asarray(arr)[:, :n_rows]
        if tier is None:
            assert_feature(name, g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=tier[0], atol=tier[1], err_msg=name)
    assert sorted(got) == sorted(want)


def _jax_batched(fn, *arrays):
    outs = [fn(*(jnp.asarray(a[i]) for a in arrays)) for i in range(arrays[0].shape[0])]
    return {k: np.stack([np.asarray(o[k]) for o in outs]) for k in outs[0]}


def test_morphology_matches_jax(sites):
    """Area, bounding box, perimeter and centroids bit for bit; the
    derived features too on the CPU, the orientation within its tier."""
    labs = np.stack([lab for lab, _ in sites])
    got = tm.morphology_features(torch.from_numpy(labs), EDGE_M)
    want = _jax_batched(lambda lab: jm.morphology_features(lab, EDGE_M), labs)
    _assert_family(got, want, EDGE_M)
    for name in ("Morphology_area", "Morphology_bbox_height", "Morphology_bbox_width",
                 "Morphology_perimeter", "Morphology_centroid_y", "Morphology_centroid_x"):
        np.testing.assert_array_equal(got[name].numpy(), want[name], name)


@pytest.mark.parametrize("levels", [8, 16])
@pytest.mark.parametrize("glcm_method", ["scatter", "fused"])
def test_haralick_matches_jax(sites, levels, glcm_method):
    labs, imgs = (np.stack(a) for a in zip(*sites))
    got = tm.haralick_features(torch.from_numpy(labs), torch.from_numpy(imgs), EDGE_M,
                               levels=levels)
    want = _jax_batched(lambda lab, img: jm.haralick_features(
        lab, img, EDGE_M, levels=levels, glcm_method=glcm_method), labs, imgs)
    assert len(got) == 13
    _assert_family(got, want, EDGE_M)


@pytest.mark.parametrize("degree", [4, 6, 9])
def test_zernike_matches_jax_device_formulation(sites, degree):
    """Against ``method="xla"``, the formulation the port follows: the
    same float32 expression, cos/sin/atan2 differing by ulps between the
    libraries (measured below 3e-7 absolute), held at atol 2e-6."""
    labs = np.stack([lab for lab, _ in sites])
    got = tm.zernike_features(torch.from_numpy(labs), EDGE_M, degree=degree)
    want = _jax_batched(
        lambda lab: jm.zernike_features(lab, EDGE_M, degree=degree, method="xla"), labs)
    assert len(got) == len(jm._zernike_coeffs(degree))
    _assert_family(got, want, EDGE_M, tier=(1e-4, 2e-6))


@pytest.mark.parametrize("family", ["morph_", "har_", "zer_"])
def test_families_match_golden(family):
    """The frozen families on the golden nuclei (``max_objects=32``,
    Haralick at 16 levels, Zernike at degree 6). The JAX package
    reproduces morphology and Haralick bit for bit on the CPU, and its
    device Zernike (``method="xla"``) within 2.5e-6 absolute of the
    float64 host twin that froze the golden; the port is held to its
    tiers, Zernike to atol 5e-6."""
    gold, fam = np.load(GOLDEN), np.load(GOLDEN_FAMILIES)
    lab = torch.from_numpy(gold["nuclei_labels"])
    img = torch.from_numpy(gold["dapi"].astype(np.float32))
    got = {"morph_": lambda: tm.morphology_features(lab, 32),
           "har_": lambda: tm.haralick_features(lab, img, 32, levels=16),
           "zer_": lambda: tm.zernike_features(lab, 32, degree=6)}[family]()
    prefix = {"morph_": "Morphology_", "har_": "Texture_", "zer_": "Zernike_"}[family]
    keys = sorted(k for k in fam.files if k.startswith(family))
    assert sorted(family + k.removeprefix(prefix) for k in got) == keys
    for name, arr in got.items():
        want = fam[family + name.removeprefix(prefix)]
        for s, n in enumerate(gold["nuclei_counts"]):
            g, w = arr.numpy()[s, :n], want[s, :n]
            if family == "zer_":
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=5e-6, err_msg=name)
            else:
                assert_feature(name, g, w)


def test_unported_haralick_options_raise(sites):
    """Only ``distance != 1`` is left unported (the reference's pairs
    beyond 1 land short, ROADMAP C), under either quantisation; the
    global quantisation is ported (tests/test_torch_texture_global.py)
    and an unknown one raises as in the reference."""
    lab, img = (t(a) for a in sites[0])
    for quantization in ("object", "global"):
        with pytest.raises(NotSupportedError):
            tm.haralick_features(lab, img, EDGE_M, distance=2, quantization=quantization)
    assert len(tm.haralick_features(lab, img, EDGE_M, quantization="global")) == 13
    with pytest.raises(ValueError, match="unknown quantization"):
        tm.haralick_features(lab, img, EDGE_M, quantization="image")


def test_shift_with_fill_reaches_beyond_one_pixel():
    row = torch.arange(1, 7, dtype=torch.int32).reshape(1, 1, 6)
    assert shift_with_fill(row, 0, -2, 0).tolist() == [[[0, 0, 1, 2, 3, 4]]]
    assert shift_with_fill(row, 0, 3, 0).tolist() == [[[4, 5, 6, 0, 0, 0]]]
    assert shift_with_fill(row, 0, 1, 0).tolist() == [[[2, 3, 4, 5, 6, 0]]]


# ------------------------------------------------------------------ dispatch
@pytest.mark.parametrize("name", ["hist", "glcm"])
def test_feature_wrappers_never_take_plain_version_off_cpu(name):
    """A tensor off the CPU goes to the kernel path, which raises here;
    the plain version runs only for CPU tensors and counts no launch."""
    wrapper = {"hist": tfm.intensity_hist, "glcm": tfm.glcm_all}[name]

    def call(dev):
        lab = torch.zeros((1, 8, 8), dtype=torch.int32, device=dev)
        img = torch.zeros((1, 8, 8), dtype=torch.float32, device=dev)
        bounds = (torch.zeros((1, 4), device=dev), torch.ones((1, 4), device=dev))
        if name == "hist":
            return wrapper(lab, img, 4, 16, bounds)
        return wrapper(lab, img, 4, 8, OFFSETS, bounds)

    before = wrapper.launches
    with pytest.raises(DeviceError):
        call("meta")
    call("cpu")
    assert wrapper.launches == before
