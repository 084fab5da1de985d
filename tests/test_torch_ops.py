"""The port's modules with no kernel against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: masks, labels, counts, the Otsu cut, min and max exact;
the gaussian bit-exact against the JAX function run eagerly and within
``rtol=1e-6`` of the jitted one (XLA-CPU contracts its multiply-adds
into FMAs and computes the taps with its own ``exp``); intensity sums
``rtol=1e-6``, std ``rtol=1e-3, atol=1e-4`` (as ``tests/test_parity_fuzz.py``);
illumination correction ``rtol=1e-5`` (``log10``/``pow`` differ by ulps
between the two libraries).
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from tmlibrary_tpu.benchmarks import synthetic_cell_painting_batch
from tmlibrary_tpu.ops import image_ops as j_img
from tmlibrary_tpu.ops import label as j_label
from tmlibrary_tpu.ops import measure as j_measure
from tmlibrary_tpu.ops import smooth as j_smooth
from tmlibrary_tpu.ops import threshold as j_threshold
from tmlibrary_tpu.ops.histogram import histogram_fixed_bins as j_hist
from tmlibrary_tpu_torch.errors import HandleError
from tmlibrary_tpu_torch.jterator.handles import InputHandle
from tmlibrary_tpu_torch.jterator.pipeline import from_jax_inputs
from tmlibrary_tpu_torch.ops import _exact
from tmlibrary_tpu_torch.ops import image_ops as t_img
from tmlibrary_tpu_torch.ops import label as t_label
from tmlibrary_tpu_torch.ops import measure as t_measure
from tmlibrary_tpu_torch.ops import smooth as t_smooth
from tmlibrary_tpu_torch.ops import threshold as t_threshold
from tmlibrary_tpu_torch.ops.histogram import histogram_fixed_bins as t_hist

# the suite runs several xdist workers on shared cores: one intra-op
# thread per worker keeps the small parity fixtures from oversubscribing
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sites():
    data = synthetic_cell_painting_batch(3, size=64, n_cells=5, seed=7)
    return data["DAPI"], data["Actin"]


def _labels(dapi):
    """Nuclei labels from the port (held to the JAX chain in the
    pipeline tests), for the measurement tests."""
    sm = t_smooth.gaussian_smooth(torch.from_numpy(dapi), 1.5)
    mask = t_label.fill_holes(t_threshold.threshold_otsu(sm))
    return t_label.connected_components(mask)[0].numpy()


# ---------------------------------------------------------------- smooth
@pytest.mark.parametrize("sigma", [1.5, 2.0])
def test_gaussian_smooth_matches_jax(sites, sigma):
    dapi = sites[0]
    got = t_smooth.gaussian_smooth(torch.from_numpy(dapi), sigma).numpy()
    eager = np.stack([np.asarray(j_smooth.gaussian_smooth(d, sigma)) for d in dapi])
    jitted = np.asarray(jax.jit(jax.vmap(lambda a: j_smooth.gaussian_smooth(a, sigma)))(dapi))
    np.testing.assert_allclose(got, jitted, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, eager, rtol=1e-6, atol=0)
    if sigma == 1.5:  # the pipeline's sigma: bit-exact against eager JAX
        np.testing.assert_array_equal(got, eager)


def test_gaussian_taps_match_jax():
    r = t_smooth.gaussian_radius(1.5)
    assert r == j_smooth.gaussian_radius(1.5)
    np.testing.assert_array_equal(
        t_smooth.gaussian_taps(1.5, r), np.asarray(j_smooth._gaussian_kernel1d(1.5, r)))


# ------------------------------------------------------- otsu / histogram
@pytest.mark.parametrize("n", [10, 16, 100, 256, 1000])
def test_cumsum_matches_xla_cpu_order(n):
    rng = np.random.default_rng(n)
    x = (rng.random((2, n)) * 1000 * rng.integers(0, 500, (2, n))).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(x))
    np.testing.assert_array_equal(_exact.cumsum_xla_cpu(torch.from_numpy(x)).numpy(), want)


def test_otsu_cut_exact(sites):
    dapi, actin = sites
    rng = np.random.default_rng(3)
    noise = rng.gamma(2.0, 300.0, (2, 64, 64)).astype(np.float32)
    smoothed = np.stack([np.asarray(j_smooth.gaussian_smooth(d, 1.5)) for d in dapi])
    for imgs in (dapi, actin, smoothed, noise):
        got = t_threshold.otsu_value(torch.from_numpy(imgs)).numpy()
        for i, img in enumerate(imgs):
            assert got[i] == np.float32(j_threshold.otsu_value(img)), i
            assert got[i] == np.float32(j_threshold.otsu_value(img, method="xla")), i
        mask = t_threshold.threshold_otsu(torch.from_numpy(imgs), correction_factor=0.8)
        for i, img in enumerate(imgs):
            np.testing.assert_array_equal(
                mask[i].numpy(),
                np.asarray(j_threshold.threshold_otsu(img, correction_factor=0.8)))


def test_histogram_fixed_bins_exact():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 260, (2, 500)).astype(np.int32)  # >= bins dropped
    got = t_hist(torch.from_numpy(idx), 256).numpy()
    for i in range(2):
        want = np.asarray(j_hist(jnp.asarray(idx[i]), 256, method="scatter"))
        np.testing.assert_array_equal(got[i], want)


def test_threshold_manual():
    img = torch.tensor([[[1.0, 5.0], [3.0, 7.0]]])
    np.testing.assert_array_equal(
        t_threshold.threshold_manual(img, 3.0).numpy(),
        np.asarray(j_threshold.threshold_manual(img.numpy(), 3.0)))


# ----------------------------------------------------------------- labels
@pytest.mark.parametrize("connectivity", [4, 8])
def test_connected_components_exact_vs_jax_and_scipy(rng, connectivity):
    masks = rng.random((3, 48, 48)) < 0.45
    labels, count = t_label.connected_components(torch.from_numpy(masks), connectivity)
    st = ndi.generate_binary_structure(2, 1 if connectivity == 4 else 2)
    for i, m in enumerate(masks):
        lab_sp, n_sp = ndi.label(m, st)
        np.testing.assert_array_equal(labels[i].numpy(), lab_sp)
        assert int(count[i]) == n_sp
        for method in ("auto", "xla"):
            lab_j, n_j = j_label.connected_components(m, connectivity, method=method)
            np.testing.assert_array_equal(labels[i].numpy(), np.asarray(lab_j))
            assert int(count[i]) == int(n_j)


def test_fill_holes_matches_jax_auto(rng):
    masks = rng.random((2, 40, 40)) < 0.6
    got = t_label.fill_holes(torch.from_numpy(masks)).numpy()
    for i, m in enumerate(masks):
        np.testing.assert_array_equal(got[i], np.asarray(j_label.fill_holes(m)))


@pytest.mark.parametrize("min_area,max_area,cap", [(20, None, 64), (5, 40, 64), (0, 30, 3)])
def test_filter_by_area_exact(rng, min_area, max_area, cap):
    masks = rng.random((2, 48, 48)) < 0.5
    labels = t_label.connected_components(torch.from_numpy(masks))[0]
    got = t_label.filter_by_area(labels, cap, min_area=min_area, max_area=max_area)
    for i in range(2):
        want = j_label.filter_by_area(
            jnp.asarray(labels[i].numpy()), cap, min_area=min_area, max_area=max_area)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        t_label.clip_label_count(labels, cap).numpy(),
        np.asarray(j_label.clip_label_count(jnp.asarray(labels.numpy()), cap)))


# ---------------------------------------------------------------- measure
def _assert_intensity(got, want, n):
    for key, arr in want.items():
        a, b = got[key][:n], np.asarray(arr)[:n]
        if "std" in key:
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4, err_msg=key)
        elif "sum" in key or "mean" in key:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("method", ["auto", "fused", "scatter"])
def test_intensity_features_match_jax(sites, method):
    dapi = sites[0]
    labels = _labels(dapi)
    cap = 16
    got = t_measure.intensity_features(torch.from_numpy(labels), torch.from_numpy(dapi), cap)
    for i in range(len(dapi)):
        n = int(labels[i].max())
        want = j_measure.intensity_features(
            jnp.asarray(labels[i]), jnp.asarray(dapi[i]), cap, method=method)
        _assert_intensity({k: v[i].numpy() for k, v in got.items()}, want, n)


def test_intensity_features_capacity_invariant(sites):
    dapi = sites[0]
    labels = torch.from_numpy(_labels(dapi))
    n = int(labels.max())
    small = t_measure.intensity_features(labels, torch.from_numpy(dapi), n)
    large = t_measure.intensity_features(labels, torch.from_numpy(dapi), n + 37)
    for key in small:
        np.testing.assert_array_equal(small[key].numpy(), large[key].numpy()[:, :n])


# -------------------------------------------------------------- image ops
def test_correct_illumination_carried_across():
    rng = np.random.default_rng(11)
    raw = rng.integers(0, 4000, (2, 32, 32)).astype(np.uint16)
    mean_log = (2.5 + 0.3 * rng.random((32, 32))).astype(np.float32)
    std_log = (0.1 + 0.2 * rng.random((32, 32))).astype(np.float32)
    std_log[0, :4] = 0.0  # the guarded near-zero branch
    t_raw, t_stats, _ = from_jax_inputs(
        {"DAPI": raw}, {"DAPI": (mean_log, std_log)}, np.zeros((2, 2)), device="cpu")
    got = t_img.correct_illumination(t_raw["DAPI"], *t_stats["DAPI"]).numpy()
    for i in range(2):
        want = np.asarray(j_img.correct_illumination(raw[i], mean_log, std_log))
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-3)


def test_shift_align_crop_exact():
    rng = np.random.default_rng(5)
    imgs = rng.random((4, 20, 24)).astype(np.float32)
    shifts = np.array([[0, 0], [2, -3], [-5, 1], [25, 4]], np.int32)
    window = (2, 1, 3, 0)
    got = t_img.align(torch.from_numpy(imgs), torch.from_numpy(shifts), window).numpy()
    for i in range(4):
        want = j_img.align(imgs[i], shifts[i, 0], shifts[i, 1], window)
        np.testing.assert_array_equal(got[i], np.asarray(want))


# ------------------------------------------------ handles and description
def test_validate_array_torch_dtypes():
    img = InputHandle("intensity_image", "IntensityImage", key="x")
    lab = InputHandle("objects_image", "LabelImage", key="y")
    mask = InputHandle("mask", "BinaryImage", key="z")
    img.validate_array(torch.zeros(2, dtype=torch.uint16))
    img.validate_array(torch.zeros(2, dtype=torch.float32))
    lab.validate_array(torch.zeros(2, dtype=torch.int32))
    mask.validate_array(torch.zeros(2, dtype=torch.bool))
    for handle, bad in ((img, torch.int32), (lab, torch.float32), (lab, torch.bool),
                        (mask, torch.float32)):
        with pytest.raises(HandleError):
            handle.validate_array(torch.zeros(2, dtype=bad))


def test_description_from_dict_without_yaml():
    """``from_dict`` must not need PyYAML (the card's host may lack it)."""
    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "from tmlibrary_tpu_torch.benchmarks import cell_painting_description\n"
        "d = cell_painting_description(); d.validate()\n"
        "print(len(d.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "5"
