"""The port's remaining jterator modules against the JAX package, on the CPU.

Every module of the reference's registry is registered in the port under
the same name, backend and parameters.  Each module below runs through
both registries (``get_module``) on the same inputs, made with numpy from
a seed: the reference one site at a time (its pipeline maps one site
under ``vmap``), the port on the batch.  The batches hold 3 sites whose
intensity ranges differ, so a reduction taken over the batch instead of
each site shows.  Every output is bit-exact but ``filter_edges``' ``log``
(within ``chip_smoke.LOG_TIER``: the gaussian's taps are an ulp from
XLA-CPU's at σ 2): masks, labels, clips, rescales (a true division on
both sides), weighted sums (each product rounded, as the reference run
eagerly), z-sums plane after plane and the mean times the float32
reciprocal of Z (``jnp.mean``'s arithmetic), sobel with a correctly
rounded root.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import LOG_TIER
from tmlibrary_tpu.benchmarks import synthetic_cell_painting_batch
from tmlibrary_tpu.jterator import modules as ref_modules
from tmlibrary_tpu_torch.jterator import modules as port_modules

torch.set_num_threads(1)

#: the per-site intensity scales: sites whose ranges differ
SCALES = np.array([1.0, 0.5, 3.0], np.float32)[:, None, None]


@pytest.fixture(scope="module")
def sites():
    data = synthetic_cell_painting_batch(3, size=64, n_cells=6, seed=11)
    return data["DAPI"] * SCALES, data["Actin"] * SCALES


@pytest.fixture(scope="module")
def labels(sites):
    """Nuclei of the 3 sites (the port's segment_primary, held against
    the reference elsewhere)."""
    seg = port_modules.get_module("segment_primary")
    return seg(torch.from_numpy(sites[0]), min_area=5, max_objects=64)["objects"].numpy()


def run_ref(name, arrays: dict, out: str, **consts) -> np.ndarray:
    """The reference module on each site alone, stacked."""
    fn = ref_modules.get_module(name)
    n = next(iter(arrays.values())).shape[0]
    return np.stack([
        np.asarray(fn(**{k: jnp.asarray(v[i]) for k, v in arrays.items()}, **consts)[out])
        for i in range(n)])


def run_port(name, arrays: dict, out: str, **consts) -> np.ndarray:
    fn = port_modules.get_module(name)
    return fn(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()},
              **consts)[out].numpy()


def hold_exact(name, arrays, out, **consts):
    want = run_ref(name, arrays, out, **consts)
    got = run_port(name, arrays, out, **consts)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)
    return got


# ------------------------------------------------------------------ registry
def test_registry_matches_the_reference():
    """Every module of the reference's ``tpu`` backend is in the port with
    the same parameter names, order and defaults."""
    ref = ref_modules.list_modules("tpu")
    assert port_modules.list_modules("tpu") == ref
    assert len(ref) >= 36
    for name in ref:
        want = inspect.signature(ref_modules.get_module(name)).parameters
        got = inspect.signature(port_modules.get_module(name)).parameters
        assert [(k, p.default, p.kind) for k, p in got.items()] == [
            (k, p.default, p.kind) for k, p in want.items()], name
        assert port_modules.get_module_version(name) == ref_modules.get_module_version(name)


# ---------------------------------------------------------------- filter
@pytest.mark.parametrize("feature,lower,upper", [
    ("area", 30.0, None),
    ("Morphology_area", None, 60.5),
    ("area", 20, 80),
    ("form_factor", 0.3, None),
    ("Morphology_eccentricity", None, 0.8),
    ("extent", 0.5, 0.9),
    ("perimeter", 12.0, None),
])
def test_filter_matches_jax(labels, feature, lower, upper):
    out = hold_exact("filter", {"label_image": labels}, "filtered_label_image",
                     feature=feature, lower_threshold=lower, upper_threshold=upper,
                     max_objects=64)
    assert out.max() <= labels.max()


def test_filter_refusals_match_jax(labels):
    lab = torch.from_numpy(labels)
    fn = port_modules.get_module("filter")
    ref = ref_modules.get_module("filter")
    with pytest.raises(ValueError, match="lower_threshold and/or upper_threshold"):
        fn(lab)
    with pytest.raises(ValueError) as port_err:
        fn(lab, feature="roundness", lower_threshold=0.5)
    with pytest.raises(ValueError) as ref_err:
        ref(jnp.asarray(labels[0]), feature="roundness", lower_threshold=0.5)
    assert str(port_err.value) == str(ref_err.value)
    assert "form_factor" in str(port_err.value)


def test_filter_drops_ids_beyond_capacity(labels):
    """Objects beyond ``max_objects`` are dropped before the renumbering."""
    hold_exact("filter", {"label_image": labels}, "filtered_label_image",
               feature="form_factor", lower_threshold=0.0, max_objects=3)


# ------------------------------------------------------- small image modules
def test_register_objects(labels):
    hold_exact("register_objects", {"label_image": labels.astype(np.int16)}, "objects")


@pytest.mark.parametrize("kind", ["float", "bool", "uint16", "zstack"])
def test_invert_is_per_site(sites, kind):
    dapi = sites[0]
    img = {"float": dapi, "bool": dapi > 400, "uint16": dapi.astype(np.uint16),
           "zstack": np.stack([dapi, dapi * 0.5], axis=1)}[kind]
    got = hold_exact("invert", {"image": img}, "inverted_image")
    if kind == "float":  # each site by its own maximum
        np.testing.assert_array_equal(got.reshape(3, -1).min(axis=1), 0.0)


@pytest.mark.parametrize("lower,upper", [(0.0, 65535.0), (250.0, 2000.0), (300, 300)])
def test_rescale(sites, lower, upper):
    hold_exact("rescale", {"intensity_image": sites[0]}, "rescaled_image",
               lower=lower, upper=upper)


@pytest.mark.parametrize("lower,upper", [(0.0, 65535.0), (310.0, 1500.5)])
def test_clip(sites, lower, upper):
    hold_exact("clip", {"intensity_image": sites[1]}, "clipped_image", lower=lower, upper=upper)


@pytest.mark.parametrize("mask_kind", ["bool", "labels"])
def test_mask(sites, labels, mask_kind):
    mask = labels > 0 if mask_kind == "bool" else labels
    hold_exact("mask", {"image": sites[1], "mask": mask}, "masked_image")


@pytest.mark.parametrize("operation", ["AND", "OR", "XOR", "xor"])
def test_combine_masks(sites, operation):
    a, b = sites[0] > 500, sites[1] > 450
    hold_exact("combine_masks", {"mask_1": a, "mask_2": b}, "combined_mask", operation=operation)


@pytest.mark.parametrize("weights", [(1.0, 1.0), (0.7, 1.3), (2.0, -0.25)])
def test_combine_channels(sites, weights):
    """Each product rounded, then the sum: bit-exact against the reference
    run eagerly."""
    hold_exact("combine_channels", {"image_1": sites[0], "image_2": sites[1]},
               "combined_image", weight_1=weights[0], weight_2=weights[1])


@pytest.mark.parametrize("name,kwargs", [
    ("combine_masks", {"operation": "NAND"}),
    ("project", {"method": "median"}),
    ("morphology", {"operation": "thin"}),
    ("filter_edges", {"method": "canny"}),
])
def test_unknown_options_raise_as_the_reference(sites, name, kwargs):
    arrays = {"combine_masks": {"mask_1": sites[0] > 0, "mask_2": sites[1] > 0},
              "project": {"zstack": sites[0][:, None]},
              "morphology": {"mask": sites[0] > 0},
              "filter_edges": {"intensity_image": sites[0]}}[name]
    with pytest.raises(ValueError) as port_err:
        run_port(name, arrays, "x", **kwargs)
    with pytest.raises(ValueError) as ref_err:
        run_ref(name, arrays, "x", **kwargs)
    assert str(port_err.value) == str(ref_err.value)


# ------------------------------------------------------------ z-projections
@pytest.fixture(scope="module")
def zstacks():
    rng = np.random.default_rng(5)
    return {z: (rng.normal(300.0, 40.0, (3, z, 48, 40)) * SCALES[:, None]).astype(np.float32)
            for z in (1, 3, 5, 8)}


@pytest.mark.parametrize("z", [1, 3, 5, 8])
@pytest.mark.parametrize("method", ["max", "mean", "sum"])
def test_project_matches_jax(zstacks, z, method):
    """Sums plane after plane, the mean times the float32 reciprocal of Z
    (``jnp.mean``'s own arithmetic): bit-exact."""
    got = hold_exact("project", {"zstack": zstacks[z]}, "projected_image", method=method)
    assert got.shape == (3, 48, 40)


@pytest.mark.parametrize("z", [3, 8])
def test_mip_matches_jax(zstacks, z):
    hold_exact("mip", {"zstack": zstacks[z]}, "mip_image")


# -------------------------------------------------------------- morphology
@pytest.mark.parametrize("operation", ["open", "close", "dilate", "erode"])
@pytest.mark.parametrize("iterations", [1, 2])
def test_morphology_matches_jax(sites, operation, iterations):
    mask = sites[0] > np.percentile(sites[0], 80)
    mask[:, 0, :5] = True  # objects on the border: out-of-image fill matters
    hold_exact("morphology", {"mask": mask}, "output_mask", operation=operation,
               iterations=iterations)


# ------------------------------------------------------------ edge filters
@pytest.mark.parametrize("method", ["sobel", "log"])
def test_filter_edges_matches_jax(sites, method):
    """sobel: the stencil's products and sums op by op, a correctly rounded
    root, exact; log: the gaussian at σ 2 from host taps (an ulp from
    XLA-CPU's, ROADMAP C), then the 5-point Laplacian, within
    ``LOG_TIER`` of the site's largest |image|."""
    arrays = {"intensity_image": sites[1]}
    want = run_ref("filter_edges", arrays, "filtered_image", method=method)
    got = run_port("filter_edges", arrays, "filtered_image", method=method)
    if method == "sobel":
        np.testing.assert_array_equal(got, want)
    else:
        scale = np.abs(sites[1]).reshape(3, -1).max(axis=1)[:, None, None]
        assert (np.abs(got - want) <= LOG_TIER * scale).all()


def test_filter_edges_sobel_edge_pad():
    """A step edge gives a gradient on both sides of it and none on flat
    ground, the image border included (edge-replicated pad)."""
    img = np.zeros((2, 16, 16), np.float32)
    img[:, :, 8:] = 1000.0
    got = hold_exact("filter_edges", {"intensity_image": img}, "filtered_image")
    assert (got[:, 8, 7] > 1000).all() and (got[:, :, 3] == 0).all()


# ------------------------------------------------------- expand and shrink
@pytest.mark.parametrize("n", [-3, -1, 0, 1, 2, 5])
def test_expand_or_shrink_matches_jax(labels, n):
    got = hold_exact("expand_or_shrink", {"label_image": labels}, "expanded_image", n=n)
    if n > 0:
        assert ((got > 0).sum() >= (labels > 0).sum())


def test_expand_ties_go_to_the_larger_label():
    lab = np.zeros((1, 9, 9), np.int32)
    lab[0, 4, 2], lab[0, 4, 6] = 3, 7
    got = hold_exact("expand_or_shrink", {"label_image": lab}, "expanded_image", n=2)
    assert got[0, 4, 4] == 7 and got[0, 4, 3] == 3


@pytest.mark.parametrize("n", [1, 3])
def test_expand_and_shrink_match_jax(labels, n):
    hold_exact("expand", {"label_image": labels}, "expanded_image", n=n)
    hold_exact("shrink", {"label_image": labels}, "shrunken_image", n=n)
