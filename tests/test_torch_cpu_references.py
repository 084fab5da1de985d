"""The single-CPU scipy twins of ``benchmarks.py`` and the count gates.

The port's copies of ``cpu_reference_site``, ``cpu_reference_site_full``,
``cpu_reference_site_smooth_threshold``, ``cpu_reference_site_volume``
and ``cpu_reference_site_dl`` (and their numpy helpers) return the JAX
package's values on the same seeded sites.  Then the gates the
reference's tests hold its pipelines to (``tests/test_pipeline.py``
config 2, ``tests/test_full_stack.py`` config 4), held on the port's CPU
run: config 2's object counts equal its twin's, config 4's nuclei equal
theirs, and config 3's and the volume path's nuclei equal theirs where
the reference's own do (each case checks the reference too).
"""

import numpy as np
import pytest
import torch

from tmlibrary_tpu_torch import benchmarks
from tmlibrary_tpu_torch.jterator.pipeline import (
    ImageAnalysisPipeline,
    from_jax_inputs,
    site_result_to_numpy,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ref():
    from tmlibrary_tpu import benchmarks as ref_benchmarks

    return ref_benchmarks


@pytest.fixture(scope="module")
def sites3():
    return benchmarks.synthetic_cell_painting_batch(3, size=96, seed=3)


@pytest.mark.parametrize("site", range(3))
def test_cpu_reference_site(ref, sites3, site):
    args = (sites3["DAPI"][site], sites3["Actin"][site])
    got = benchmarks.cpu_reference_site(*args)
    assert got == ref.cpu_reference_site(*args)
    assert got[0] > 0 and got[1] > 0


@pytest.mark.parametrize("site", range(2))
@pytest.mark.parametrize("levels, degree", [(16, 6), (8, 4)])
def test_cpu_reference_site_full(ref, site, levels, degree):
    data = benchmarks.synthetic_full_stack_batch(2, size=96, n_cells=5, seed=1)
    channels = {ch: v[site] for ch, v in data.items()}
    got = benchmarks.cpu_reference_site_full(channels, levels, degree)
    assert got == ref.cpu_reference_site_full(channels, levels, degree)
    assert got[0] > 0


@pytest.mark.parametrize("site", range(3))
def test_cpu_reference_site_smooth_threshold(ref, sites3, site):
    dapi = sites3["DAPI"][site]
    got = benchmarks.cpu_reference_site_smooth_threshold(dapi)
    assert got == ref.cpu_reference_site_smooth_threshold(dapi) > 0


@pytest.mark.parametrize("site", range(2))
def test_cpu_reference_site_volume(ref, site):
    zstack = benchmarks.synthetic_volume_batch(2, size=48, depth=8, n_cells=4, seed=2)["DAPI"]
    got = benchmarks.cpu_reference_site_volume(zstack[site])
    assert got == ref.cpu_reference_site_volume(zstack[site])
    assert got[0] > 0


@pytest.mark.parametrize("weights", ["seed:0", "seed:4:base=4:depth=1"])
@pytest.mark.parametrize("shape", [(64, 64), (50, 37)])
def test_cpu_reference_site_dl(ref, weights, shape):
    dapi = benchmarks.synthetic_cell_painting_batch(1, size=64, dapi_only=True,
                                                    seed=5)["DAPI"][0][:shape[0], :shape[1]]
    got = benchmarks.cpu_reference_site_dl(dapi, weights)
    assert got == ref.cpu_reference_site_dl(dapi, weights)


def test_the_dl_twin_reads_the_reference_weights(ref):
    """The port's ``resolve_weights`` gives the reference's parameter
    names, arrays and depth, which the twin's layer walk reads."""
    from tmlibrary_tpu.nn import resolve_weights as ref_resolve

    from tmlibrary_tpu_torch.nn.weights import resolve_weights

    for spec in ("seed:0", "seed:4:base=4:depth=1"):
        params, _, cfg = resolve_weights(spec)
        want, _, want_cfg = ref_resolve(spec)
        assert cfg.depth == want_cfg.depth
        assert sorted(params) == sorted(want)
        assert "enc0/conv1/w" in params and f"dec{cfg.depth}/w" in params
        for k in params:
            np.testing.assert_array_equal(np.asarray(params[k]), np.asarray(want[k]), k)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel", [1, 3])
def test_conv2d_numpy(ref, stride, kernel):
    rng = np.random.default_rng(stride * 10 + kernel)
    x = rng.normal(size=(13, 10, 3)).astype(np.float32)
    w = rng.normal(size=(kernel, kernel, 3, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    got = benchmarks._conv2d_numpy(x, w, b, stride)
    np.testing.assert_array_equal(got, ref._conv2d_numpy(x, w, b, stride))
    assert got.shape == (-(-13 // stride), -(-10 // stride), 5)


@pytest.mark.parametrize("degree", [0, 4, 6])
def test_zernike_numpy(ref, degree):
    yy, xx = np.mgrid[0:21, 0:17]
    mask = (yy - 9) ** 2 / 64 + (xx - 8) ** 2 / 36 <= 1
    got = benchmarks._zernike_numpy(mask, degree)
    np.testing.assert_array_equal(got, ref._zernike_numpy(mask, degree))
    np.testing.assert_array_equal(benchmarks._zernike_numpy(np.zeros((3, 3), bool)), np.zeros(1))


@pytest.mark.parametrize("levels", [8, 16])
def test_haralick_numpy(ref, levels):
    rng = np.random.default_rng(levels)
    img = rng.uniform(0, 4000, (19, 23)).astype(np.float32)
    mask = rng.uniform(size=(19, 23)) < 0.7
    got = benchmarks._haralick_numpy(img, mask, levels)
    assert got.shape == (16,)
    np.testing.assert_array_equal(got, ref._haralick_numpy(img, mask, levels))


# ------------------------------------------------------------- count gates
def _port_counts(desc, data, max_objects):
    n = next(iter(data.values())).shape[0]
    raw, stats, shifts = from_jax_inputs(data, {}, np.zeros((n, 2)), device="cpu")
    fn = ImageAnalysisPipeline(desc, max_objects=max_objects, device="cpu").build_batch_fn()
    return {k: v.tolist() for k, v in site_result_to_numpy(fn(raw, stats, shifts)).counts.items()}


def _ref_counts(desc, data, max_objects):
    import jax.numpy as jnp

    from tmlibrary_tpu.jterator.pipeline import ImageAnalysisPipeline as JPipeline

    n = next(iter(data.values())).shape[0]
    fn = JPipeline(desc, max_objects=max_objects).build_batch_fn(jit=False)
    res = fn({k: jnp.asarray(v) for k, v in data.items()}, {}, jnp.zeros((n, 2), jnp.int32))
    return {k: np.asarray(v).tolist() for k, v in res.counts.items()}


def test_config2_counts_equal_the_scipy_twin(monkeypatch):
    """As ``tests/test_pipeline.py::test_smooth_threshold_config2_matches_scipy``."""
    data = benchmarks.synthetic_cell_painting_batch(4, size=128)
    got = _port_counts(benchmarks.smooth_threshold_description(), {"DAPI": data["DAPI"]}, 256)
    want = [benchmarks.cpu_reference_site_smooth_threshold(np.asarray(data["DAPI"][s],
                                                                      np.float32))
            for s in range(4)]
    assert got["fg"] == want


def test_config4_nuclei_equal_the_scipy_twin():
    """As ``tests/test_full_stack.py::test_counts_match_cpu_reference``."""
    data = benchmarks.synthetic_full_stack_batch(4, size=96, n_cells=5)
    desc = benchmarks.full_feature_description(texture_levels=8, zernike_degree=4)
    got = _port_counts(desc, data, 32)
    want = [benchmarks.cpu_reference_site_full({ch: v[s] for ch, v in data.items()})[0]
            for s in range(4)]
    assert got["nuclei"] == want


def test_config3_nuclei_equal_the_scipy_twin(ref):
    data = benchmarks.synthetic_cell_painting_batch(4, size=96, seed=1)
    want = [benchmarks.cpu_reference_site(data["DAPI"][s], data["Actin"][s])[0]
            for s in range(4)]
    assert _ref_counts(ref.cell_painting_description(), data, 32)["nuclei"] == want
    assert _port_counts(benchmarks.cell_painting_description(), data, 32)["nuclei"] == want


def test_volume_nuclei_equal_the_scipy_twin(ref, monkeypatch):
    monkeypatch.setenv("TMX_NATIVE", "0")
    data = benchmarks.synthetic_volume_batch(2, size=48, depth=8, n_cells=4)
    want = [benchmarks.cpu_reference_site_volume(data["DAPI"][s]) for s in range(2)]
    for counts in (_ref_counts(ref.volume_description(), data, 16),
                   _port_counts(benchmarks.volume_description(), data, 16)):
        assert counts["nuclei3d"] == [w[0] for w in want]
