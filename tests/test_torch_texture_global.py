"""Haralick's ``quantization="global"`` in the port against the JAX
package, on the CPU.

Each site is quantised by its own range (the reference computes one site
under ``vmap``): the quantised pixels and every GLCM count are exact
against the reference's expression and both of its pair counts (the
scatter and the one-hot matmul); the 13 features lie within
``FEATURE_TIERS`` (``log``/``exp`` over the cells).  Sites whose ranges
differ, a flat site, ids above ``max_objects`` and L = 8, 16, 32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import assert_feature
from tmlibrary_tpu.benchmarks import synthetic_cell_painting_batch
from tmlibrary_tpu.jterator import modules as ref_modules
from tmlibrary_tpu.ops import measure as jm
from tmlibrary_tpu_torch.errors import NotSupportedError
from tmlibrary_tpu_torch.jterator import modules as port_modules
from tmlibrary_tpu_torch.ops import measure as tm

torch.set_num_threads(1)

M = 24
OFFSETS = [(0, 1), (1, 0), (1, 1), (1, -1)]


@pytest.fixture(scope="module")
def sites():
    """4 sites: three Cell Painting sites at scales 1, 0.3 and 5, their
    nuclei labels (ids above ``M`` on the last), and a flat fourth."""
    data = synthetic_cell_painting_batch(3, size=64, n_cells=8, seed=21)
    seg = port_modules.get_module("segment_primary")
    labs = seg(torch.from_numpy(data["DAPI"]), max_objects=64)["objects"].numpy()
    labs[2] = np.where(labs[2] > 0, labs[2] + M - 4, 0)  # some ids beyond M
    imgs = data["Actin"] * np.array([1.0, 0.3, 5.0], np.float32)[:, None, None]
    flat_lab = np.zeros((1, 64, 64), np.int32)
    flat_lab[0, 10:30, 10:40] = 1
    labs = np.concatenate([labs, flat_lab]).astype(np.int32)
    imgs = np.concatenate([imgs, np.full((1, 64, 64), 700.0, np.float32)])
    return labs, imgs


def ref_quantize(img, levels):
    """The reference's global quantisation (``measure.py:917-923``)."""
    lo, hi = jnp.min(img), jnp.max(img)
    span = jnp.maximum(hi - lo, 1e-6)
    return jnp.clip(((img - lo) / span * levels).astype(jnp.int32), 0, levels - 1)


@pytest.mark.parametrize("levels", [8, 16, 32])
def test_quantisation_and_counts_exact(sites, levels):
    labs, imgs = sites
    q = tm.quantize_global(torch.from_numpy(imgs), levels)
    got = tm.glcm_counts(torch.from_numpy(labs), q, M, levels, OFFSETS)
    for s in range(labs.shape[0]):
        jq = ref_quantize(jnp.asarray(imgs[s]), levels)
        np.testing.assert_array_equal(q[s].numpy(), np.asarray(jq))
        lab = jnp.asarray(labs[s])
        matmul = jm._glcm_matmul_all(lab, jq, M, levels, OFFSETS)
        for d, off in enumerate(OFFSETS):
            want = np.asarray(jm._glcm_scatter(lab, jq, M, levels, off))
            np.testing.assert_array_equal(got[d][s].numpy(), want)
            np.testing.assert_array_equal(got[d][s].numpy(), np.asarray(matmul[d]))
    assert float(got[0].sum()) > 0


@pytest.mark.parametrize("levels", [8, 16])
@pytest.mark.parametrize("glcm_method", ["scatter", "matmul"])
def test_global_features_match_jax(sites, levels, glcm_method):
    labs, imgs = sites
    got = tm.haralick_features(torch.from_numpy(labs), torch.from_numpy(imgs), M,
                               levels=levels, quantization="global")
    assert len(got) == 13
    for s in range(labs.shape[0]):
        want = jm.haralick_features(jnp.asarray(labs[s]), jnp.asarray(imgs[s]), M,
                                    levels=levels, quantization="global",
                                    glcm_method=glcm_method)
        for name, arr in want.items():
            assert_feature(name, got[name][s].numpy(), np.asarray(arr))


def test_global_quantisation_is_per_site(sites):
    """A site's buckets do not depend on the other sites of the batch."""
    labs, imgs = sites
    both = tm.quantize_global(torch.from_numpy(imgs), 16)
    for s in range(imgs.shape[0]):
        alone = tm.quantize_global(torch.from_numpy(imgs[s : s + 1]), 16)
        np.testing.assert_array_equal(both[s : s + 1].numpy(), alone.numpy())
    assert int(both[3].max()) == 0  # the flat site: one bucket


def test_measure_texture_module_takes_global_quantisation(sites):
    """The module runs as before; the op takes the option, distance 1
    only (the reference's pairs at distance 2 land short, ROADMAP C)."""
    labs, imgs = sites
    out = port_modules.get_module("measure_texture")(
        torch.from_numpy(labs), torch.from_numpy(imgs), levels=16, max_objects=M)
    ref = ref_modules.get_module("measure_texture")(
        jnp.asarray(labs[0]), jnp.asarray(imgs[0]), levels=16, max_objects=M)
    assert sorted(out["measurements"]) == sorted(ref["measurements"])
    with pytest.raises(NotSupportedError):
        tm.haralick_features(torch.from_numpy(labs), torch.from_numpy(imgs), M,
                             quantization="global", distance=2)
    with pytest.raises(ValueError, match="unknown quantization"):
        tm.haralick_features(torch.from_numpy(labs), torch.from_numpy(imgs), M,
                             quantization="percentile")
