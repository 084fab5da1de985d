"""BASELINE config 4, the full feature stack, through the port's pipeline.

The same synthetic five-channel sites go through the JAX package's
``build_batch_fn(jit=False)`` and through the port on ``device="cpu"``
(the run the card's run is held to in ``chip_smoke.py``): labels and
object counts bit for bit, every feature within the tier that
``FEATURE_TIERS`` (``chip_smoke.py``) names for it.  The JAX run takes
most of this file's time, so it runs once per module.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import feature_tier
from test_torch_pipeline import _assert_same, assert_feature
from tmlibrary_tpu.benchmarks import full_feature_description as j_full_desc
from tmlibrary_tpu.benchmarks import synthetic_full_stack_batch as j_full_synth
from tmlibrary_tpu.jterator.pipeline import ImageAnalysisPipeline as JPipeline
from tmlibrary_tpu_torch import benchmarks
from tmlibrary_tpu_torch.errors import NotSupportedError
from tmlibrary_tpu_torch.jterator import modules
from tmlibrary_tpu_torch.jterator.description import PipelineDescription
from tmlibrary_tpu_torch.jterator.pipeline import (
    ImageAnalysisPipeline,
    from_jax_inputs,
    site_result_to_numpy,
)

torch.set_num_threads(1)

N_SITES, SIZE, N_CELLS, MAX_OBJECTS = 2, 96, 6, 32


def _port(data, desc, max_objects=MAX_OBJECTS):
    n = next(iter(data.values())).shape[0]
    raw, st, sh = from_jax_inputs(data, {}, np.zeros((n, 2)), device="cpu")
    pipe = ImageAnalysisPipeline(desc, max_objects=max_objects, device="cpu")
    return site_result_to_numpy(pipe.build_batch_fn()(raw, st, sh))


@pytest.fixture(scope="module")
def data():
    ref = j_full_synth(N_SITES, size=SIZE, n_cells=N_CELLS)
    ours = benchmarks.synthetic_full_stack_batch(N_SITES, size=SIZE, n_cells=N_CELLS)
    assert list(ours) == list(ref) == list(benchmarks.FULL_STACK_CHANNELS)
    for ch in ref:  # the port's generator draws the same pixels
        np.testing.assert_array_equal(ours[ch], ref[ch])
    return ref


@pytest.fixture(scope="module")
def runs(data):
    fn = JPipeline(j_full_desc(), max_objects=MAX_OBJECTS).build_batch_fn(jit=False)
    ref = fn({k: jnp.asarray(v) for k, v in data.items()}, {},
             jnp.zeros((N_SITES, 2), jnp.int32))
    return _port(data, benchmarks.full_feature_description()), ref


def test_description_matches_jax():
    """The port's copy of config 4 is the reference's, handle for handle."""
    ours, ref = benchmarks.full_feature_description(), j_full_desc()
    assert [m.module for m in ours.modules] == [m.module for m in ref.modules]
    for a, b in zip(ours.modules, ref.modules):
        assert a.constants() == b.constants()
        assert a.array_inputs() == b.array_inputs()
        assert [(h.name, h.key, h.objects, h.channel) for h in a.output] == [
            (h.name, h.key, h.objects, h.channel) for h in b.output]


def test_full_stack_matches_jax_batch_fn(runs):
    port, ref = runs
    _assert_same(port, ref)
    assert (port.counts["nuclei"] > 0).all() and (port.counts["cells"] > 0).all()


@pytest.mark.parametrize("family,objects,n_features", [
    ("Intensity_", "nuclei", 25), ("Intensity_", "cells", 25),
    ("Morphology_", "nuclei", 13), ("Morphology_", "cells", 13),
    ("Texture_", "cells", 13), ("Zernike_", "nuclei", 16),
])
def test_full_stack_feature_families(runs, family, objects, n_features):
    """Each family is present with its full width (5 channels x 5
    intensity features, 13 morphology, 13 Haralick, 16 Zernike moments
    at degree 6) and finite on every object row."""
    port, _ = runs
    feats = {k: v for k, v in port.measurements[objects].items() if k.startswith(family)}
    assert len(feats) == n_features
    counts = port.counts[objects]
    for name, arr in feats.items():
        assert arr.shape == (N_SITES, MAX_OBJECTS)
        for s, n in enumerate(counts):
            assert np.isfinite(arr[s, :n]).all(), name


def test_full_stack_capacity_invariant(data, runs):
    """Rows 1..n do not depend on max_objects: bit for bit, but for the
    transcendental features, whose CPU kernels take a vector path for full
    lanes and a scalar one for the tail, so a row can move by an ulp with
    the row count; those are held to their tier."""
    port, _ = runs
    n = int(port.counts["cells"].max())
    wide = _port(data, benchmarks.full_feature_description(), max_objects=n + 8)
    for obj, feats in port.measurements.items():
        for feat, arr in feats.items():
            got = wide.measurements[obj][feat][:, :n]
            if feature_tier(feat)[1] == 0.0:
                np.testing.assert_array_equal(got, arr[:, :n], err_msg=feat)
            else:
                assert_feature(feat, got, arr[:, :n])


def test_measure_texture_distance_above_one_raises(data):
    """The reference pairs the wrong pixels at distance 2 (its
    shift_with_fill pads by one pixel), so the port refuses it."""
    texture = {"handles": {
        "module": "measure_texture",
        "input": [{"name": "objects_image", "type": "LabelImage", "key": "cells"},
                  {"name": "intensity_image", "type": "IntensityImage", "key": "Actin"},
                  {"name": "distance", "type": "Numeric", "value": 2}],
        "output": [{"name": "measurements", "type": "Measurement", "objects": "cells",
                    "channel": "Actin"}]}}
    pipe = {**benchmarks.CELL_PAINTING_PIPE,
            "pipeline": benchmarks.CELL_PAINTING_PIPE["pipeline"] + [texture]}
    with pytest.raises(NotSupportedError):
        _port({ch: data[ch][:1] for ch in ("DAPI", "Actin")},
              PipelineDescription.from_dict(pipe))
    lab = torch.zeros((1, 8, 8), dtype=torch.int32)
    with pytest.raises(NotSupportedError):
        modules.get_module("measure_texture")(lab, lab.float(), distance=2)


def test_full_stack_channel_subset_matches_jax(data):
    """``channels`` picks the stains: a three-channel stack, run on a
    single site, agrees with the reference the same way."""
    chans = ("DAPI", "Actin", "Mito")
    sub = {ch: data[ch][:1] for ch in chans}
    port = _port(sub, benchmarks.full_feature_description(chans, texture_levels=8,
                                                          zernike_degree=4))
    fn = JPipeline(j_full_desc(chans, texture_levels=8, zernike_degree=4),
                   max_objects=MAX_OBJECTS).build_batch_fn(jit=False)
    ref = fn({k: jnp.asarray(v) for k, v in sub.items()}, {}, jnp.zeros((1, 2), jnp.int32))
    _assert_same(port, ref)
    assert not any(k.endswith("_Tubulin") for k in port.measurements["cells"])
