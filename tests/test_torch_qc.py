"""Per-site QC statistics in the port, against the JAX package.

The four statistics of ``tmlibrary_tpu/ops/qc.py`` on the same raw
sites, within ``QC_TIERS`` (``chip_smoke.py``; ``saturation_frac``
exact), and ``build_batch_fn(qc=True)`` on config 3 against the
reference's ``build_batch_fn(jit=False, qc=True)``: the pipeline's
outputs as in ``tests/test_torch_pipeline.py`` and bit-identical to the
port's run with QC off.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import QC_TIERS
from tests.test_torch_pipeline import _assert_same
from tmlibrary_tpu.benchmarks import cell_painting_description as j_desc
from tmlibrary_tpu.benchmarks import synthetic_cell_painting_batch as j_synth
from tmlibrary_tpu.jterator.pipeline import ImageAnalysisPipeline as JPipeline
from tmlibrary_tpu.ops import qc as j_qc
from tmlibrary_tpu_torch import benchmarks
from tmlibrary_tpu_torch.jterator.pipeline import (
    ImageAnalysisPipeline,
    SiteResult,
    from_jax_inputs,
    site_result_to_numpy,
)
from tmlibrary_tpu_torch.ops import qc

torch.set_num_threads(1)


def _sites(size, n=4, seed=0):
    """Config 3's DAPI sites with a saturated corner, a saturated row above
    the ceiling, a constant site and an all-dark one."""
    raw = j_synth(n, size=size, seed=seed, dapi_only=True)["DAPI"]
    raw[0, :5, :5] = 65535.0
    raw[1, 3, :] = 70000.0
    raw = np.concatenate([raw, np.full((1, size, size), 1234.0, np.float32),
                          np.zeros((1, size, size), np.float32)])
    return raw


def _ref(raw):
    per_site = [j_qc.site_qc_stats(jnp.asarray(r)) for r in raw]
    return {k: np.array([float(s[k]) for s in per_site], np.float32)
            for k in j_qc.QC_IMAGE_METRICS}


def assert_qc(got, want):
    assert sorted(got) == sorted(want) == sorted(QC_TIERS)
    for k, (rtol, atol) in QC_TIERS.items():
        g = np.asarray(got[k])
        assert g.dtype == np.float32 and g.shape == want[k].shape
        if rtol == atol == 0.0:
            np.testing.assert_array_equal(g, want[k], err_msg=k)
        else:
            np.testing.assert_allclose(g, want[k], rtol=rtol, atol=atol, err_msg=k)


def test_constants_are_the_references():
    assert qc.SATURATION_LEVEL == j_qc.SATURATION_LEVEL
    assert qc.BACKGROUND_BLOCK == j_qc.BACKGROUND_BLOCK
    assert qc.QC_IMAGE_METRICS == j_qc.QC_IMAGE_METRICS


@pytest.mark.parametrize("size", [64, 96, (70, 45), (5, 5), (8, 3)])
def test_site_qc_stats_match_reference(size):
    h, w = (size, size) if isinstance(size, int) else size
    raw = _sites(max(h, w))[:, :h, :w].copy()
    got = {k: v.numpy() for k, v in qc.site_qc_stats(torch.from_numpy(raw)).items()}
    assert_qc(got, _ref(raw))


@pytest.mark.parametrize("fn,name", [
    (qc.saturation_fraction, "saturation_frac"), (qc.background_level, "background"),
    (qc.focus_tenengrad, "focus_tenengrad"), (qc.laplacian_variance, "laplacian_var"),
])
def test_each_statistic(fn, name):
    raw = _sites(64, seed=3)
    want = {"saturation_frac": j_qc.saturation_fraction, "background": j_qc.background_level,
            "focus_tenengrad": j_qc.focus_tenengrad,
            "laplacian_var": j_qc.laplacian_variance}[name]
    ref = np.array([float(want(jnp.asarray(r))) for r in raw], np.float32)
    rtol, atol = QC_TIERS[name]
    np.testing.assert_allclose(fn(torch.from_numpy(raw)).numpy(), ref, rtol=rtol, atol=atol)


def test_saturation_level_and_block_arguments():
    raw = _sites(64, seed=5)
    np.testing.assert_array_equal(
        qc.saturation_fraction(torch.from_numpy(raw), level=1000.0).numpy(),
        np.array([float(j_qc.saturation_fraction(jnp.asarray(r), 1000.0)) for r in raw],
                 np.float32))
    rtol, atol = QC_TIERS["background"]
    np.testing.assert_allclose(
        qc.background_level(torch.from_numpy(raw), block=16).numpy(),
        np.array([float(j_qc.background_level(jnp.asarray(r), 16)) for r in raw]),
        rtol=rtol, atol=atol)


def test_zstack_channel_is_max_projected():
    vol = j_synth(6, size=48, seed=8, dapi_only=True)["DAPI"].reshape(2, 3, 48, 48)
    got = {k: v.numpy() for k, v in qc.site_qc_stats(torch.from_numpy(vol)).items()}
    per_site = [j_qc.site_qc_stats(jnp.asarray(v)) for v in vol]  # (Z, H, W): folded
    assert_qc(got, {k: np.array([float(s[k]) for s in per_site], np.float32)
                    for k in j_qc.QC_IMAGE_METRICS})


# ------------------------------------------------------------ batch fn
@pytest.fixture(scope="module", params=[64, 96])
def batch(request):
    data = benchmarks.synthetic_cell_painting_batch(3, size=request.param, seed=1)
    data["DAPI"][0, :3, :3] = 65535.0
    return data


def _port(data, qc_on):
    raw, st, sh = from_jax_inputs(data, {}, np.zeros((3, 2)), device="cpu")
    fn = ImageAnalysisPipeline(benchmarks.cell_painting_description(), max_objects=32,
                               device="cpu").build_batch_fn(qc=qc_on)
    return fn(raw, st, sh)


def test_batch_fn_qc_matches_reference(batch):
    result, stats = _port(batch, True)
    fn = JPipeline(j_desc(), max_objects=32).build_batch_fn(jit=False, qc=True)
    ref, ref_stats = fn({k: jnp.asarray(v) for k, v in batch.items()}, {},
                        jnp.zeros((3, 2), jnp.int32))
    assert isinstance(result, SiteResult)
    _assert_same(site_result_to_numpy(result), ref)
    assert sorted(stats) == sorted(ref_stats) == ["Actin", "DAPI"]
    for ch, metrics in ref_stats.items():
        assert_qc({k: v.numpy() for k, v in stats[ch].items()},
                  {k: np.asarray(v) for k, v in metrics.items()})
        assert float(stats["DAPI"]["saturation_frac"][0]) > 0


def test_batch_fn_outputs_bit_identical_with_qc_on_and_off(batch):
    on, _ = _port(batch, True)
    off = _port(batch, False)
    for name in off.objects:
        assert torch.equal(on.objects[name], off.objects[name])
        assert torch.equal(on.counts[name], off.counts[name])
    for obj, feats in off.measurements.items():
        assert sorted(on.measurements[obj]) == sorted(feats)
        for feat, arr in feats.items():
            assert torch.equal(on.measurements[obj][feat], arr), feat


def test_batch_fn_qc_reads_the_raw_images(batch):
    """With correction on, the statistics still describe the raw sites."""
    from tmlibrary_tpu_torch.jterator.description import PipelineDescription

    rng = np.random.default_rng(2)
    size = batch["DAPI"].shape[-1]
    stats = {ch: ((2.5 + 0.05 * rng.random((size, size))).astype(np.float32),
                  (0.2 + 0.02 * rng.random((size, size))).astype(np.float32))
             for ch in ("DAPI", "Actin")}
    pipe = {**benchmarks.CELL_PAINTING_PIPE, "input": {"channels": [
        {"name": "DAPI", "correct": True}, {"name": "Actin", "correct": True}]}}
    raw, st, sh = from_jax_inputs(batch, stats, np.zeros((3, 2)), device="cpu")
    _, got = ImageAnalysisPipeline(PipelineDescription.from_dict(pipe), max_objects=32,
                                   device="cpu").build_batch_fn(qc=True)(raw, st, sh)
    for ch in ("DAPI", "Actin"):
        want = qc.site_qc_stats(raw[ch])
        for k in qc.QC_IMAGE_METRICS:
            assert torch.equal(got[ch][k], want[k])

