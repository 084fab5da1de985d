"""The reduction-strategy layer of the port against the JAX package.

The contract of ``tests/test_reduction.py`` held on the port
(``tmlibrary_tpu_torch/ops/reduction.py``, ``ops/measure.py``): ``sort``
and ``scatter`` bit-identical on the CPU, absent-segment identities,
unknown names raise, integral sums bit-identical across the four
strategies and fractional ones within 1e-6, ``sort`` deterministic,
min/max, quantiles and GLCMs bit-identical, the resolver's order and
the build-time pin.  Then each strategy of the port against the same
strategy of the JAX package on the same arrays (a batch of three sites
against the reference one site at a time), and config 3 built with each
strategy against the reference's ``build_batch_fn(jit=False,
reduction_strategy=s)``: labels and counts bit for bit, features within
``FEATURE_TIERS``.  Last, ``workflow submit --reduction-strategy``
runs the named strategy and keys the perf store by it.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import FEATURE_TIERS, feature_tier
from tmlibrary_tpu.benchmarks import cell_painting_description as j_desc
from tmlibrary_tpu.jterator.pipeline import ImageAnalysisPipeline as JPipeline
from tmlibrary_tpu.ops import measure as jm
from tmlibrary_tpu.ops import reduction as jr
from tmlibrary_tpu_torch import benchmarks
from tmlibrary_tpu_torch.jterator.pipeline import (
    ImageAnalysisPipeline,
    from_jax_inputs,
    site_result_to_numpy,
)
from tmlibrary_tpu_torch.ops import measure as tm
from tmlibrary_tpu_torch.ops import reduction as R

torch.set_num_threads(1)

MAX_OBJECTS = 11
STRATEGIES = R.STRATEGIES
B, SIZE = 3, 64


@pytest.fixture(autouse=True)
def no_request(monkeypatch, tmp_path):
    """No setting and no tuning verdict: ``auto`` is the default."""
    monkeypatch.delenv("TM_REDUCTION_STRATEGY", raising=False)
    monkeypatch.delenv("TMX_REDUCTION_STRATEGY", raising=False)
    monkeypatch.setenv("TMX_TUNING_JSON", str(tmp_path / "absent" / "TUNING.json"))


@pytest.fixture(scope="module")
def sites():
    """(labels, uint16-valued image, fractional image) of three 64x64
    sites holding 11, 10 and 9 square objects."""
    rng = np.random.default_rng(7)
    labels = np.zeros((B, SIZE, SIZE), np.int32)
    for b in range(B):
        ys = rng.integers(4, SIZE - 4, MAX_OBJECTS - b)
        xs = rng.integers(4, SIZE - 4, MAX_OBJECTS - b)
        for i, (y, x) in enumerate(zip(ys, xs), start=1):
            labels[b, max(0, y - 3): y + 3, max(0, x - 3): x + 3] = i
    integral = rng.integers(0, 4096, (B, SIZE, SIZE)).astype(np.float32)
    fractional = rng.random((B, SIZE, SIZE), np.float32) * 1000.0
    return labels, integral, fractional


def t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def per_site(fn, *arrays):
    """The reference one site at a time, stacked like the port's batch
    (a tuple or dict result stacked field by field)."""
    outs = [fn(*(jnp.asarray(a[b]) for a in arrays)) for b in range(arrays[0].shape[0])]
    if isinstance(outs[0], dict):
        return {k: np.stack([np.asarray(o[k]) for o in outs]) for k in outs[0]}
    if isinstance(outs[0], (tuple, list)):
        return [np.stack([np.asarray(o[i]) for o in outs]) for i in range(len(outs[0]))]
    return np.stack([np.asarray(o) for o in outs])


def assert_feature(name, got, want):
    rtol, atol = feature_tier(name, FEATURE_TIERS)
    if rtol == atol == 0.0:
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


# ------------------------------------------------------------- primitives
@pytest.mark.parametrize("fn", [R.segmented_sum, R.segmented_min, R.segmented_max])
def test_primitives_sort_scatter_bit_identical(fn):
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, 9, 4096))
    vals = torch.from_numpy(rng.random((4096, 3), np.float32))
    np.testing.assert_array_equal(fn(vals, ids, 10, "sort").numpy(),
                                  fn(vals, ids, 10, "scatter").numpy())
    np.testing.assert_array_equal(fn(vals[:, 1], ids, 10, "sort").numpy(),
                                  fn(vals, ids, 10, "scatter")[:, 1].numpy())


@pytest.mark.parametrize("strategy", ["sort", "scatter"])
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_primitives_equal_the_reference(kind, strategy):
    """The same ids and float32 values give the reference's minima and
    maxima bit for bit; the sums, which the port adds in float64 and the
    reference in float32, within 1e-6 of the reference's and bit for bit
    the float64 sums rounded once."""
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 12, 5000).astype(np.int32)
    vals = (rng.random((5000, 2), np.float32) * 1000.0).astype(np.float32)
    got = getattr(R, f"segmented_{kind}")(*t(vals, ids), 13, strategy)
    want = getattr(jr, f"segmented_{kind}")(jnp.asarray(vals), jnp.asarray(ids), 13, strategy)
    if kind != "sum":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    exact = np.stack([np.bincount(ids, weights=vals[:, c].astype(np.float64), minlength=13)
                      for c in range(2)], axis=1).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), exact)


def test_primitives_absent_segment_identities():
    vals = torch.rand(100)
    ids = torch.zeros(100, dtype=torch.int64)
    for strategy in ("sort", "scatter"):
        assert bool((R.segmented_min(vals, ids, 3, strategy)[1:] == np.inf).all())
        assert bool((R.segmented_max(vals, ids, 3, strategy)[1:] == -np.inf).all())
        assert bool((R.segmented_sum(vals, ids, 3, strategy)[1:] == 0.0).all())


def test_primitives_drop_ids_outside_the_segments():
    vals = torch.tensor([1.0, 2.0, 4.0, 8.0])
    ids = torch.tensor([0, 3, -1, 1])
    for strategy in ("sort", "scatter"):
        assert R.segmented_sum(vals, ids, 2, strategy).tolist() == [1.0, 8.0]
        assert R.segmented_max(vals, ids, 2, strategy).tolist() == [1.0, 8.0]


def test_unknown_strategy_raises():
    vals, ids = torch.ones(8), torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError):
        R.segmented_sum(vals, ids, 2, "onehot")  # no generic one-hot form
    with pytest.raises(ValueError):
        R.resolve_reduction_strategy("bogus")
    with pytest.raises(ValueError):
        R.strategy_scope("bogus").__enter__()
    lab = torch.zeros((1, 4, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        tm.grouped_sums(lab, [lab.float()], 2, "native")


def test_sort_by_segment_is_stable():
    ids = torch.tensor([2, 0, 2, 1, 0])
    vals = torch.arange(5.0)
    sorted_ids, sorted_vals = R.sort_by_segment(ids, vals)
    assert sorted_ids.tolist() == [0, 0, 1, 2, 2]
    assert sorted_vals.tolist() == [1.0, 4.0, 3.0, 0.0, 2.0]


# -------------------------------------------------------- measure parity
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_grouped_sums_integral_bit_identical(sites, strategy):
    """uint16-valued pixels: per-object sums below 2^24 are exact in
    float32, so every strategy equals the one-hot product bit for bit."""
    lab, integral, _ = t(*sites)
    ref = tm.grouped_sums(lab, [integral, integral * 2.0], MAX_OBJECTS, "matmul")
    out = tm.grouped_sums(lab, [integral, integral * 2.0], MAX_OBJECTS, strategy)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


def test_grouped_sums_fp32_tolerance_contract(sites):
    """Fractional values: sort and scatter add in pixel order in float64,
    bit for bit alike and equal to the float64 sums rounded once; fused
    (float32) and the one-hot product within 1e-6 of them."""
    lab, _, frac = t(*sites)
    srt = tm.grouped_sums(lab, [frac], MAX_OBJECTS, "sort").numpy()
    np.testing.assert_array_equal(srt, tm.grouped_sums(lab, [frac], MAX_OBJECTS,
                                                       "scatter").numpy())
    labels, _, frac_np = sites
    exact = np.stack([np.bincount(labels[b].ravel(), weights=frac_np[b].ravel().astype(
        np.float64), minlength=MAX_OBJECTS + 1)[1:] for b in range(B)]).astype(np.float32)
    np.testing.assert_array_equal(srt[..., 0], exact)
    for other in ("onehot", "fused"):
        np.testing.assert_allclose(srt, tm.grouped_sums(lab, [frac], MAX_OBJECTS,
                                                        other).numpy(), rtol=1e-6)


def test_sort_path_exactly_deterministic(sites):
    lab, _, frac = t(*sites)
    a = tm.grouped_sums(lab, [frac, frac * frac], MAX_OBJECTS, "sort")
    b = tm.grouped_sums(lab, [frac, frac * frac], MAX_OBJECTS, "sort")
    assert torch.equal(a, b)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_grouped_minmax_bit_identical(sites, strategy):
    lab, _, frac = t(*sites)
    mn_r, mx_r = tm.grouped_minmax(lab, frac, MAX_OBJECTS, "reduce")
    mn, mx = tm.grouped_minmax(lab, frac, MAX_OBJECTS, strategy)
    assert torch.equal(mn, mn_r) and torch.equal(mx, mx_r)
    assert bool((mn[-1, -2:] == np.inf).all())  # the third site's absent ids


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_grouped_minmax_multi_bit_identical(sites, strategy):
    lab, integral, frac = t(*sites)
    mn_r, mx_r = tm.grouped_minmax_multi(lab, [integral, frac], MAX_OBJECTS, "reduce")
    mn, mx = tm.grouped_minmax_multi(lab, [integral, frac], MAX_OBJECTS, strategy)
    assert torch.equal(mn, mn_r) and torch.equal(mx, mx_r)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_intensity_quantiles_bit_identical(sites, strategy):
    lab, integral, _ = t(*sites)
    ref = tm.intensity_quantiles(lab, integral, MAX_OBJECTS, method="onehot")
    out = tm.intensity_quantiles(lab, integral, MAX_OBJECTS, method=strategy)
    assert set(out) == set(ref)
    for key in ref:
        assert torch.equal(out[key], ref[key]), key


@pytest.mark.parametrize("quantization", ["object", "global"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_haralick_bit_identical(sites, strategy, quantization):
    """GLCM cells are integer counts and every feature the same float32
    expression tree over them: bit-exact across the strategies."""
    lab, integral, _ = t(*sites)
    ref = tm.haralick_features(lab, integral, MAX_OBJECTS, levels=8, glcm_method="matmul",
                               quantization=quantization)
    out = tm.haralick_features(lab, integral, MAX_OBJECTS, levels=8, glcm_method=strategy,
                               quantization=quantization)
    assert set(out) == set(ref)
    for key in ref:
        assert torch.equal(out[key], ref[key]), key


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_capacity_invariance(sites, strategy):
    """Rows 1..n do not depend on the capacity above n."""
    lab, integral, frac = t(*sites)
    small = tm.grouped_sums(lab, [integral, frac], MAX_OBJECTS, strategy)
    big = tm.grouped_sums(lab, [integral, frac], 3 * MAX_OBJECTS, strategy)[:, :MAX_OBJECTS]
    if strategy == "onehot":
        np.testing.assert_allclose(big.numpy(), small.numpy(), rtol=1e-6)
    else:
        assert torch.equal(big, small)


def test_onehot_blocks_span_sites_and_pixels(sites, monkeypatch):
    """A block smaller than a site cuts it into runs; a larger one takes
    several sites at once: the same sums and counts either way."""
    lab, integral, _ = t(*sites)
    want = tm.grouped_sums(lab, [integral], MAX_OBJECTS, "onehot")
    hist = tm.intensity_quantiles(lab, integral, MAX_OBJECTS, method="onehot")
    glcm = tm.haralick_features(lab, integral, MAX_OBJECTS, levels=8, glcm_method="onehot")
    assert [len(list(tm._blocks(B, SIZE * SIZE, c))) for c in (1000, 1 << 13)] == [15, 2]
    monkeypatch.setattr(tm, "SUM_CHUNK", 1000)
    monkeypatch.setattr(tm, "GLCM_CHUNK", 999)
    assert torch.equal(tm.grouped_sums(lab, [integral], MAX_OBJECTS, "onehot"), want)
    assert all(torch.equal(a, b) for a, b in zip(
        tm.intensity_quantiles(lab, integral, MAX_OBJECTS, method="onehot").values(),
        hist.values()))
    assert all(torch.equal(a, b) for a, b in zip(
        tm.haralick_features(lab, integral, MAX_OBJECTS, levels=8,
                             glcm_method="onehot").values(), glcm.values()))


def test_onehot_sums_ignore_the_matmul_precision(sites):
    """The sums' one-hot product runs in float64, where TF32 and the
    reduced-precision float32 settings do not apply."""
    lab, integral, frac = t(*sites)
    want = tm.grouped_sums(lab, [integral, frac], MAX_OBJECTS, "onehot")
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        got = tm.grouped_sums(lab, [integral, frac], MAX_OBJECTS, "onehot")
    finally:
        torch.set_float32_matmul_precision(before)
    assert torch.equal(got, want)


# ----------------------------------------------- the port vs the reference
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_grouped_sums_equal_the_reference(sites, strategy):
    labels, integral, frac = sites
    got = tm.grouped_sums(*t(labels), t(integral, frac), MAX_OBJECTS, strategy).numpy()
    want = per_site(lambda lab, i, f: jm.grouped_sums(lab, [i, f], MAX_OBJECTS, strategy),
                    labels, integral, frac)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1], want[..., 1], rtol=1e-6)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_grouped_minmax_equal_the_reference(sites, strategy):
    labels, integral, frac = sites
    mn, mx = tm.grouped_minmax_multi(*t(labels), t(integral, frac), MAX_OBJECTS, strategy)
    want = per_site(lambda lab, i, f: jm.grouped_minmax_multi(lab, [i, f], MAX_OBJECTS,
                                                              strategy),
                    labels, integral, frac)
    np.testing.assert_array_equal(mn.numpy(), want[0])
    np.testing.assert_array_equal(mx.numpy(), want[1])
    mn1, mx1 = tm.grouped_minmax(*t(labels, frac), MAX_OBJECTS, strategy)
    want1 = per_site(lambda lab, f: jm.grouped_minmax(lab, f, MAX_OBJECTS, strategy),
                     labels, frac)
    np.testing.assert_array_equal(mn1.numpy(), want1[0])
    np.testing.assert_array_equal(mx1.numpy(), want1[1])


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_intensity_quantiles_equal_the_reference(sites, strategy):
    labels, integral, frac = sites
    for img in (integral, frac):
        got = tm.intensity_quantiles(*t(labels, img), MAX_OBJECTS, method=strategy)
        want = per_site(lambda lab, i: jm.intensity_quantiles(lab, i, MAX_OBJECTS,
                                                              method=strategy), labels, img)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("strategy", ["onehot", "sort", "scatter"])
def test_glcm_counts_equal_the_reference(sites, strategy):
    """The GLCM routes' counts, cell for cell, on the reference's own
    per-object quantisation."""
    labels, integral, _ = sites
    levels, offsets = 8, [(0, 1), (1, 0), (1, 1), (1, -1)]
    q = per_site(lambda lab, i: jm.quantize_per_object(lab, i, MAX_OBJECTS, levels),
                 labels, integral)
    lab, qt = t(labels, q)
    if strategy == "onehot":
        got = tm._glcm_matmul_all(lab, qt.to(torch.int64), MAX_OBJECTS, levels, offsets)
        want = per_site(lambda a, b: jm._glcm_matmul_all(a, b, MAX_OBJECTS, levels, offsets),
                        labels, q)
    else:
        got = [tm._glcm_scatter(lab, qt, MAX_OBJECTS, levels, off, strategy)
               for off in offsets]
        want = [per_site(lambda a, b: jm._glcm_scatter(a, b, MAX_OBJECTS, levels, off,
                                                       strategy), labels, q)
                for off in offsets]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(tm.quantize_per_object(lab, t(integral)[0], MAX_OBJECTS,
                                                         levels).numpy(), q)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_feature_families_equal_the_reference(sites, strategy):
    """intensity, morphology and Haralick under each strategy's pin, in
    both packages, within the features' tiers."""
    labels, integral, frac = sites
    with R.strategy_scope(strategy), jr.strategy_scope(strategy):
        got = {**tm.intensity_features(*t(labels, frac), MAX_OBJECTS),
               **tm.morphology_features(*t(labels), MAX_OBJECTS),
               **tm.haralick_features(*t(labels, integral), MAX_OBJECTS, levels=8)}
        want = {
            **per_site(lambda lab, f: jm.intensity_features(
                lab, f, MAX_OBJECTS, method="fused" if strategy == "fused" else "xla"),
                labels, frac),
            **per_site(lambda lab: jm.morphology_features(lab, MAX_OBJECTS), labels),
            **per_site(lambda lab, i: jm.haralick_features(lab, i, MAX_OBJECTS, levels=8),
                       labels, integral)}
    assert sorted(got) == sorted(want)
    counts = labels.reshape(B, -1).max(axis=1)
    for k in want:
        for s, n in enumerate(counts):
            assert_feature(k, got[k].numpy()[s, :n], want[k][s, :n])


# ---------------------------------------------------------------- resolver
def test_resolver_default_is_fused():
    assert R.resolve_reduction_strategy() == "fused"
    assert R.explicit_reduction_request() is None


def test_resolver_explicit_method_wins(monkeypatch):
    monkeypatch.setenv("TM_REDUCTION_STRATEGY", "sort")
    assert R.resolve_reduction_strategy("onehot") == "onehot"
    assert R.resolve_reduction_strategy() == "sort"


def test_resolver_setting_beats_the_tuning_verdict(monkeypatch, tmp_path):
    path = tmp_path / "TUNING.json"
    path.write_text(json.dumps({"written_by": "bench.py --sweep",
                                "reduction_strategy": {"cuda": "scatter", "cpu": "sort"}}))
    monkeypatch.setenv("TMX_TUNING_JSON", str(path))
    assert R.resolve_reduction_strategy() == "scatter"  # the cuda-scoped verdict
    assert R.resolve_reduction_strategy("auto", "cpu") == "sort"
    monkeypatch.setenv("TM_REDUCTION_STRATEGY", "onehot")
    assert R.resolve_reduction_strategy() == "onehot"
    # the reference's env knob is not read by the port
    monkeypatch.delenv("TM_REDUCTION_STRATEGY")
    monkeypatch.setenv("TMX_REDUCTION_STRATEGY", "sort")
    assert R.resolve_reduction_strategy() == "scatter"


def test_resolver_ignores_a_verdict_of_another_backend(monkeypatch, tmp_path):
    path = tmp_path / "TUNING.json"
    path.write_text(json.dumps({"written_by": "bench.py --sweep", "backend": "tpu",
                                "reduction_strategy": "onehot"}))
    monkeypatch.setenv("TMX_TUNING_JSON", str(path))
    assert R.resolve_reduction_strategy() == "fused"
    path.write_text(json.dumps({"written_by": "bench.py --sweep",
                                "reduction_strategy": {"cuda": "quantum"}}))
    assert R.resolve_reduction_strategy() == "fused"  # malformed: ignored


def test_resolver_invalid_setting_is_loud(monkeypatch):
    monkeypatch.setenv("TM_REDUCTION_STRATEGY", "fastest")
    with pytest.raises(ValueError):
        R.resolve_reduction_strategy()


def test_strategy_scope_freezes_resolution(monkeypatch):
    with R.strategy_scope("sort"):
        monkeypatch.setenv("TM_REDUCTION_STRATEGY", "onehot")
        assert R.resolve_reduction_strategy() == "sort"
        with R.strategy_scope("scatter"):
            assert R.resolve_reduction_strategy() == "scatter"
        assert R.resolve_reduction_strategy() == "sort"
    assert R.resolve_reduction_strategy() == "onehot"


def test_strategy_scope_none_pins_no_request(monkeypatch):
    monkeypatch.setenv("TM_REDUCTION_STRATEGY", "sort")
    with R.strategy_scope(None):
        assert R.explicit_reduction_request() is None
        assert R.resolve_reduction_strategy() == "fused"
        assert tm._resolve_glcm_method("auto") == "fused"


def test_glcm_dispatch_follows_explicit_request(monkeypatch):
    """GLCM's ``auto`` resolves as every other measure's: the request in
    effect, else ``fused`` (the reference's is ``scatter`` on the CPU)."""
    monkeypatch.setenv("TM_REDUCTION_STRATEGY", "sort")
    assert tm._resolve_glcm_method("auto") == "sort"
    monkeypatch.setenv("TM_REDUCTION_STRATEGY", "onehot")
    assert tm._resolve_glcm_method("auto") == "matmul"
    assert tm._resolve_glcm_method("onehot") == "matmul"
    assert tm._resolve_glcm_method("scatter") == "scatter"
    monkeypatch.delenv("TM_REDUCTION_STRATEGY")
    assert tm._resolve_glcm_method("auto") == "fused"
    with R.strategy_scope("scatter"):
        assert tm._resolve_glcm_method("auto") == "scatter"
    with R.strategy_scope("fused"):
        assert tm._resolve_glcm_method("auto") == "fused"
    assert jm._resolve_glcm_method("auto") == "scatter"


# --------------------------------------------------------- the pipeline
@pytest.fixture(scope="module")
def config3():
    return benchmarks.synthetic_cell_painting_batch(4, size=64, seed=3)


def run_port(data, strategy):
    n = next(iter(data.values())).shape[0]
    raw, st, sh = from_jax_inputs(data, {}, np.zeros((n, 2)), device="cpu")
    fn = ImageAnalysisPipeline(benchmarks.cell_painting_description(), max_objects=32,
                               device="cpu").build_batch_fn(reduction_strategy=strategy)
    return fn, site_result_to_numpy(fn(raw, st, sh))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_config3_equals_the_reference_per_strategy(config3, strategy, monkeypatch):
    """Config 3 built with each strategy: the port against the
    reference's ``build_batch_fn(jit=False)`` of the same strategy, and
    the kernels' functions called only on ``fused``."""
    calls = {"grouped_stats": 0}
    real = tm.grouped_stats

    def counted(*args, **kwargs):
        calls["grouped_stats"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(tm, "grouped_stats", counted)
    fn, port = run_port(config3, strategy)
    assert fn.reduction_strategy == strategy
    assert (calls["grouped_stats"] > 0) == (strategy == "fused")
    n = next(iter(config3.values())).shape[0]
    ref = JPipeline(j_desc(), max_objects=32).build_batch_fn(
        jit=False, reduction_strategy=strategy)(
        {k: jnp.asarray(v) for k, v in config3.items()}, {}, jnp.zeros((n, 2), jnp.int32))
    for name in ref.objects:
        np.testing.assert_array_equal(port.objects[name], np.asarray(ref.objects[name]))
        np.testing.assert_array_equal(port.counts[name], np.asarray(ref.counts[name]))
    for obj, feats in ref.measurements.items():
        counts = np.asarray(ref.counts[obj])
        assert sorted(port.measurements[obj]) == sorted(feats)
        for feat, arr in feats.items():
            for s, c in enumerate(counts):
                assert_feature(feat, port.measurements[obj][feat][s, :c],
                               np.asarray(arr)[s, :c])


def test_build_batch_fn_pins_its_strategy(config3, monkeypatch):
    """``auto`` resolves once, at build: a setting changed later moves
    nothing, and a new build follows it."""
    fn, first = run_port(config3, None)
    assert fn.reduction_strategy == "fused"
    monkeypatch.setenv("TM_REDUCTION_STRATEGY", "scatter")
    n = next(iter(config3.values())).shape[0]
    raw, st, sh = from_jax_inputs(config3, {}, np.zeros((n, 2)), device="cpu")
    again = site_result_to_numpy(fn(raw, st, sh))
    for obj in first.measurements:
        for feat in first.measurements[obj]:
            np.testing.assert_array_equal(again.measurements[obj][feat],
                                          first.measurements[obj][feat])
    assert run_port(config3, "auto")[0].reduction_strategy == "scatter"
    assert run_port(config3, "sort")[0].reduction_strategy == "sort"


# ----------------------------------------------------- workflow submit
@pytest.fixture(scope="module")
def submitted(tmp_path_factory):
    from test_torch_workflow_steps import CORILLA, JTERATOR, copy_store, make_store
    from tmlibrary_tpu_torch import capacity, cli, perf
    from tmlibrary_tpu_torch.workflow.engine import WorkflowDescription

    base = tmp_path_factory.mktemp("strategies")
    make_store(base / "src")
    WorkflowDescription.canonical({"corilla": CORILLA, "jterator": JTERATOR}).save(
        base / "wf.json")
    keys = {}
    try:
        for name in ("default", "scatter", "sort"):
            copy_store(base / "src", base / name)
            capacity.reset_routing_history()
            perf.reset_profiles()
            extra = [] if name == "default" else ["--reduction-strategy", name]
            assert cli.main(["workflow", "submit", "--root", str(base / name),
                             "--description", str(base / "wf.json"), "--device", "cpu",
                             *extra]) == 0
            keys[name] = {p["strategy"] for p in perf.perf_profiles()
                          if p["step"] == "jterator"}
    finally:
        capacity.reset_routing_history()
        perf.reset_profiles()
    return base, keys


@pytest.mark.parametrize("name", ["scatter", "sort"])
def test_submit_runs_and_keys_the_named_strategy(submitted, name):
    """``--reduction-strategy`` reaches the batch functions and the perf
    store; the store holds the default (fused) run's labels and rows bit
    for bit and its features within ``FEATURE_TIERS`` (scatter and sort
    sum fractional pixels in float64, the fused plain version in
    float32)."""
    from chip_smoke import hold_batch
    from tmlibrary_tpu_torch.models.store import ExperimentStore

    base, keys = submitted
    assert keys[name] == {name} and keys["default"] == {"fused"}
    got, want = (ExperimentStore.open(base / n) for n in (name, "default"))
    outside, worst = hold_batch(got, want, list(range(want.n_sites)), FEATURE_TIERS,
                                gate=True)
    assert outside == 0 and worst["Intensity"] > 0.0  # another summation, not the same one
