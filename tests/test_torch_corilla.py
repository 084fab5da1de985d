"""corilla's numeric core in the port, against the JAX package.

The same sites (made from a seed with numpy, as ``tests/test_stats.py``
makes them: 32 sites of 24x24 and of 64x64) go through
``tmlibrary_tpu.ops.stats`` and ``tmlibrary_tpu_torch.ops.stats`` on the
CPU: ``n``, the histogram and the percentiles bit for bit, the log-domain
fields within ``STATS_TIERS`` (``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import FLAT_TRUTH_TIERS, STATS_TIERS
from tmlibrary_tpu import benchmarks as j_bench
from tmlibrary_tpu.ops import stats as j_stats
from tmlibrary_tpu.ops.smooth import gaussian_smooth as j_gaussian
from tmlibrary_tpu_torch import benchmarks
from tmlibrary_tpu_torch.errors import DeviceError
from tmlibrary_tpu_torch.ops import stats

torch.set_num_threads(1)

EXACT_KEYS = ("n", "hist", "percentile_keys", "percentile_values")


def _stack(size, seed=42, sites=32):
    rng = np.random.default_rng(seed)
    base = rng.integers(200, 2000, size=(size, size)).astype(np.float32)
    noise = rng.normal(0, 50, size=(sites, size, size)).astype(np.float32)
    return np.clip(base[None] + noise, 0, 65535)


def _flat():
    """The nearly flat channel of ``tests/test_stats.py``: a large common
    value, jitter of half a count (log-domain std ~4e-6)."""
    rng = np.random.default_rng(7)
    return (60000.0 + rng.normal(0.0, 0.5, (16, 16, 16))).astype(np.float32)


def _port(out):
    return {k: v.numpy() for k, v in out.items()}


def _ref(out):
    return {k: np.asarray(v) for k, v in out.items()}


def assert_stats(got, want):
    assert sorted(got) == sorted(want)
    for k in EXACT_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, (rtol, atol) in STATS_TIERS.items():
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def _port_scan(a):
    return stats.welford_scan(torch.from_numpy(np.ascontiguousarray(a)))


def _ref_scan(a):
    return j_stats.welford_scan(jnp.asarray(a))


@pytest.fixture(scope="module", params=[24, 64])
def stack(request):
    return _stack(request.param)


def test_scan_finalize_matches_reference(stack):
    assert_stats(_port(stats.welford_finalize(_port_scan(stack))),
                 _ref(j_stats.welford_finalize(_ref_scan(stack))))


def test_update_step_matches_reference(stack):
    """One update from the empty state and one more: ``n``, ``offset`` and
    the histogram exact, ``mean``/``m2`` within the log10 tier."""
    p = stats.welford_init(stack.shape[1:], device="cpu")
    r = j_stats.welford_init(stack.shape[1:])
    for s in range(2):
        p = stats.welford_update(p, torch.from_numpy(stack[s]))
        r = j_stats.welford_update(r, jnp.asarray(stack[s]))
    np.testing.assert_array_equal(p.n.numpy(), np.asarray(r.n))
    np.testing.assert_array_equal(p.hist.numpy(), np.asarray(r.hist))
    atol = STATS_TIERS["mean_log"][1]
    for f in ("mean", "m2", "offset"):
        np.testing.assert_allclose(getattr(p, f).numpy(), np.asarray(getattr(r, f)),
                                   rtol=0, atol=atol, err_msg=f)


@pytest.mark.parametrize("split", [1, 20, 31])
@pytest.mark.parametrize("order", ["ab", "ba"])
def test_merge_matches_reference(stack, split, order):
    pa, pb = _port_scan(stack[:split]), _port_scan(stack[split:])
    ra, rb = _ref_scan(stack[:split]), _ref_scan(stack[split:])
    if order == "ba":
        pa, pb, ra, rb = pb, pa, rb, ra
    assert_stats(_port(stats.welford_finalize(stats.welford_merge(pa, pb))),
                 _ref(j_stats.welford_finalize(j_stats.welford_merge(ra, rb))))


@pytest.mark.parametrize("side", ["left", "right"])
def test_merge_with_an_empty_side_is_exact(stack, side):
    full = _port_scan(stack)
    empty = stats.welford_init(stack.shape[1:], device="cpu")
    merged = stats.welford_merge(empty, full) if side == "left" else stats.welford_merge(full, empty)
    for got, want in zip(merged, full):
        assert torch.equal(got, want)
    r_full = _ref_scan(stack)
    r_empty = j_stats.welford_init(stack.shape[1:])
    r_merged = (j_stats.welford_merge(r_empty, r_full) if side == "left"
                else j_stats.welford_merge(r_full, r_empty))
    assert_stats(_port(stats.welford_finalize(merged)),
                 _ref(j_stats.welford_finalize(r_merged)))


def test_nearly_flat_channel():
    flat = _flat()
    got = _port(stats.welford_finalize(_port_scan(flat)))
    assert_stats(got, _ref(j_stats.welford_finalize(_ref_scan(flat))))
    # the shift keeps the variance: float64 truth as in tests/test_stats.py
    logs = np.log10(1.0 + flat.astype(np.float64))
    assert np.all(got["std_log"] > 0)
    truth = {"mean_log": logs.mean(0), "std_log": logs.std(0)}
    for k, (rtol, atol) in FLAT_TRUTH_TIERS.items():
        np.testing.assert_allclose(got[k], truth[k], rtol=rtol, atol=atol, err_msg=k)


def test_percentiles_exact_for_integers():
    img = np.arange(1000, dtype=np.float32).reshape(1, 25, 40)
    got = _port(stats.welford_finalize(_port_scan(img)))
    vals = dict(zip(got["percentile_keys"].tolist(), got["percentile_values"].tolist()))
    assert vals[50.0] == 499.0 and vals[99.0] == 989.0 and vals[1.0] == 9.0
    assert_stats(got, _ref(j_stats.welford_finalize(_ref_scan(img))))


@pytest.mark.parametrize("chunk", [5, 7, 32, 100])
def test_corilla_step_order_matches_reference(stack, chunk):
    """The step's order: scans of ``chunk`` sites merged in chunk order."""
    state = None
    for start in range(0, len(stack), chunk):
        part = _ref_scan(stack[start : start + chunk])
        state = part if state is None else j_stats.welford_merge(state, part)
    want = _ref(j_stats.welford_finalize(state))
    got = _port(stats.corilla_statistics(torch.from_numpy(stack), chunk_size=chunk))
    assert_stats(got, want)


def test_corilla_step_smoothing_matches_reference(stack):
    got = _port(stats.corilla_statistics(torch.from_numpy(stack), smooth_sigma=2.0))
    want = _ref(j_stats.welford_finalize(_ref_scan(stack)))
    for k in ("mean_log", "std_log"):
        want[k] = np.asarray(j_gaussian(want[k], 2.0))
    assert_stats(got, want)


def test_corilla_step_on_no_sites():
    got = _port(stats.corilla_statistics(torch.zeros((0, 8, 8))))
    want = _ref(j_stats.welford_finalize(j_stats.welford_init((8, 8))))
    assert_stats(got, want)


def test_channel_batched_scan(stack):
    """A ``(C, S, H, W)`` stack in one scan equals each channel alone, bit
    for bit, and the reference's ``vmap`` over channels within the tier."""
    chans = np.stack([stack, stack[::-1] * 0.5, _stack(stack.shape[-1], seed=9)])
    batched = _port(stats.welford_finalize(_port_scan(chans)))
    for c in range(len(chans)):
        alone = _port(stats.welford_finalize(_port_scan(chans[c])))
        for k, v in alone.items():
            np.testing.assert_array_equal(batched[k][c], v, err_msg=k)
    ref = jax.vmap(lambda s: j_stats.welford_finalize(j_stats.welford_scan(s)))(
        jnp.asarray(chans))
    assert_stats(batched, _ref(ref))
    chunked = _port(stats.corilla_statistics(torch.from_numpy(chans), chunk_size=7))
    for c in range(len(chans)):
        alone = _port(stats.corilla_statistics(torch.from_numpy(chans[c]), chunk_size=7))
        for k, v in alone.items():
            np.testing.assert_array_equal(chunked[k][c], v, err_msg=k)


def test_state_carried_across(stack):
    """A JAX-scanned half merged with a port-scanned half: within the tier
    of either scan of the whole; a carried state finalizes bit for bit."""
    half = len(stack) // 2
    r_head = _ref_scan(stack[:half])
    carried = stats.state_from_numpy(r_head, device="cpu")
    assert [f for f in carried._fields] == list(j_stats.WelfordState._fields)
    for got, want in zip(carried, r_head):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.float32
    for k, v in _ref(j_stats.welford_finalize(r_head)).items():
        np.testing.assert_array_equal(_port(stats.welford_finalize(carried))[k], v, err_msg=k)
    mixed = _port(stats.welford_finalize(
        stats.welford_merge(carried, _port_scan(stack[half:]))))
    assert_stats(mixed, _ref(j_stats.welford_finalize(_ref_scan(stack))))
    assert_stats(mixed, _port(stats.welford_finalize(_port_scan(stack))))


def test_cpu_reference_channel_and_stack_are_the_references():
    np.testing.assert_array_equal(benchmarks.synthetic_channel_stack(2, 3, 16, seed=4),
                                  j_bench.synthetic_channel_stack(2, 3, 16, seed=4))
    sites = benchmarks.synthetic_channel_stack(1, 6, 24, seed=1)[0]
    got, want = benchmarks.cpu_reference_channel(sites), j_bench.cpu_reference_channel(sites)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the port's float32 scan against the float64 numpy job
    port = _port(stats.welford_finalize(_port_scan(sites)))
    np.testing.assert_array_equal(port["hist"], got["hist"].astype(np.float32))
    np.testing.assert_allclose(port["mean_log"], got["mean_log"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port["std_log"], got["std_log"], rtol=1e-4, atol=1e-6)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(DeviceError):
        stats.welford_init((4, 4))
    with pytest.raises(DeviceError):
        stats.state_from_numpy(j_stats.welford_init((4, 4)))


def test_smoke_holds_gate_the_card_run():
    """``chip_smoke.hold_stats`` passes equal statistics and fails on a
    count that differs or a field beyond its tier; an exact hold fails on
    equal values of another shape or dtype."""
    from chip_smoke import _EXACT, SmokeFailure, hold_stats, hold_tier

    out = stats.welford_finalize(_port_scan(_stack(24)))
    assert all(v == 0.0 for v in hold_stats("same", out, out).values())
    off = dict(out, hist=out["hist"].clone())
    off["hist"][7] += 1
    with pytest.raises(SmokeFailure):
        hold_stats("hist", off, out)
    far = dict(out, mean_log=out["mean_log"] + 1e-5)
    with pytest.raises(AssertionError):
        hold_stats("mean_log", far, out)
    # a lost channel axis broadcasts against every channel: not a pass
    one = out["mean_log"][None]
    with pytest.raises(SmokeFailure):
        hold_tier("shape", one, torch.cat([one, one]), _EXACT)
    with pytest.raises(SmokeFailure):
        hold_tier("dtype", out["hist"].double(), out["hist"], _EXACT)
    assert hold_tier("same", out["hist"], out["hist"].clone(), _EXACT) == 0.0
