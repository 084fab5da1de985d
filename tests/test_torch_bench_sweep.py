"""The sweep workloads of ``benchmarks.py`` against the JAX package's.

One case per config at a small size (sites of 64², batch 2, z-stacks of
8 planes, 4 corilla sites of 2 channels, a 2x2 well): the port's
``fetch(launch())`` on ``device="cpu"`` equals the host copy of the
reference's ``launch()`` (object counts and corilla's ``n`` exactly, the
pyramid's last uint8 level byte for byte, the spatial step's object
counts), and both workloads carry the same ``n_items``, ``item_unit``
and ``host_synchronous``.  ``close()`` removes the spatial store, an
unknown config raises ``ValueError``, and the default device is the
card: ``DeviceError`` on a host without one.
"""

import numpy as np
import pytest
import torch

from tmlibrary_tpu_torch import benchmarks
from tmlibrary_tpu_torch.errors import DeviceError

torch.set_num_threads(1)

CONFIGS = ("2", "3", "4", "dl", "volume", "corilla", "pyramid", "spatial")
SMALL = dict(size=64, batch=2, zdepth=8, sites=4, channels=2, grid_y=2, grid_x=2)


def _reference_value(config, wl):
    ctx = wl.launch()
    if config == "spatial":
        return ctx["objects"]
    return np.asarray(ctx)


@pytest.mark.parametrize("config", CONFIGS)
def test_sweep_workload_matches_the_reference(config, monkeypatch):
    # the reference's native box mean is only within a tolerance of the XLA
    # taps the port follows (config 2 and the volume path)
    monkeypatch.setenv("TMX_NATIVE", "0")
    from tmlibrary_tpu import benchmarks as ref

    want_wl = ref.sweep_workload(config, **SMALL)
    got_wl = benchmarks.sweep_workload(config, device="cpu", **SMALL)
    try:
        want = _reference_value(config, want_wl)
        got = got_wl.fetch(got_wl.launch())
        for attr in ("n_items", "item_unit", "host_synchronous"):
            assert getattr(got_wl, attr) == getattr(want_wl, attr), attr
        if config == "spatial":
            assert got == want
            assert sum(got.values()) > 0
        else:
            assert isinstance(got, np.ndarray)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
            if config != "pyramid":
                assert got.sum() > 0
        # a second launch reads the same uploaded inputs
        again = got_wl.fetch(got_wl.launch())
        if config == "spatial":
            assert again == got
        else:
            np.testing.assert_array_equal(again, got)
    finally:
        got_wl.close()
        want_wl.close()


@pytest.mark.parametrize("config", CONFIGS)
def test_sweep_workload_units(config):
    wl = benchmarks.sweep_workload(config, device="cpu", **SMALL)
    try:
        want = {"corilla": (2, "channels"), "pyramid": (4 * 64 * 64 / 1e6, "Mpix"),
                "spatial": (4 * 64 * 64 / 1e6, "Mpix")}.get(config, (2, "sites"))
        assert (wl.n_items, wl.item_unit) == want
        assert wl.host_synchronous == (config in benchmarks.SWEEP_HOST_SYNC_CONFIGS)
    finally:
        wl.close()


@pytest.mark.parametrize("grid, size", [((2, 2), 200), ((4, 4), 128), ((3, 2), 100)])
def test_pyramid_levels_below_the_mosaic(grid, size):
    """Mosaics above one tile: the last level is downsampled (odd sides
    edge-padded, both of XLA-CPU's summation orders)."""
    from tmlibrary_tpu import benchmarks as ref

    knobs = {**SMALL, "size": size, "grid_y": grid[0], "grid_x": grid[1]}
    want = np.asarray(ref.sweep_workload("pyramid", **knobs).launch())
    wl = benchmarks.sweep_workload("pyramid", device="cpu", **knobs)
    got = wl.fetch(wl.launch())
    assert got.shape == want.shape and max(got.shape) <= 256 < size * max(grid)
    np.testing.assert_array_equal(got, want)


def test_sweep_tables_match_the_reference():
    from tmlibrary_tpu import benchmarks as ref

    assert benchmarks.SWEEP_REDUCTION_CONFIGS == ref.SWEEP_REDUCTION_CONFIGS
    assert benchmarks.SWEEP_HOST_SYNC_CONFIGS == ref.SWEEP_HOST_SYNC_CONFIGS


def test_close_removes_the_spatial_store(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    wl = benchmarks.sweep_workload("spatial", device="cpu", **SMALL)
    made = [p.name for p in tmp_path.iterdir()]
    assert len(made) == 1 and made[0].startswith("bench_sweep_spatial_")
    assert (tmp_path / made[0] / "exp").is_dir()
    wl.close()
    assert list(tmp_path.iterdir()) == []
    wl.close()  # a second close is harmless


def test_close_without_a_directory_is_a_no_op():
    wl = benchmarks.sweep_workload("corilla", device="cpu", **SMALL)
    wl.close()
    assert wl.fetch(wl.launch()).tolist() == [4.0, 4.0]


@pytest.mark.parametrize("config", ["5", "mesh", "analytics", 3, ""])
def test_an_unknown_config_raises(config):
    with pytest.raises(ValueError, match="no sweep workload for BENCH_CONFIG"):
        benchmarks.sweep_workload(config, device="cpu", **SMALL)


@pytest.mark.parametrize("config", CONFIGS)
def test_the_default_device_is_the_card(config):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(DeviceError):
        benchmarks.sweep_workload(config, **SMALL)


@pytest.mark.parametrize("strategy", [None, "auto", "fused", "onehot", "sort", "scatter"])
def test_a_pinned_strategy_keeps_config_3s_counts(strategy):
    base = benchmarks.sweep_workload("3", device="cpu", **SMALL)
    wl = benchmarks.sweep_workload("3", device="cpu", reduction_strategy=strategy, **SMALL)
    np.testing.assert_array_equal(wl.fetch(wl.launch()), base.fetch(base.launch()))


def test_dl_weights_are_a_keyword(monkeypatch):
    """``dl_weights`` does what the reference's ``BENCH_DL_WEIGHTS`` does."""
    from tmlibrary_tpu import benchmarks as ref

    monkeypatch.setenv("BENCH_DL_WEIGHTS", "seed:1")
    want = np.asarray(ref.sweep_workload("dl", **SMALL).launch())
    got_wl = benchmarks.sweep_workload("dl", device="cpu", dl_weights="seed:1", **SMALL)
    np.testing.assert_array_equal(got_wl.fetch(got_wl.launch()), want)
