"""The A/B harness (``tmlibrary_tpu_torch/shootout.py``) on the CPU.

The harness times only on a card (``chip_smoke.py`` runs it there).  Here:
its yardsticks compute the kernels' functions (a ``bincount`` of the
harness's indices equals the plain histogram, and with its transpose
added the plain GLCM), it refuses to time without a card, the launchers
it times raise for tensors off the card instead of falling back, and a
launcher holds the memory behind every pointer it passes.
"""

import ctypes
import gc
import weakref

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from tmlibrary_tpu_torch import shootout
from tmlibrary_tpu_torch.errors import DeviceError
from tmlibrary_tpu_torch.ops import fused_measure as tfm
from tmlibrary_tpu_torch.ops import kernels as tk
from tmlibrary_tpu_torch.ops import volume as tv
from tmlibrary_tpu_torch.ops.measure import grouped_minmax

torch.set_num_threads(1)

M = 16


@pytest.fixture(scope="module")
def site():
    rng = np.random.default_rng(5)
    smooth = ndi.gaussian_filter(rng.random((2, 48, 48)), (0, 2.0, 2.0))
    lab = np.stack([ndi.label(s > np.quantile(s, 0.5))[0] for s in smooth]).astype(np.int32)
    img = (rng.random((2, 48, 48)) * 1000).astype(np.float32)
    lab, img = torch.from_numpy(lab), torch.from_numpy(img)
    return lab, img, grouped_minmax(lab, img, M)


@pytest.mark.parametrize("bins", [2, 256])
def test_hist_yardstick_counts_the_histogram(site, bins):
    lab, img, bounds = site
    idx = shootout.hist_index(lab, img, M, bins, bounds)
    counted = torch.bincount(idx, minlength=2 * M * bins).reshape(2, M, bins).float()
    assert torch.equal(counted, tfm.intensity_hist_plain(lab, img, M, bins, bounds))


@pytest.mark.parametrize("n_dirs", [1, 4])
def test_glcm_yardstick_counts_the_pairs(site, n_dirs):
    lab, img, bounds = site
    offsets = shootout.OFFSETS[:n_dirs]
    idx = shootout.glcm_index(lab, img, M, 8, offsets, bounds)
    c = torch.bincount(idx, minlength=2 * n_dirs * M * 64).reshape(2, n_dirs, M, 8, 8).float()
    want = torch.stack(tfm.glcm_all_plain(lab, img, M, 8, offsets, bounds), dim=1)
    assert torch.equal(c + c.transpose(-1, -2), want)


def test_bytes_bounds_at_the_main_path_shapes():
    """Inputs read once and outputs written once: 33.5 MB in, 16.8 MB out
    (histogram) and 67 MB out (GLCM) for 64 sites of 256²."""
    n = 256 * 256
    assert shootout.hist_bytes(64, n, 256, 256) == 64 * n * 8 + 2 * 64 * 257 * 4 + 64 * 256 * 1024
    assert shootout.glcm_bytes(64, n, 256, 16, 4) - 64 * n * 8 - 2 * 64 * 257 * 4 == 4 * 64 * 256 * 1024


def test_harness_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        shootout.best_of({"noop": lambda: None})


@pytest.mark.parametrize("name", ["hist", "glcm", "hist_atomic", "glcm_atomic"])
def test_launchers_raise_off_the_card(name):
    """Every launcher the harness times checks the device before it
    touches the kernel library: tensors off the card raise."""
    lab = torch.zeros((1, 8, 8), dtype=torch.int32, device="meta")
    img = torch.zeros((1, 8, 8), device="meta")
    bounds = (torch.zeros((1, 4), device="meta"), torch.ones((1, 4), device="meta"))
    make = {
        "hist": lambda: tfm.intensity_hist_launcher(lab, img, 4, 16, bounds),
        "glcm": lambda: tfm.glcm_all_launcher(lab, img, 4, 8, shootout.OFFSETS, bounds),
        "hist_atomic": lambda: shootout.intensity_hist_atomic(lab, img, 4, 16, bounds),
        "glcm_atomic": lambda: shootout.glcm_all_atomic(lab, img, 4, 8, shootout.OFFSETS,
                                                        bounds),
    }[name]
    with pytest.raises(DeviceError):
        make()


class _RecordingLib:
    """Stands in for the kernel library: every entry point records its
    arguments and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or 0


@pytest.mark.parametrize("name", ["hist", "glcm", "hist_atomic", "glcm_atomic", "watershed",
                                  "watershed_global", "fill", "fill_global"])
def test_launchers_hold_the_memory_they_pass(monkeypatch, name):
    """The harness builds every launcher first and times them later, while
    other variants allocate: a launcher must hold each tensor whose
    pointer it passes (the converted inputs, the derived bounds, the
    output) after the caller drops its own, and free them when it goes."""
    lib = _RecordingLib()
    monkeypatch.setattr(tfm._cuda, "require_cuda", lambda *tensors: None)
    monkeypatch.setattr(tfm._cuda, "lib", lambda: lib)
    monkeypatch.setattr(tfm._cuda, "stream", lambda: 0)
    monkeypatch.setattr(tfm.intensity_hist, "launches", 0)
    monkeypatch.setattr(tfm.glcm_all, "launches", 0)
    monkeypatch.setattr(tk.watershed_flood, "launches", 0)
    monkeypatch.setattr(tk.fill_holes_flood, "launches", 0)
    passed = []
    data_ptr = torch.Tensor.data_ptr

    def recording(t):
        passed.append(weakref.ref(t))
        return data_ptr(t)

    monkeypatch.setattr(torch.Tensor, "data_ptr", recording)
    # int64 labels and float64 values and bounds: every tensor the
    # launcher passes is one it made, which nothing but it can hold
    lab = torch.ones((1, 8, 8), dtype=torch.int64)
    img = torch.rand((1, 8, 8), dtype=torch.float64)
    bounds = (torch.zeros((1, 4), dtype=torch.float64),
              torch.ones((1, 4), dtype=torch.float64))
    # (a uint8 mask: the flood launchers' bool masks are theirs too)
    mask = torch.ones((1, 8, 8), dtype=torch.uint8)
    glob = tk.FloodPlan("global")
    launch, n_passed = {
        "hist": (lambda: tfm.intensity_hist_launcher(lab, img, 4, 16, bounds), 5),
        "glcm": (lambda: tfm.glcm_all_launcher(lab, img, 4, 8, shootout.OFFSETS, bounds), 5),
        "hist_atomic": (lambda: shootout.intensity_hist_atomic(lab, img, 4, 16, bounds), 5),
        "glcm_atomic": (lambda: shootout.glcm_all_atomic(lab, img, 4, 8, shootout.OFFSETS,
                                                         bounds), 5),
        # intensity, seeds, mask, scratch, site routes, labels
        "watershed": (lambda: tk.watershed_flood_launcher(img, lab, mask, 4), 6),
        "watershed_global": (lambda: tk.watershed_flood_launcher(img, lab, mask, 4, plan=glob),
                             6),
        # mask, (reached flags,) output
        "fill": (lambda: tk.fill_holes_launcher(mask), 2),
        "fill_global": (lambda: tk.fill_holes_launcher(mask, plan=glob), 3),
    }[name]
    launch = launch()
    del lab, img, bounds, mask
    gc.collect()
    assert len(passed) == n_passed and all(r() is not None for r in passed)
    out = launch()
    assert out is passed[-1]()
    ((entry, args),) = lib.calls
    assert entry.startswith("tm_") and list(args[:n_passed]) == [data_ptr(r()) for r in passed]
    del launch, out
    gc.collect()
    assert all(r() is None for r in passed)


@pytest.mark.parametrize("name", ["grouped_stats", "grouped_stats_volume", "grouped_stats_original",
                                  "watershed3d", "watershed3d_global", "distance",
                                  "distance_global"])
def test_launchers_of_this_slice_hold_the_memory_they_pass(monkeypatch, name):
    """As above, for the redesigned ``grouped_stats`` and 3-D flood, their
    first designs and the distance transform's two routes: every tensor
    whose pointer a launcher passes lives as long as the launcher."""
    lib = _RecordingLib()
    monkeypatch.setattr(tfm._cuda, "require_cuda", lambda *tensors, **checks: None)
    monkeypatch.setattr(tfm._cuda, "lib", lambda: lib)
    monkeypatch.setattr(tfm._cuda, "stream", lambda: 0)
    passed = []
    data_ptr = torch.Tensor.data_ptr

    def recording(t):
        passed.append(weakref.ref(t))
        return data_ptr(t)

    monkeypatch.setattr(torch.Tensor, "data_ptr", recording)
    lab = torch.ones((1, 8, 8), dtype=torch.int64)
    img = torch.rand((1, 8, 8), dtype=torch.float64)
    mask = torch.ones((1, 8, 8), dtype=torch.uint8)
    vol, seeds, vmask = img.reshape(1, 2, 4, 8), lab.reshape(1, 2, 4, 8), mask.reshape(1, 2, 4, 8)
    glob = tk.FloodPlan("global")
    launch, n_passed = {
        # labels, boxes, sums, mins, maxs, then the channels in a table
        "grouped_stats": (lambda: tfm.grouped_stats_launcher(lab, [img, img], 4), 7),
        # volumes, one channel broadcast over the batch (passed as a view)
        "grouped_stats_volume": (lambda: tfm.grouped_stats_launcher(
            lab.reshape(2, 1, 4, 8), [img.float().reshape(2, 1, 4, 8)[:1].expand(2, 1, 4, 8)], 4),
            6),
        "grouped_stats_original": (lambda: shootout.grouped_stats_original(lab, [img], 4), 5),
        # intensity, seeds, mask, bands, lists, counts, labels
        "watershed3d": (lambda: tv.watershed3d_flood_launcher(vol, seeds, vmask, 4), 7),
        "watershed3d_global": (lambda: tv.watershed3d_flood_launcher(vol, seeds, vmask, 4,
                                                                     plan=glob), 5),
        "distance": (lambda: tk.distance_transform_launcher(mask), 2),
        "distance_global": (lambda: tk.distance_transform_launcher(mask, plan=glob), 3),
    }[name]
    launch = launch()
    del lab, img, mask, vol, seeds, vmask
    gc.collect()
    assert len(passed) == n_passed and all(r() is not None for r in passed)
    launch()
    ((entry, args),) = lib.calls
    # a table of pointers passes its entries in order
    flat = [x for a in args for x in (list(a) if isinstance(a, ctypes.Array) else [a])]
    assert entry.startswith("tm_") and sorted(flat[:n_passed]) == sorted(
        data_ptr(r()) for r in passed)
    del launch
    gc.collect()
    assert all(r() is None for r in passed)


@pytest.mark.parametrize("name", ["grouped_stats", "grouped_stats_original", "watershed3d",
                                  "distance"])
def test_launchers_of_this_slice_raise_off_the_card(name):
    lab = torch.zeros((1, 8, 8), dtype=torch.int32, device="meta")
    img = torch.zeros((1, 8, 8), device="meta")
    make = {
        "grouped_stats": lambda: tfm.grouped_stats_launcher(lab, [img], 4),
        "grouped_stats_original": lambda: shootout.grouped_stats_original(lab, [img], 4),
        "watershed3d": lambda: tv.watershed3d_flood_launcher(
            img.reshape(1, 2, 4, 8), lab.reshape(1, 2, 4, 8), img.reshape(1, 2, 4, 8) > 0, 4),
        "distance": lambda: tk.distance_transform_launcher(img > 0),
    }[name]
    with pytest.raises(DeviceError):
        make()


def test_grouped_stats_yardstick_computes_the_function(site):
    """The library yardstick's sums (any order) are within float32
    rounding of the plain version's and its min/max are exact; ids above
    the capacity are dropped."""
    lab, img, _ = site
    lab = lab.clone()
    lab[0, :3, :3] = M + 5
    chans = [torch.ones_like(img), img, img * img]
    s, lo, hi = shootout.grouped_stats_library(lab, chans, M)()
    want = tfm.grouped_stats_plain(lab, chans, M)
    rows = lambda t: t.reshape(2, M + 1, 3)[:, 1:]  # noqa: E731
    torch.testing.assert_close(rows(s), want[0], rtol=1e-6, atol=0)
    assert torch.equal(rows(lo), want[1]) and torch.equal(rows(hi), want[2])


def test_feature_channel_calls_and_the_ab_inputs(site):
    """The A/B's grouped_stats inputs are the very calls morphology (7
    channels) and Zernike at degree 6 (32) make, and config 3's three."""
    lab, img, _ = site
    calls = shootout.feature_channel_calls(lab, M)
    assert {7, 32} <= set(calls) and calls[7][0] is lab
    inputs = {"nuclei": lab, "cells": lab, "dapi": img}
    ab = shootout.grouped_stats_inputs(inputs, M)
    assert {k: len(v[1]) for k, v in ab.items()} == {"c3": 3, "c4_7": 7, "c4_32": 32}
    vol = img.reshape(1, 2, 48, 48)
    cells = lab.reshape(1, 2, 48, 48)
    ab = shootout.grouped_stats_inputs(inputs, M, {"cells": cells, "vol": vol})
    v_lab, v_chans = ab["v6"]
    assert v_lab.shape == (1, 2, 48, 48) and len(v_chans) == 6
    assert all(c.shape == v_lab.shape for c in v_chans)


def test_grouped_stats_bytes_count_what_the_data_needs():
    """Every label, the channels of the pixels with an id in 1..M only,
    and three outputs of M rows a site."""
    lab = torch.tensor([[[0, 1, 2, 300], [5, 0, 0, -1]]])
    assert shootout.grouped_stats_bytes(lab, 3, 256) == 8 * 4 + 3 * 3 * 4 + 3 * 256 * 3 * 4
