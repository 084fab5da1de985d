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
                                  "distance_columns", "distance_original"])
def test_launchers_of_this_slice_hold_the_memory_they_pass(monkeypatch, name):
    """As above, for the redesigned ``grouped_stats`` and 3-D flood, their
    first designs, the distance transform (both passes, the column pass
    alone) and its two rivals in the A/B: every tensor whose pointer a
    launcher passes lives as long as the launcher."""
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
        # mask, g, distances
        "distance": (lambda: tk.distance_transform_launcher(mask), 3),
        "distance_columns": (lambda: tk.distance_transform_launcher(
            mask, phases=tk.DT_COLUMNS), 3),
        # mask, sweeps, distances
        "distance_original": (lambda: shootout.distance_original(mask), 3),
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
                                  "distance", "distance_original"])
def test_launchers_of_this_slice_raise_off_the_card(name):
    lab = torch.zeros((1, 8, 8), dtype=torch.int32, device="meta")
    img = torch.zeros((1, 8, 8), device="meta")
    make = {
        "grouped_stats": lambda: tfm.grouped_stats_launcher(lab, [img], 4),
        "grouped_stats_original": lambda: shootout.grouped_stats_original(lab, [img], 4),
        "watershed3d": lambda: tv.watershed3d_flood_launcher(
            img.reshape(1, 2, 4, 8), lab.reshape(1, 2, 4, 8), img.reshape(1, 2, 4, 8) > 0, 4),
        "distance": lambda: tk.distance_transform_launcher(img > 0),
        "distance_original": lambda: shootout.distance_original(img > 0),
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


CC_LAUNCHERS = {
    # mask, labels
    "cc": (lambda m: tk.cc_min_propagate_launcher(m), 2),
    "cc_local": (lambda m: tk.cc_min_propagate_launcher(m, phases=tk.CC_LOCAL), 2),
    "cc3d": (lambda m: tv.cc3d_min_propagate_launcher(m.reshape(1, 2, 4, 8)), 2),
    # mask, sweeps, labels
    "cc_original": (lambda m: shootout.cc_original(m), 3),
    "cc3d_original": (lambda m: shootout.cc_original(m.reshape(1, 2, 4, 8)), 3),
}


@pytest.mark.parametrize("name", list(CC_LAUNCHERS))
def test_cc_launchers_hold_the_memory_they_pass(monkeypatch, name):
    """The union-find launchers and the first designs kept for the A/B:
    every tensor whose pointer a launcher passes (its bool copy of the
    mask, the sweep counts, the labels) lives as long as the launcher,
    the last is what a launch returns, and the phases reach the C call."""
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
    make, n_passed = CC_LAUNCHERS[name]
    launch = make(torch.ones((1, 8, 8), dtype=torch.uint8))
    gc.collect()
    assert len(passed) == n_passed and all(r() is not None for r in passed)
    out = launch()
    assert out is passed[-1]() and out.dtype == torch.int32
    ((entry, args),) = lib.calls
    stem, _, variant = name.partition("_")
    assert entry == f"tm_{stem}_min_propagate" + ("_original" if variant == "original" else "")
    assert list(args[:n_passed]) == [data_ptr(r()) for r in passed]
    if "original" not in name:
        assert args[-2] == (tk.CC_LOCAL if name == "cc_local" else tk.CC_PHASES)
    if "original" in name:
        assert launch.sweeps is passed[1]()
    del launch, out
    gc.collect()
    assert all(r() is None for r in passed)


@pytest.mark.parametrize("name", list(CC_LAUNCHERS))
def test_cc_launchers_raise_off_the_card(name):
    with pytest.raises(DeviceError):
        CC_LAUNCHERS[name][0](torch.zeros((1, 8, 8), dtype=torch.bool, device="meta"))


@pytest.mark.parametrize("rank", [3, 4])
def test_cc_sets_name_their_variants(monkeypatch, rank):
    """The ``cc``/``cc3d`` sets hold the kernel, the first design, the
    wrapper and the plain version; the splits both designs on the real,
    all-foreground and noise masks and the kernel's phase prefixes."""
    monkeypatch.setattr(tfm._cuda, "require_cuda", lambda *tensors, **checks: None)
    monkeypatch.setattr(tfm._cuda, "lib", lambda: _RecordingLib())
    monkeypatch.setattr(tfm._cuda, "stream", lambda: 0)
    masks = torch.ones((2, 3, 8, 8) if rank == 4 else (2, 8, 8), dtype=torch.bool)
    assert set(shootout.cc_set(masks)) == {"kernel", "original", "wrapper", "plain"}
    split = shootout.cc_split_set(masks)
    assert set(split) == {f"{who}_{case}" for who in ("original", "kernel")
                          for case in ("real", "full", "noise")} | {"local_real", "border_real"}
    noise = shootout.cc_cases(masks)["noise"]
    assert noise.shape == masks.shape and noise.dtype == torch.bool
    share = float(noise.float().mean())
    assert abs(share - (0.3 if rank == 4 else 0.45)) < 0.15
    assert torch.equal(shootout.cc_set(masks)["plain"](),
                       (tv.cc3d_min_propagate_plain if rank == 4 else tk.cc_min_propagate_plain)(
                           masks))


def test_cc_bytes_bound_at_the_paths_shapes():
    """One byte of mask read and four of labels written a pixel: 20.97 MB,
    6.26 us at 3.35 TB/s, for V's 16 volumes of 16x128x128 and for config
    3's 64 sites of 256x256 alike."""
    vol = torch.zeros((16, 16, 128, 128), dtype=torch.bool, device="meta")
    sites = torch.zeros((64, 256, 256), dtype=torch.bool, device="meta")
    assert shootout.cc_bytes(vol) == shootout.cc_bytes(sites) == 16 * 16 * 128 * 128 * 5
    assert abs(shootout.cc_bytes(vol) / 3.35e12 * 1e3 - 0.00626) < 1e-5


def test_cc_cas_lever_rewrites_the_shipped_union_find(tmp_path):
    """The lever script's variant of ``csrc/cc_union_find.cuh`` swaps both
    atomicMin links for compare-and-swap hooks and both finds for
    compressing ones, and renames the entry template so it links beside
    the shipped kernels; a header the patterns no longer match stops it."""
    from pathlib import Path

    from tmlibrary_tpu_torch.levers import cc_cas_hooks

    csrc = Path(tk.__file__).resolve().parent.parent / "csrc"
    src = cc_cas_hooks.variant_source(csrc)
    assert src.count("atomicCAS(") == 2 and "atomicMin(&s[b], a)" not in src
    assert src.count("up = atomicMin(") == 2 and "tm_cc_union_find" not in src
    assert 'extern "C" int cas2d' in src and 'extern "C" int cas3d' in src
    (tmp_path / "cc_union_find.cuh").write_text(src)
    with pytest.raises(SystemExit):
        cc_cas_hooks.variant_source(tmp_path)


@pytest.mark.parametrize("which", ["distance_set", "distance_split_set"])
def test_distance_sets_hold_the_memory_they_pass(monkeypatch, which):
    """The ``distance`` set (the kernel, the first design, the wrapper, the
    plain version) and its split (both designs on the real, full, centre,
    noise and empty masks, the column pass alone):
    every launcher keeps each tensor whose pointer it passes after the
    caller drops the masks, and frees them when the set goes."""
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
    masks = torch.rand((2, 8, 8)) < 0.5
    variants = getattr(shootout, which)(masks)
    cases = ("real", "full", "centre", "noise", "empty")
    assert set(variants) == ({"kernel", "original", "wrapper", "plain"}
                             if which == "distance_set" else
                             {f"{who}_{case}" for who in ("original", "columns", "kernel")
                              for case in cases})
    launchers = {k: v for k, v in variants.items() if k not in ("wrapper", "plain")}
    assert len(passed) == 3 * len(launchers)
    del masks
    gc.collect()
    assert all(r() is not None for r in passed)
    for fn in launchers.values():
        fn()
    assert len(lib.calls) == len(launchers)
    if which == "distance_split_set":
        centre = next(args for (_, args), k in zip(lib.calls, launchers) if k == "kernel_centre")
        assert centre[-4:-1] == (255, 8, tk.DT_PHASES)  # cap 255, reach 8 on 8x8 sites
    del variants, launchers, fn
    gc.collect()
    assert all(r() is None for r in passed)


def test_distance_cases_and_rivals_refuse_what_they_cannot_take():
    """The split's inputs: the filled masks, all foreground, one background
    pixel at the centre at cap 254, 45% noise, empty; the first design takes
    caps up to 254 on sites of a block's shared memory."""
    filled = torch.rand((3, 16, 12)) < 0.7
    cases = shootout.distance_cases(filled)
    assert {k: (tuple(m.shape), cap) for k, (m, cap) in cases.items()} == {
        k: ((3, 16, 12), 254 if k == "centre" else 64)
        for k in ("real", "full", "centre", "noise", "empty")}
    assert torch.equal(cases["real"][0], filled)
    assert int((~cases["centre"][0]).sum()) == 3 and not bool(cases["centre"][0][:, 8, 6].any())
    assert bool(cases["full"][0].all()) and not bool(cases["empty"][0].any())
    assert abs(float(cases["noise"][0].float().mean()) - 0.45) < 0.1
    with pytest.raises(ValueError):
        shootout.distance_original(filled, 255)
    with pytest.raises(ValueError):
        shootout.distance_original(torch.zeros((1, 483, 483), dtype=torch.bool))
    assert shootout.distance_original_takes((64, 256, 256), 254)
    assert not shootout.distance_original_takes((1, 482, 483), 64)
