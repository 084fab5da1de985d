"""The A/B harness (``tmlibrary_tpu_torch/shootout.py``) on the CPU.

The harness times only on a card (``chip_smoke.py`` runs it there).  Here:
its yardsticks compute the kernels' functions (a ``bincount`` of the
harness's indices equals the plain histogram, and with its transpose
added the plain GLCM), it refuses to time without a card, the launchers
it times raise for tensors off the card instead of falling back, and a
launcher holds the memory behind every pointer it passes.
"""

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
