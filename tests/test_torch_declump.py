"""The declumping path (D) and BASELINE config 2 (C2) against the JAX package.

The distance transform's plain version (what the wrapper runs for a CPU
tensor) is held against the TPU kernel in interpret mode, the XLA twin,
the native C twin and the closed form ``min(D, max_distance + 1)``, bit
for bit.  The ops around it (erosion, local maxima, first-pixel
relabeling, the adaptive threshold, the box filter's XLA taps) and the
``separate_clumps`` module are held output by output.  Paths D and C2 go
end to end through the JAX package's ``build_batch_fn(jit=False)`` and
the port on ``device="cpu"``: labels and counts bit for bit, features by
``FEATURE_TIERS``.  The reference's box filter runs a native box mean on
the CPU when its library is loaded, which is only within a tolerance of
the XLA taps the TPU runs, so C2 and the box filter are held with
``TMX_NATIVE=0``; D is held both ways.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` (phase 2), not here.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import _assert_same
from tmlibrary_tpu.benchmarks import SMOOTH_THRESHOLD_PIPE as J_C2_PIPE
from tmlibrary_tpu.benchmarks import synthetic_cell_painting_batch as j_synth
from tmlibrary_tpu.jterator.description import PipelineDescription as JDesc
from tmlibrary_tpu.jterator.modules import get_module as j_module
from tmlibrary_tpu.jterator.pipeline import ImageAnalysisPipeline as JPipeline
from tmlibrary_tpu.ops import label as j_label
from tmlibrary_tpu.ops import pallas_kernels as jpk
from tmlibrary_tpu.ops import segment_primary as j_sp
from tmlibrary_tpu.ops import smooth as j_smooth
from tmlibrary_tpu.ops import threshold as j_threshold
from tmlibrary_tpu_torch import benchmarks
from tmlibrary_tpu_torch.errors import DeviceError
from tmlibrary_tpu_torch.jterator.modules import get_module
from tmlibrary_tpu_torch.jterator.pipeline import (
    ImageAnalysisPipeline,
    from_jax_inputs,
    site_result_to_numpy,
)
from tmlibrary_tpu_torch.ops import kernels as tk
from tmlibrary_tpu_torch.ops import label as t_label
from tmlibrary_tpu_torch.ops import segment_primary as t_sp
from tmlibrary_tpu_torch.ops import smooth as t_smooth
from tmlibrary_tpu_torch.ops import threshold as t_threshold

# the suite runs several xdist workers on shared cores: one intra-op
# thread per worker keeps the small parity fixtures from oversubscribing
torch.set_num_threads(1)

N_SITES, SIZE, N_CELLS, MAX_OBJECTS = 2, 64, 8, 32


@pytest.fixture(scope="module")
def data():
    ref = j_synth(N_SITES, size=SIZE, n_cells=N_CELLS, seed=1)
    ours = benchmarks.synthetic_cell_painting_batch(N_SITES, size=SIZE, n_cells=N_CELLS, seed=1)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    return ref


@pytest.fixture(scope="module")
def masks(data):
    """Filled Otsu masks of the smoothed DAPI sites (path D's input to the
    distance transform): touching nuclei, some on the border."""
    sm = t_smooth.gaussian_smooth(torch.from_numpy(data["DAPI"]), 1.5)
    return t_label.fill_holes(t_threshold.threshold_otsu(sm)).numpy()


def _edge_masks(size=24):
    empty = np.zeros((size, size), bool)
    full = np.ones((size, size), bool)
    single = np.zeros((size, size), bool)
    single[size - 1, size - 1] = True
    border = np.zeros((size, size), bool)
    border[:, :9] = True  # touches three edges: erodes from the fourth only
    border[3:20, 14:22] = True
    return {"empty": empty, "full": full, "single": single, "border": border}


def closed_form(mask, max_distance):
    """``min(D, max_distance + 1)`` on the foreground, D the chessboard
    distance to the nearest in-image background pixel (none: infinite)."""
    bg = np.argwhere(~mask)
    out = np.zeros(mask.shape, np.float32)
    if not bg.size:
        out[mask] = max_distance + 1
        return out
    for y, x in np.argwhere(mask):
        d = np.abs(bg - (y, x)).max(axis=1).min()
        out[y, x] = min(d, max_distance + 1)
    return out


# ------------------------------------------------------ distance transform
@pytest.mark.parametrize("case", ["main", "empty", "full", "single", "border"])
@pytest.mark.parametrize("max_distance", [64, 2])
def test_distance_transform_matches_pallas_xla_native_and_closed_form(
        masks, case, max_distance):
    ms = list(masks) if case == "main" else [_edge_masks()[case]]
    got = tk.distance_transform(torch.from_numpy(np.stack(ms)), max_distance).numpy()
    assert got.dtype == np.float32
    for g, m in zip(got, ms):
        np.testing.assert_array_equal(
            g, np.asarray(jpk.distance_transform(m, max_distance, interpret=True)))
        for method in ("xla", "native"):
            np.testing.assert_array_equal(g, np.asarray(
                j_sp.distance_transform_approx(m, max_distance, method=method)))
        np.testing.assert_array_equal(g, closed_form(m, max_distance))


def test_distance_transform_cap_range(masks):
    """Any ``max_distance >= 0``, as the reference: 0 gives the mask, and
    caps past a byte (255, 300, 1000) equal the XLA loop and the native
    chamfer on path D's masks and on full and single-pixel sites."""
    m = torch.ones((1, 4, 4), dtype=torch.bool)
    np.testing.assert_array_equal(tk.distance_transform(m, 0).numpy(), m.float().numpy())
    with pytest.raises(ValueError):
        tk.distance_transform(m, -1)
    ms = [*masks, _edge_masks()["full"], _edge_masks()["single"]]
    for cap in (255, 300, 1000):
        for m in ms:
            got = tk.distance_transform(torch.from_numpy(m[None]), cap).numpy()[0]
            for method in ("xla", "native"):
                np.testing.assert_array_equal(got, np.asarray(
                    j_sp.distance_transform_approx(m, cap, method=method)))


def test_binary_erode_matches_jax(masks):
    for conn, iters in ((8, 1), (4, 2)):
        got = tk.binary_erode(torch.from_numpy(masks), conn, iters).numpy()
        for g, m in zip(got, masks):
            np.testing.assert_array_equal(g, np.asarray(j_label.binary_erode(m, conn, iters)))


# ------------------------------------------------ seeds and relabeling
def test_local_maxima_seeds_matches_jax(masks):
    dist = tk.distance_transform(torch.from_numpy(masks))
    got = t_sp.local_maxima_seeds(dist, torch.from_numpy(masks), 5, smooth_sigma=2.5).numpy()
    for g, d, m in zip(got, dist.numpy(), masks):
        want = np.asarray(j_sp.local_maxima_seeds(d, m, 5, smooth_sigma=2.5))
        np.testing.assert_array_equal(g, want)
    assert got.max() > 0


def _shuffled_labels(rng, size=32, n=12, max_id=40):
    """Rectangles with random, unordered ids, some above ``max_id``."""
    lab = np.zeros((size, size), np.int32)
    for _ in range(n):
        y, x = rng.integers(0, size - 4, 2)
        lab[y : y + rng.integers(2, 6), x : x + rng.integers(2, 6)] = rng.integers(1, max_id + 8)
    return lab


@pytest.mark.parametrize("max_labels", [40, 8])
def test_first_pixel_and_relabel_by_scan_order_match_jax(rng, max_labels):
    labs = np.stack([_shuffled_labels(rng) for _ in range(3)])
    first = t_label.first_pixel_by_label(torch.from_numpy(labs), max_labels).numpy()
    out = t_label.relabel_by_scan_order(torch.from_numpy(labs), max_labels).numpy()
    for f, o, lab in zip(first, out, labs):
        for method in ("scatter", "reduce"):
            np.testing.assert_array_equal(f, np.asarray(
                j_label.first_pixel_by_label(lab, max_labels, method=method)))
        np.testing.assert_array_equal(o, np.asarray(j_label.relabel_by_scan_order(lab, max_labels)))
    # with every id in range: the same regions, numbered in scipy order
    clipped = np.where(labs <= max_labels, labs, 0)
    out = t_label.relabel_by_scan_order(torch.from_numpy(clipped), max_labels).numpy()
    for o, lab in zip(out, clipped):
        firsts = [np.flatnonzero(o.ravel() == k).min() for k in range(1, o.max() + 1)]
        assert firsts == sorted(firsts) and o.max() == len(np.unique(lab)) - 1
        np.testing.assert_array_equal(o > 0, lab > 0)


# ------------------------------------------------- adaptive threshold, box
@pytest.mark.parametrize("size", [3, 4, 31])
def test_uniform_smooth_matches_jax_taps(monkeypatch, data, size):
    monkeypatch.setenv("TMX_NATIVE", "0")
    img = data["DAPI"]
    got = t_smooth.uniform_smooth(torch.from_numpy(img), size).numpy()
    for g, d in zip(got, img):
        np.testing.assert_array_equal(g, np.asarray(j_smooth.uniform_smooth(d, size)))


@pytest.mark.parametrize("method", ["mean", "gaussian"])
def test_threshold_adaptive_matches_jax(monkeypatch, data, method):
    monkeypatch.setenv("TMX_NATIVE", "0")
    img = t_smooth.gaussian_smooth(torch.from_numpy(data["DAPI"]), 1.5)
    kwargs = dict(method=method, kernel_size=15, constant=2.0, min_threshold=310.0,
                  max_threshold=2000.0)
    got = t_threshold.threshold_adaptive(img, **kwargs).numpy()
    for g, d in zip(got, img.numpy()):
        np.testing.assert_array_equal(g, np.asarray(j_threshold.threshold_adaptive(d, **kwargs)))
    assert got.any() and not got.all()


# ---------------------------------------------------------- modules
@pytest.fixture(scope="module")
def clumped(data):
    """Config 3's nuclei labels, unsplit: touching nuclei are one object."""
    sm = get_module("smooth")(torch.from_numpy(data["DAPI"]), sigma=1.5)["smoothed_image"]
    return get_module("segment_primary")(sm, smooth_sigma=0.0, min_area=20,
                                         max_objects=MAX_OBJECTS)["objects"]


@pytest.mark.parametrize("max_form_factor", [1.0, 0.6])
def test_separate_clumps_matches_jax(clumped, max_form_factor):
    kwargs = dict(min_distance=5, max_objects=MAX_OBJECTS, max_form_factor=max_form_factor)
    got = get_module("separate_clumps")(clumped, **kwargs)
    assert list(got) == ["separated_label_image"]
    out = got["separated_label_image"].numpy()
    for o, lab in zip(out, clumped.numpy()):
        want = j_module("separate_clumps")(jnp.asarray(lab), **kwargs)
        np.testing.assert_array_equal(o, np.asarray(want["separated_label_image"]))
    if max_form_factor == 1.0:
        assert (out.reshape(N_SITES, -1).max(1) >= clumped.numpy().reshape(N_SITES, -1).max(1)).all()


# --------------------------------------------------------------- paths
def _declump_pipe():
    pipe = copy.deepcopy(benchmarks.CELL_PAINTING_PIPE)
    for item in pipe["pipeline"]:
        if item["handles"]["module"] == "segment_primary":
            item["handles"]["input"].append({"name": "declump", "type": "Boolean", "value": True})
    return pipe


def _port(data, desc):
    raw, st, sh = from_jax_inputs(data, {}, np.zeros((N_SITES, 2)), device="cpu")
    pipe = ImageAnalysisPipeline(desc, max_objects=MAX_OBJECTS, device="cpu")
    return site_result_to_numpy(pipe.build_batch_fn()(raw, st, sh))


def _jax(data, desc):
    fn = JPipeline(desc, max_objects=MAX_OBJECTS).build_batch_fn(jit=False)
    return fn({k: jnp.asarray(v) for k, v in data.items()}, {},
              jnp.zeros((N_SITES, 2), jnp.int32))


def test_declump_description_is_config3_with_declump():
    ours = benchmarks.cell_painting_declump_description()
    ref = JDesc.from_dict(_declump_pipe())
    assert [m.module for m in ours.modules] == [m.module for m in ref.modules]
    for a, b in zip(ours.modules, ref.modules):
        assert a.constants() == b.constants()
    assert ours.modules[1].constants()["declump"] is True


@pytest.mark.parametrize("native", ["1", "0"])
def test_declump_path_matches_jax_batch_fn(monkeypatch, data, native):
    """Path D against the reference with its native C twins (bit-identical
    to the XLA ones) and with ``TMX_NATIVE=0`` (the XLA path the TPU runs)."""
    monkeypatch.setenv("TMX_NATIVE", native)
    port = _port(data, benchmarks.cell_painting_declump_description())
    _assert_same(port, _jax(data, JDesc.from_dict(_declump_pipe())))
    plain = _port(data, benchmarks.cell_painting_description())
    # declumping splits at least one touching pair in this batch
    assert port.counts["nuclei"].sum() > plain.counts["nuclei"].sum()


def test_config2_matches_jax_batch_fn(monkeypatch):
    monkeypatch.setenv("TMX_NATIVE", "0")
    data = j_synth(N_SITES, size=SIZE, n_cells=N_CELLS, seed=1, dapi_only=True)
    ours = benchmarks.smooth_threshold_description()
    ref = JDesc.from_dict(J_C2_PIPE)
    assert [(m.module, m.constants()) for m in ours.modules] == [
        (m.module, m.constants()) for m in ref.modules]
    port = _port(data, ours)
    _assert_same(port, _jax(data, ref))
    assert list(port.objects) == ["fg"] and (port.counts["fg"] > 0).all()


# ------------------------------------------------------------ dispatch
def test_distance_wrapper_never_takes_plain_version_off_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which
    raises here; only a kernel launch counts."""
    with pytest.raises(DeviceError):
        tk.distance_transform(torch.zeros((1, 8, 8), dtype=torch.bool, device="meta"))
    before = tk.distance_transform.launches
    tk.distance_transform(torch.zeros((1, 8, 8), dtype=torch.bool))
    assert tk.distance_transform.launches == before
