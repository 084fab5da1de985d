"""The 3-D z-stack path (BASELINE config 5) against the JAX package.

The plain versions of the two 3-D kernels (what the wrappers run for a
CPU tensor) are held against the TPU kernels in interpret mode and the
XLA twins, bit for bit, at connectivity 6, 18 and 26 and on edge
volumes (empty, full, one voxel, a tied plateau).  The ops around them
(``shift3d``, the compaction, ``volume_features``) and the
``generate_volume_image`` module are held output by output, and the
whole path goes end to end through the JAX package's
``build_batch_fn(jit=False)`` and the port on ``device="cpu"``: labels
and counts bit for bit, features by ``FEATURE_TIERS``.  The reference's
box filter (``generate_volume_image``'s focus) runs a native box mean on
the CPU when its library is loaded, which is only within a tolerance of
the XLA taps the TPU runs, so the reference runs with ``TMX_NATIVE=0``.
The Pallas kernels run one propagation step per convergence check
(``chunk=1``): the fixpoint does not depend on it, and it traces ten
times faster.

The CUDA kernels themselves are held against the plain versions on the
card by ``chip_smoke.py`` (phase 2), not here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from chip_smoke import feature_tier
from test_torch_pipeline import _assert_same, assert_feature
from tmlibrary_tpu.benchmarks import synthetic_volume_batch as j_synth
from tmlibrary_tpu.benchmarks import volume_description as j_desc
from tmlibrary_tpu.jterator.modules import get_module as j_module
from tmlibrary_tpu.jterator.pipeline import ImageAnalysisPipeline as JPipeline
from tmlibrary_tpu.ops import pallas_kernels as jpk
from tmlibrary_tpu.ops import volume as jv
from tmlibrary_tpu_torch import benchmarks
from tmlibrary_tpu_torch.errors import DeviceError
from tmlibrary_tpu_torch.jterator.modules import get_module
from tmlibrary_tpu_torch.jterator.pipeline import (
    ImageAnalysisPipeline,
    from_jax_inputs,
    site_result_to_numpy,
)
from tmlibrary_tpu_torch.ops import kernels as tk
from tmlibrary_tpu_torch.ops import volume as tv

# the suite runs several xdist workers on shared cores: one intra-op
# thread per worker keeps the small parity fixtures from oversubscribing
torch.set_num_threads(1)

N_VOL, DEPTH, SIZE, N_CELLS, MAX_OBJECTS = 2, 8, 32, 5, 32


@pytest.fixture(scope="module")
def data():
    ref = j_synth(N_VOL, size=SIZE, depth=DEPTH, n_cells=N_CELLS, seed=3)
    ours = benchmarks.synthetic_volume_batch(N_VOL, size=SIZE, depth=DEPTH, n_cells=N_CELLS,
                                             seed=3)
    assert list(ours) == list(ref) == ["DAPI"]
    np.testing.assert_array_equal(ours["DAPI"], ref["DAPI"])
    return ref


@pytest.fixture(scope="module")
def volumes(data):
    """(intensity, mask, seeds, lower mask) of the volume path: the focus
    volume, its Otsu mask, the 26-connected seeds and the 0.8x mask."""
    vol = get_module("generate_volume_image")(torch.from_numpy(data["DAPI"]),
                                              mode="focus")["volume_image"]
    from tmlibrary_tpu_torch.ops.threshold import otsu_value

    t = otsu_value(vol)[:, None, None, None]
    seeds = tv.connected_components_3d(vol > t)[0]
    return vol.numpy(), (vol > t).numpy(), seeds.numpy(), (vol > 0.8 * t).numpy()


def _edge_volumes(rng):
    shape = (DEPTH, 16, 16)
    single = np.zeros(shape, bool)
    single[-1, -1, -1] = True
    serpentine = np.zeros(shape, bool)  # one voxel wide, through all planes
    for z in range(DEPTH):
        serpentine[z, :, z % 2 * 15] = True
        serpentine[z, 15 * (z % 2), :] = True
    return {"empty": np.zeros(shape, bool), "full": np.ones(shape, bool), "single": single,
            "serpentine": serpentine, "noise": rng.random(shape) < 0.3}


# ------------------------------------------------------ 3-D CC fixpoint
@pytest.mark.parametrize("connectivity", [6, 18, 26])
@pytest.mark.parametrize("case", ["main", "empty", "full", "single", "serpentine", "noise"])
def test_cc3d_min_propagate_matches_pallas_and_xla(rng, volumes, case, connectivity):
    ms = list(volumes[1]) if case == "main" else [_edge_volumes(rng)[case]]
    got = tv.cc3d_min_propagate(torch.from_numpy(np.stack(ms)), connectivity).numpy()
    labels, counts = tv.connected_components_3d(torch.from_numpy(np.stack(ms)), connectivity)
    for g, lab, n, m in zip(got, labels.numpy(), counts.numpy(), ms):
        pallas = np.asarray(jpk.cc3d_min_propagate(m, connectivity, interpret=True, chunk=1))
        np.testing.assert_array_equal(g, np.where(m, pallas, tk.BIG))
        xla, xn = jv.connected_components_3d(m, connectivity, method="xla")
        np.testing.assert_array_equal(lab, np.asarray(xla))
        assert n == int(xn)
        want, wn = ndi.label(m, ndi.generate_binary_structure(3, {6: 1, 18: 2, 26: 3}[connectivity]))
        np.testing.assert_array_equal(lab, want)
        assert n == wn


def test_cc3d_rejects_2d_connectivity_before_dispatch():
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError):
            tv.cc3d_min_propagate(torch.zeros((1, 2, 4, 4), dtype=torch.bool, device=dev), 8)
    with pytest.raises(ValueError):
        get_module("segment_volume")(torch.zeros((1, 2, 4, 4)), connectivity=8)


# ------------------------------------------------------ 3-D watershed
@pytest.mark.parametrize("n_levels", [4, 8])
def test_watershed3d_flood_matches_pallas_and_xla(volumes, n_levels):
    img, _, seeds, mask = volumes
    got = tv.watershed3d_flood(*map(torch.from_numpy, (img, seeds, mask)), n_levels).numpy()
    for g, i, s, m in zip(got, img, seeds, mask):
        pallas = np.asarray(jpk.watershed3d_flood(i, s, m, n_levels=n_levels, interpret=True,
                                                  chunk=1))
        xla = np.asarray(jv.watershed_from_seeds_3d(i, s, m, n_levels=n_levels, method="xla"))
        np.testing.assert_array_equal(g, pallas)
        np.testing.assert_array_equal(g, xla)
        np.testing.assert_array_equal(g[s > 0], s[s > 0])
        assert (g[~(m | (s > 0))] == 0).all()


@pytest.mark.parametrize("case", ["tie", "empty", "single"])
def test_watershed3d_flood_edge_cases(case):
    shape = (DEPTH, 16, 16)
    img = np.ones(shape, np.float32)
    seeds = np.zeros(shape, np.int32)
    mask = np.ones(shape, bool)
    if case == "tie":  # flat, two seeds: the midplane is a tie the larger label wins
        seeds[4, 8, 2], seeds[4, 8, 12] = 1, 2
    elif case == "empty":
        mask[:] = False
    else:
        mask[:] = False
        mask[3, 3, 3] = True
    got = tv.watershed3d_flood(*(torch.from_numpy(a[None]) for a in (img, seeds, mask)), 8)
    got = got.numpy()[0]
    np.testing.assert_array_equal(
        got, np.asarray(jpk.watershed3d_flood(img, seeds, mask, n_levels=8, interpret=True,
                                              chunk=1)))
    np.testing.assert_array_equal(
        got, np.asarray(jv.watershed_from_seeds_3d(img, seeds, mask, n_levels=8, method="xla")))
    if case == "tie":
        assert got[4, 8, 7] == 2 and got[4, 8, 6] == 1


# ------------------------------------------------------------ ops
def test_shift3d_matches_jax(rng):
    arr = rng.integers(0, 9, (DEPTH, 6, 7)).astype(np.int32)
    for s in tv.neighbor_shifts_3d(26):
        got = tv.shift3d(torch.from_numpy(arr[None]), *s, -1).numpy()[0]
        np.testing.assert_array_equal(got, np.asarray(jv.shift3d(arr, *s, -1)))


def test_volume_features_match_jax(volumes):
    img, _, seeds, _ = volumes
    got = tv.volume_features(torch.from_numpy(seeds), torch.from_numpy(img), MAX_OBJECTS)
    assert sorted(got) == sorted(f"Volume_{k}" for k in (
        "voxels", "centroid_z", "centroid_y", "centroid_x", "intensity_mean",
        "intensity_sum", "intensity_std"))
    for s, (lab, i) in enumerate(zip(seeds, img)):
        want = jv.volume_features(lab, i, MAX_OBJECTS)
        for name, arr in want.items():
            assert feature_tier(name) is not None
            assert_feature(name, got[name].numpy()[s], np.asarray(arr))
            if name in ("Volume_voxels", "Volume_intensity_sum"):  # pixel-order sums
                np.testing.assert_array_equal(got[name].numpy()[s], np.asarray(arr))


@pytest.mark.parametrize("mode", ["focus", "volume"])
def test_generate_volume_image_matches_jax(monkeypatch, data, mode):
    monkeypatch.setenv("TMX_NATIVE", "0")
    got = get_module("generate_volume_image")(torch.from_numpy(data["DAPI"]), mode=mode)
    assert sorted(got) == ["depth_image", "focus_image", "volume_image"]
    for s, z in enumerate(data["DAPI"]):
        want = j_module("generate_volume_image")(jnp.asarray(z), mode=mode)
        for name in got:
            np.testing.assert_array_equal(got[name].numpy()[s], np.asarray(want[name]), name)


def test_generate_volume_image_ties_go_to_the_first_plane():
    flat = torch.full((1, 3, 8, 8), 5.0)  # focus 0 in every plane
    out = get_module("generate_volume_image")(flat, mode="focus")
    assert (out["depth_image"] == 0).all()
    np.testing.assert_array_equal(out["volume_image"].numpy(), flat.numpy())


# --------------------------------------------------------------- path
def _port(data, desc=None, window=None):
    raw, st, sh = from_jax_inputs(data, {}, np.zeros((N_VOL, 2)), device="cpu")
    pipe = ImageAnalysisPipeline(desc or benchmarks.volume_description(), max_objects=MAX_OBJECTS,
                                 device="cpu")
    return site_result_to_numpy(pipe.build_batch_fn(window)(raw, st, sh))


def test_volume_description_matches_jax():
    ours, ref = benchmarks.volume_description(), j_desc()
    assert [m.module for m in ours.modules] == [m.module for m in ref.modules]
    for a, b in zip(ours.modules, ref.modules):
        assert a.constants() == b.constants()
        assert a.array_inputs() == b.array_inputs()
    assert [c.zstack for c in ours.channels] == [True]


def test_volume_path_matches_jax_batch_fn(monkeypatch, data):
    monkeypatch.setenv("TMX_NATIVE", "0")
    port = _port(data)
    fn = JPipeline(j_desc(), max_objects=MAX_OBJECTS).build_batch_fn(jit=False)
    ref = fn({"DAPI": jnp.asarray(data["DAPI"])}, {}, jnp.zeros((N_VOL, 2), jnp.int32))
    _assert_same(port, ref)
    assert port.objects["nuclei3d"].shape == (N_VOL, DEPTH, SIZE, SIZE)
    assert (port.counts["nuclei3d"] > 0).all()
    assert len(port.measurements["nuclei3d"]) == 7


def test_zstack_window_crops_the_last_two_axes(data):
    """A cycle-intersection window crops a volume's rows and columns, not
    its planes; the path runs on the cropped frame."""
    port = _port(data, window=(2, 3, 1, 4))
    assert port.objects["nuclei3d"].shape == (N_VOL, DEPTH, SIZE - 5, SIZE - 5)


# ------------------------------------------------------------ dispatch
@pytest.mark.parametrize("name", ["cc3d", "watershed3d"])
def test_volume_wrappers_never_take_plain_version_off_cpu(name):
    """A tensor that is not on the CPU goes to the kernel path, which
    raises here; only a kernel launch counts."""
    wrapper = {"cc3d": tv.cc3d_min_propagate, "watershed3d": tv.watershed3d_flood}[name]

    def call(dev):
        m = torch.zeros((1, 2, 8, 8), dtype=torch.bool, device=dev)
        return tv.cc3d_min_propagate(m) if name == "cc3d" else tv.watershed3d_flood(
            m.float(), m.int(), m, n_levels=4)

    with pytest.raises(DeviceError):
        call("meta")
    before = wrapper.launches
    call("cpu")
    assert wrapper.launches == before
