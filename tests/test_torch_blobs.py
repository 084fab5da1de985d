"""The port's LoG spot detection and the spot-counting path (chip_smoke
path i) against the JAX package, on the CPU.

Tolerances: ``log_response`` bit-exact at σ 1.5 and within
``chip_smoke.LOG_TIER`` elsewhere (the port's gaussian taps are an ulp
from XLA-CPU's, ROADMAP C; with the reference's taps it is exact);
``local_maxima`` exact on the same response; the blob labels and centres
by the boundary rule ``chip_smoke.blob_flips`` (a pixel may change sides
only within the response tier of the threshold, a peak only where two
pixels of its window lie within twice the tier; a site with no flipped
pixel is exact); counts exact where the labels are; the path's other
objects exact and its features within ``FEATURE_TIERS`` on the sites
whose spots are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import SPOT_SIGMAS, blob_flips, spot_response_tier
from test_torch_pipeline import assert_feature
from tmlibrary_tpu.benchmarks import synthetic_cell_painting_batch
from tmlibrary_tpu.jterator import modules as ref_modules
from tmlibrary_tpu.jterator.description import PipelineDescription as JDesc
from tmlibrary_tpu.jterator.pipeline import ImageAnalysisPipeline as JPipeline
from tmlibrary_tpu.ops import blobs as j_blobs
from tmlibrary_tpu.ops import smooth as j_smooth
from tmlibrary_tpu_torch.jterator import modules as port_modules
from tmlibrary_tpu_torch.jterator.description import PipelineDescription
from tmlibrary_tpu_torch.jterator.pipeline import (
    ImageAnalysisPipeline,
    from_jax_inputs,
    site_result_to_numpy,
)
from tmlibrary_tpu_torch.ops import blobs as t_blobs
from tmlibrary_tpu_torch.ops import smooth as t_smooth

torch.set_num_threads(1)

SIZE = 96


@pytest.fixture(scope="module")
def spot_sites():
    """3 sites of 96² of the path's FISH, max-projected: each site's
    intensities scaled differently (1, 0.5, 2)."""
    fish = chip_smoke.synthetic_fish_batch(3, SIZE).max(axis=1)
    return np.ascontiguousarray(fish * np.array([1.0, 0.5, 2.0], np.float32)[:, None, None])


def ref_stack(fn, imgs):
    return np.stack([np.asarray(fn(jnp.asarray(x))) for x in imgs])


@pytest.mark.parametrize("sigma", [1.5, 2.25, 3.0, 4.0])
def test_log_response_matches_jax(spot_sites, sigma):
    got = t_blobs.log_response(torch.from_numpy(spot_sites), sigma).numpy()
    want = ref_stack(lambda x: j_blobs.log_response(x, sigma), spot_sites)
    if sigma == 1.5:
        np.testing.assert_array_equal(got, want)
    tol = spot_response_tier(sigma, spot_sites, bilateral=False)
    for s in range(3):
        assert np.abs(got[s] - want[s]).max() <= tol[s]


def test_log_response_exact_with_the_references_taps(spot_sites, monkeypatch):
    """The whole difference is the taps: with XLA-CPU's the response is
    bit-exact."""
    monkeypatch.setattr(t_smooth, "gaussian_taps", lambda sigma, radius: np.asarray(
        j_smooth._gaussian_kernel1d(sigma, radius)))
    got = t_blobs.log_response(torch.from_numpy(spot_sites), 3.0).numpy()
    np.testing.assert_array_equal(got, ref_stack(lambda x: j_blobs.log_response(x, 3.0),
                                                 spot_sites))


@pytest.mark.parametrize("min_distance", [1, 3, 5])
def test_local_maxima_exact_on_the_same_response(spot_sites, min_distance):
    resp = ref_stack(lambda x: j_blobs.log_response(x, 2.0), spot_sites)
    got = t_blobs.local_maxima(torch.from_numpy(resp), min_distance).numpy()
    want = ref_stack(lambda x: j_blobs.local_maxima(x, min_distance), resp)
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


def test_local_maxima_plateaus_keep_the_first_pixel():
    """Integer plateaus: one peak per plateau window, the first in scan
    order, as the reference; -inf beyond the image never wins."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 3, (3, 33, 40)).astype(np.float32)
    img[1] = 5.0  # one flat site: only its first pixel survives each window
    got = t_blobs.local_maxima(torch.from_numpy(img), 3).numpy()
    want = ref_stack(lambda x: j_blobs.local_maxima(x, 3), img)
    np.testing.assert_array_equal(got, want)
    assert got[1, 0, 0]


def _detect(impl, imgs, sigmas, threshold, min_distance):
    """``{"response", "blobs", "centers"}`` tensors and the counts of one
    implementation's ``detect_blobs`` on ``imgs``."""
    if impl == "port":
        x = torch.from_numpy(imgs)
        resp = t_blobs.log_response(x, sigmas[0])
        for s in sigmas[1:]:
            resp = torch.maximum(resp, t_blobs.log_response(x, s))
        blobs, centers, count = t_blobs.detect_blobs(x, sigmas, threshold, min_distance, 64)
        return {"response": resp, "blobs": blobs, "centers": centers}, count.numpy()
    out = {"response": [], "blobs": [], "centers": []}
    counts = []
    for x in imgs:
        r = j_blobs.log_response(x, sigmas[0])
        for s in sigmas[1:]:
            r = jnp.maximum(r, j_blobs.log_response(x, s))
        b, c, n = j_blobs.detect_blobs(jnp.asarray(x), sigmas, threshold, min_distance, 64)
        for k, v in (("response", r), ("blobs", b), ("centers", c)):
            out[k].append(np.asarray(v))
        counts.append(int(n))
    return {k: torch.from_numpy(np.stack(v)) for k, v in out.items()}, np.array(counts)


@pytest.mark.parametrize("sigmas,threshold,min_distance", [
    ((1.5, 2.25, 3.0), 150.0, 3),
    ((1.5, 2.75, 4.0), 100.0, 3),
    ((2.0,), 300.0, 2),
])
def test_detect_blobs_by_the_boundary_rule(spot_sites, sigmas, threshold, min_distance):
    want, want_n = _detect("ref", spot_sites, sigmas, threshold, min_distance)
    got, got_n = _detect("port", spot_sites, sigmas, threshold, min_distance)
    tol = spot_response_tier(max(sigmas), spot_sites, bilateral=False)
    flips = blob_flips(torch, want, got, threshold, tol, min_distance)
    for s in flips["exact_sites"]:
        assert got_n[s] == want_n[s] == int(got["blobs"][s].max())
    assert len(flips["exact_sites"]) == 3, flips  # nothing flipped on these sites
    assert (got_n > 5).all()


def test_detect_blobs_flat_site_has_none():
    rng = np.random.default_rng(6)
    flat = rng.normal(300.0, 2.0, (2, SIZE, SIZE)).astype(np.float32)
    labels, centers, count = t_blobs.detect_blobs(torch.from_numpy(flat), threshold=50.0)
    assert count.tolist() == [0, 0] and int(labels.max()) == 0 and int(centers.max()) == 0
    for x in flat:
        b, c, n = j_blobs.detect_blobs(jnp.asarray(x), threshold=50.0)
        assert int(n) == 0 and int(np.asarray(b).max()) == 0


def test_detect_blobs_count_is_per_site_and_clipped(spot_sites):
    """The count is each site's, at most ``max_objects``; labels above it
    are dropped."""
    _, _, full = t_blobs.detect_blobs(torch.from_numpy(spot_sites), threshold=100.0)
    labels, _, clipped = t_blobs.detect_blobs(torch.from_numpy(spot_sites), threshold=100.0,
                                              max_objects=4)
    assert (full > 4).all() and clipped.tolist() == [4, 4, 4]
    assert int(labels.max()) == 4
    for s in range(3):
        _, _, one = t_blobs.detect_blobs(torch.from_numpy(spot_sites[s : s + 1]),
                                         threshold=100.0)
        assert int(one[0]) == int(full[s])


def test_detect_blobs_module_matches_jax(spot_sites):
    kwargs = dict(threshold=150.0, min_distance=3, sigma_min=1.5, sigma_max=3.0, n_scales=3,
                  max_objects=64)
    got = port_modules.get_module("detect_blobs")(torch.from_numpy(spot_sites), **kwargs)
    ref = ref_modules.get_module("detect_blobs")
    for s in range(3):
        want = ref(jnp.asarray(spot_sites[s]), **kwargs)
        np.testing.assert_array_equal(got["objects"][s].numpy(), np.asarray(want["objects"]))
        np.testing.assert_array_equal(got["centers"][s].numpy(), np.asarray(want["centers"]))


# ------------------------------------------------------------- path (i)
def test_cell_centres_replay_the_cell_painting_generator():
    data = synthetic_cell_painting_batch(2, size=SIZE, seed=3)
    for s, (ys, xs, radii) in enumerate(chip_smoke.cell_centres(2, SIZE, seed=3)):
        assert len(ys) == 12 and (data["DAPI"][s][ys, xs] > 2000).all()
        assert ((radii >= 7.0) & (radii <= 16.5)).all()


def test_fish_batch_is_seeded_and_in_range():
    a = chip_smoke.synthetic_fish_batch(2, 64, seed=1)
    assert a.shape == (2, chip_smoke.FISH_DEPTH, 64, 64) and a.dtype == np.float32
    np.testing.assert_array_equal(a, chip_smoke.synthetic_fish_batch(2, 64, seed=1))
    assert 0 <= a.min() and a.max() <= 65535 and a.max() > 1000
    assert 250.0 < float(np.percentile(a, 10)) < 300.0  # the noise around 300


@pytest.fixture(scope="module")
def path_data():
    data = synthetic_cell_painting_batch(3, size=SIZE, n_cells=12, seed=0)
    data["FISH"] = chip_smoke.synthetic_fish_batch(3, SIZE)
    return data


def _port_spot_chain(fish):
    """The path's FISH chain on the port up to detect_blobs' input."""
    m = port_modules
    x = m.get_module("mip")(torch.from_numpy(fish))["mip_image"]
    x = m.get_module("clip")(x, lower=0.0, upper=20000.0)["clipped_image"]
    return x, m.get_module("smooth")(x, method="bilateral", size=5, sigma=2.0)["smoothed_image"]


def _ref_spot_chain(fish):
    m = ref_modules
    mips, sms = [], []
    for v in fish:
        x = m.get_module("mip")(jnp.asarray(v))["mip_image"]
        x = m.get_module("clip")(x, lower=0.0, upper=20000.0)["clipped_image"]
        mips.append(np.asarray(x))
        sms.append(np.asarray(m.get_module("smooth")(x, method="bilateral", size=5,
                                                     sigma=2.0)["smoothed_image"]))
    return np.stack(mips), np.stack(sms)


def test_spot_path_matches_jax(path_data):
    """The whole path-i description on the CPU against the reference's
    ``build_batch_fn(jit=False)``: nuclei, perinuclei and cells exact;
    the spots by the boundary rule on each side's own bilateral output;
    the cells' point patterns and the spots' intensities within
    ``FEATURE_TIERS`` on the sites whose spots are exact."""
    pipe = chip_smoke.spots_pipe(max_points=64)
    n = 3
    raw, st, sh = from_jax_inputs(path_data, {}, np.zeros((n, 2)), device="cpu")
    port = site_result_to_numpy(ImageAnalysisPipeline(
        PipelineDescription.from_dict(pipe), max_objects=64, device="cpu")
        .build_batch_fn()(raw, st, sh))
    ref = JPipeline(JDesc.from_dict(pipe), max_objects=64).build_batch_fn(jit=False)(
        {k: jnp.asarray(v) for k, v in path_data.items()}, {}, jnp.zeros((n, 2), jnp.int32))
    assert sorted(port.objects) == sorted(ref.objects) == [
        "cells", "nuclei", "perinuclei", "spots"]
    for name in ("nuclei", "perinuclei", "cells"):
        np.testing.assert_array_equal(port.objects[name], np.asarray(ref.objects[name]))
        np.testing.assert_array_equal(port.counts[name], np.asarray(ref.counts[name]))

    lo, hi, k = SPOT_SIGMAS
    sigmas = tuple(lo + (hi - lo) * i / max(k - 1, 1) for i in range(k))
    mip_p, sm_p = _port_spot_chain(path_data["FISH"])
    mip_r, sm_r = _ref_spot_chain(path_data["FISH"])
    np.testing.assert_array_equal(mip_p.numpy(), mip_r)
    got, _ = _detect("port", sm_p.numpy(), sigmas, chip_smoke.SPOT_THRESHOLD, 3)
    want, _ = _detect("ref", sm_r, sigmas, chip_smoke.SPOT_THRESHOLD, 3)
    np.testing.assert_array_equal(got["blobs"].numpy(), port.objects["spots"])
    np.testing.assert_array_equal(want["blobs"].numpy(), np.asarray(ref.objects["spots"]))
    flips = blob_flips(torch, want, got, chip_smoke.SPOT_THRESHOLD,
                       spot_response_tier(hi, mip_r, bilateral=True), 3)
    exact = flips["exact_sites"]
    assert len(exact) >= 2, flips
    for obj in ("cells", "spots"):
        counts = np.asarray(ref.counts[obj])
        for feat, arr in ref.measurements[obj].items():
            for s in exact:
                assert_feature(feat, port.measurements[obj][feat][s, : counts[s]],
                               np.asarray(arr)[s, : counts[s]])
    assert sorted(port.measurements["cells"]) == sorted(ref.measurements["cells"])
    assert (port.counts["spots"] > 10).all()


def test_spot_path_launch_counts(path_data, monkeypatch):
    """The kernels the path calls, counted on the CPU at their wrappers:
    the counts ``chip_smoke.SPOTS_LAUNCHES`` pins on the card (each call
    is one launch there)."""
    from tmlibrary_tpu_torch.ops import fused_measure, kernels, measure

    calls = {}

    def counting(mod, name):
        fn = getattr(mod, name)

        def wrapper(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(mod, name, wrapper)

    for name in ("fill_holes_flood", "cc_min_propagate", "watershed_flood",
                 "distance_transform"):
        counting(kernels, name)
    counting(measure, "grouped_stats")
    counting(fused_measure, "grouped_stats")
    raw, st, sh = from_jax_inputs(path_data, {}, np.zeros((3, 2)), device="cpu")
    ImageAnalysisPipeline(PipelineDescription.from_dict(chip_smoke.spots_pipe()),
                          device="cpu").build_batch_fn()(raw, st, sh)
    assert calls == chip_smoke.SPOTS_LAUNCHES
