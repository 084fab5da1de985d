"""The port's four kernels against the JAX package, on the CPU.

Each kernel's plain PyTorch version (what the wrapper runs for a CPU
tensor) is held against the TPU kernel run in interpret mode, as
``tests/test_pallas_kernels.py`` runs it, and against the XLA twin.
Labels, masks, counts, min and max are bit-exact; fractional sums carry
``rtol=1e-6`` against the Pallas kernel (whose chunked one-hot
contraction sums in another order) and are bit-exact against the scatter
reference, which sums in pixel order like the port.

The CUDA kernels themselves are held against the plain versions on the
card by ``chip_smoke.py`` (phase 2), not here.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax.numpy as jnp

from tmlibrary_tpu.ops import fused_measure as jfm
from tmlibrary_tpu.ops import measure as jmeasure
from tmlibrary_tpu.ops import pallas_kernels as jpk
from tmlibrary_tpu.ops.label import connected_components as j_cc
from tmlibrary_tpu.ops.label import fill_holes as j_fill
from tmlibrary_tpu.ops.segment_secondary import watershed_from_seeds as j_ws
from tmlibrary_tpu_torch.errors import DeviceError
from tmlibrary_tpu_torch.ops import fused_measure as tfm
from tmlibrary_tpu_torch.ops import kernels as tk

# the suite runs several xdist workers on shared cores: one intra-op
# thread per worker keeps the small parity fixtures from oversubscribing
torch.set_num_threads(1)


def blobs(rng, shape=(64, 64), n=6, r=4):
    img = np.zeros(shape, np.float32)
    yy, xx = np.mgrid[0 : shape[0], 0 : shape[1]]
    for _ in range(n):
        y, x = rng.integers(r, shape[0] - r, 2)
        img += np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * (r / 2) ** 2))
    return img


def serpentine(h=24, w=24):
    mask = np.zeros((h, w), bool)
    for r in range(0, h, 4):
        mask[r, :] = True
        if (r // 4) % 2 == 0 and r + 4 < h:
            mask[r : r + 5, w - 1] = True
        elif r + 4 < h:
            mask[r : r + 5, 0] = True
    return mask


def edge_masks(size=16):
    empty = np.zeros((size, size), bool)
    full = np.ones((size, size), bool)
    single = np.zeros((size, size), bool)
    single[size - 1, size - 1] = True
    return {"empty": empty, "full": full, "single": single,
            "serpentine": serpentine(size, size)}


def batch(*arrays):
    return torch.from_numpy(np.stack(arrays))


# -------------------------------------------------------------- fill holes
def _holey(rng):
    mask = blobs(rng, n=6, r=7) > 0.25
    mask[20:24, 20:24] = False
    mask[40:43, 10:12] = False
    return mask


@pytest.mark.parametrize("connectivity", [4, 8])
def test_fill_holes_matches_pallas_xla_and_scipy(rng, connectivity):
    masks = [_holey(rng) for _ in range(3)]
    got = tk.fill_holes_flood(batch(*masks), connectivity).numpy()
    for i, m in enumerate(masks):
        pallas = np.asarray(jpk.fill_holes_flood(m, connectivity, interpret=True))
        xla = np.asarray(j_fill(m, connectivity, method="xla"))
        np.testing.assert_array_equal(got[i], pallas)
        np.testing.assert_array_equal(got[i], xla)
        if connectivity == 4:
            np.testing.assert_array_equal(got[i], ndi.binary_fill_holes(m))


@pytest.mark.parametrize("case", ["empty", "full", "single", "serpentine"])
def test_fill_holes_edge_cases(case):
    m = edge_masks()[case]
    got = tk.fill_holes_flood(batch(m)).numpy()[0]
    np.testing.assert_array_equal(got, np.asarray(jpk.fill_holes_flood(m, interpret=True)))
    np.testing.assert_array_equal(got, ndi.binary_fill_holes(m))


# ------------------------------------------------------- CC min-propagate
@pytest.mark.parametrize("connectivity", [4, 8])
def test_cc_min_propagate_matches_pallas(rng, connectivity):
    masks = [blobs(rng) > 0.3 for _ in range(2)]
    got = tk.cc_min_propagate(batch(*masks), connectivity).numpy()
    for i, m in enumerate(masks):
        want = np.asarray(jpk.cc_min_propagate(m, connectivity, interpret=True))
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("case", ["empty", "full", "single", "serpentine"])
@pytest.mark.parametrize("connectivity", [4, 8])
def test_cc_min_propagate_edge_cases(case, connectivity):
    m = edge_masks()[case]
    got = tk.cc_min_propagate(batch(m), connectivity).numpy()[0]
    want = np.asarray(jpk.cc_min_propagate(m, connectivity, interpret=True))
    np.testing.assert_array_equal(got, want)
    assert (got[~m] == tk.BIG).all()
    if m.any():
        lab, n = ndi.label(m, ndi.generate_binary_structure(2, 1 if connectivity == 4 else 2))
        for k in range(1, n + 1):
            assert (got[lab == k] == np.flatnonzero((lab == k).ravel()).min()).all()


def test_cc_min_propagate_matches_xla_fixpoint(rng):
    """The XLA twin's compacted labels, expanded back to the
    min-linear-index fixpoint, equal the port's raw fixpoint."""
    m = blobs(rng, n=8) > 0.3
    got = tk.cc_min_propagate(batch(m)).numpy()[0]
    lx, count = j_cc(m, 8, method="xla")
    lx = np.asarray(lx)
    want = np.full(m.shape, tk.BIG, np.int64)
    linear = np.arange(m.size).reshape(m.shape)
    for k in range(1, int(count) + 1):
        want[lx == k] = linear[lx == k].min()
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------- watershed
def _watershed_inputs(rng, n_sites=2):
    out = []
    for _ in range(n_sites):
        dapi = blobs(rng, n=5, r=3)
        actin = blobs(rng, n=5, r=8) + 0.05
        seeds = np.asarray(j_cc(dapi > 0.5, 8, method="xla")[0])
        out.append((actin, seeds, actin > 0.15))
    return out


@pytest.mark.parametrize("n_levels", [4, 8, 16])
def test_watershed_flood_matches_pallas_and_xla(rng, n_levels):
    sites = _watershed_inputs(rng)
    got = tk.watershed_flood(
        *(batch(*col) for col in zip(*sites)), n_levels=n_levels).numpy()
    for i, (img, seeds, mask) in enumerate(sites):
        pallas = np.asarray(jpk.watershed_flood(img, seeds, mask, n_levels=n_levels,
                                                interpret=True))
        xla = np.asarray(j_ws(img, seeds, mask, n_levels=n_levels, method="xla"))
        np.testing.assert_array_equal(got[i], pallas)
        np.testing.assert_array_equal(got[i], xla)


def test_watershed_flood_seeds_kept(rng):
    img = blobs(rng, n=4, r=6)
    seeds = np.asarray(j_cc(img > 0.6, 8, method="xla")[0])
    mask = img > 0.1
    out = tk.watershed_flood(batch(img), batch(seeds), batch(mask), n_levels=4).numpy()[0]
    np.testing.assert_array_equal(out[seeds > 0], seeds[seeds > 0])
    assert (out[~(mask | (seeds > 0))] == 0).all()
    np.testing.assert_array_equal(
        out, np.asarray(jpk.watershed_flood(img, seeds, mask, n_levels=4, interpret=True)))


def test_watershed_flood_empty_mask():
    img = np.zeros((16, 16), np.float32)
    zeros = np.zeros((16, 16), np.int32)
    out = tk.watershed_flood(batch(img), batch(zeros), batch(zeros.astype(bool)), 8)
    assert not out.any()


# ------------------------------------------------------------ grouped stats
def _stats_site(rng, kind):
    labels = np.zeros((64, 64), np.int32)
    if kind == "dense":
        k = 1
        for r in range(0, 63, 21):
            for c in range(0, 63, 21):
                labels[r : r + 20, c : c + 20] = k
                k += 1
    elif kind == "sparse":
        for i, (y, x) in enumerate([(5, 5), (30, 48), (55, 12)], start=1):
            labels[y : y + 4, x : x + 4] = i
    else:  # "beyond": ids past max_objects must drop
        labels[0:8, 0:8] = 3
        labels[10:20, 10:20] = 40
        labels[30:34, 30:34] = 12
    img = (rng.random((64, 64)) * 4096).astype(np.float32)
    return labels, img


@pytest.mark.parametrize("kind", ["dense", "sparse", "beyond"])
def test_grouped_stats_matches_pallas_and_scatter(rng, kind):
    max_objects = 11
    labels, img = _stats_site(rng, kind)
    chans = [np.ones_like(img), img, img * img]
    sums, mins, maxs = (
        t.numpy()[0] for t in tk_grouped(labels, chans, max_objects))
    p_sums, p_mins, p_maxs = (np.asarray(a) for a in jfm.grouped_stats(
        jnp.asarray(labels), [jnp.asarray(c) for c in chans], max_objects,
        interpret=True))
    np.testing.assert_array_equal(mins, p_mins)
    np.testing.assert_array_equal(maxs, p_maxs)
    np.testing.assert_array_equal(sums[:, 0], p_sums[:, 0])  # counts
    np.testing.assert_allclose(sums, p_sums, rtol=1e-6, atol=0)
    # the scatter reference sums in pixel order, like the port: bit-exact
    s_sums = np.asarray(jmeasure.grouped_sums(
        jnp.asarray(labels), [jnp.asarray(c) for c in chans], max_objects,
        method="scatter"))
    np.testing.assert_array_equal(sums, s_sums)
    s_min, s_max = jmeasure.grouped_minmax(
        jnp.asarray(labels), jnp.asarray(img), max_objects, method="scatter")
    np.testing.assert_array_equal(mins[:, 1], np.asarray(s_min))
    np.testing.assert_array_equal(maxs[:, 1], np.asarray(s_max))


def tk_grouped(labels, chans, max_objects):
    return tfm.grouped_stats(batch(labels), [batch(c) for c in chans], max_objects)


def test_grouped_stats_absent_rows_and_capacity_invariance(rng):
    labels, img = _stats_site(rng, "sparse")
    chans = [np.ones_like(img), img]
    small = tk_grouped(labels, chans, 3)
    large = tk_grouped(labels, chans, 40)
    for a, b in zip(small, large):
        np.testing.assert_array_equal(a.numpy()[:, :3], b.numpy()[:, :3])
    sums, mins, maxs = (t.numpy()[0] for t in large)
    assert (sums[3:] == 0).all()
    assert np.isposinf(mins[3:]).all() and np.isneginf(maxs[3:]).all()


# ------------------------------------------------------------- dispatch
@pytest.mark.parametrize("name", ["fill", "cc", "watershed", "stats"])
def test_wrapper_never_takes_plain_version_off_cpu(name):
    """A tensor that is not on the CPU goes to the kernel path, which
    raises here; the plain version is only ever taken for CPU tensors,
    and only a kernel launch counts."""
    meta = torch.zeros((1, 8, 8), dtype=torch.bool, device="meta")
    calls = {
        "fill": lambda: tk.fill_holes_flood(meta),
        "cc": lambda: tk.cc_min_propagate(meta),
        "watershed": lambda: tk.watershed_flood(
            meta.float(), meta.int(), meta, n_levels=4),
        "stats": lambda: tfm.grouped_stats(meta.int(), [meta.float()], 4),
    }
    wrappers = {"fill": tk.fill_holes_flood, "cc": tk.cc_min_propagate,
                "watershed": tk.watershed_flood, "stats": tfm.grouped_stats}
    with pytest.raises(DeviceError):
        calls[name]()
    before = wrappers[name].launches
    cpu = torch.zeros((1, 8, 8), dtype=torch.bool)
    {"fill": lambda: tk.fill_holes_flood(cpu),
     "cc": lambda: tk.cc_min_propagate(cpu),
     "watershed": lambda: tk.watershed_flood(cpu.float(), cpu.int(), cpu, 4),
     "stats": lambda: tfm.grouped_stats(cpu.int(), [cpu.float()], 4)}[name]()
    assert wrappers[name].launches == before
