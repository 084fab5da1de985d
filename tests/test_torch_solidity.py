"""Solidity's host pass: the port's C++ hull counts (``csrc/host/hull.cpp``)
and their plain numpy version against the JAX package's
``hull_pixel_counts_host``/``solidity_host``, bit for bit.

The reference is run twice: with its native library, and with its numpy
fallback (``TMX_NATIVE=0`` set and the library unloaded; the switch alone
does not reach the hull count).  Sites: random blobs, jittered discs,
one- and two-pixel objects, collinear lines (rows, columns, diagonals),
hand-computed shapes, ids above ``max_label`` and negative ids, an empty
site and a site-filling object.
"""

import numpy as np
import pytest

import tmlibrary_tpu.native as j_native
from tmlibrary_tpu_torch import native
from tmlibrary_tpu_torch.errors import BuildError


@pytest.fixture(params=["native", "numpy"])
def reference(request, monkeypatch):
    """The reference's ``(hull_pixel_counts_host, solidity_host)`` with its
    native library, or forced onto its numpy fallback."""
    if request.param == "numpy":
        monkeypatch.setenv("TMX_NATIVE", "0")
        monkeypatch.setattr(j_native, "_lib", None)
        monkeypatch.setattr(j_native, "_load_attempted", True)
    elif j_native._load() is None:
        pytest.fail("the reference's native library did not build")
    return j_native.hull_pixel_counts_host, j_native.solidity_host


def blobs(seed: int, shape=(64, 64), n=12) -> np.ndarray:
    rng = np.random.default_rng(seed)
    labels = np.zeros(shape, np.int32)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    for lab in range(1, n + 1):
        cy, cx = rng.integers(0, shape[0]), rng.integers(0, shape[1])
        r = rng.uniform(1.0, 9.0)
        disc = (yy - cy) ** 2 + ((xx - cx) * rng.uniform(0.5, 1.5)) ** 2 <= r * r
        labels[disc & (rng.random(shape) > 0.25) & (labels == 0)] = lab
    return labels


def edge_sites() -> dict[str, tuple[np.ndarray, int]]:
    sites = {}
    a = np.zeros((9, 11), np.int32)
    a[1, 1] = 1                       # one pixel
    a[3, 3:5] = 2                     # two pixels, a row
    a[5:7, 9] = 3                     # two pixels, a column
    a[7, 1] = a[8, 2] = 4             # two pixels, diagonal
    a[0, 5:11] = 5                    # collinear row
    a[2:9, 7] = 6                     # collinear column
    for i in range(4):
        a[4 + i, 1 + i] = 7           # collinear diagonal
    sites["small_and_collinear"] = (a, 8)
    b = np.zeros((5, 5), np.int32)
    b[0:3, 0] = 1
    b[2, 1:3] = 1                     # the L: hull count 6
    b[1, 4] = b[3, 4] = b[2, 3] = b[2, 4] = 2
    sites["hand"] = (b, 2)
    c = blobs(7)
    c[c == 3] = 300                   # an id above max_label
    c[c == 4] = -2                    # a negative id
    sites["ids_outside"] = (c, 12)
    sites["empty"] = (np.zeros((16, 8), np.int32), 4)
    sites["full"] = (np.ones((31, 17), np.int32), 1)
    sites["max_label_below_ids"] = (blobs(8), 5)
    sites["wide"] = (blobs(9, (17, 129), 20), 32)
    return sites


CASES = {**{f"blobs_{s}": (blobs(s), 16) for s in range(6)}, **edge_sites()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hull_counts_match_the_reference(case, reference):
    labels, max_label = CASES[case]
    ref_hull, _ = reference
    want = ref_hull(labels, max_label)
    got = native.hull_pixel_counts(labels, max_label)
    assert got.dtype == np.int32 and got.shape == (max_label,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native.hull_pixel_counts_numpy(labels, max_label), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_solidity_is_bit_exact(case, reference):
    labels, max_label = CASES[case]
    _, ref_solidity = reference
    want = ref_solidity(labels, max_label)
    got = native.solidity(labels, max_label)
    assert got.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    flat = np.where((labels >= 0) & (labels <= max_label), labels, 0).ravel()
    areas = np.bincount(flat, minlength=max_label + 1)[1:]
    assert native.solidity(labels, max_label, areas).tobytes() == \
        ref_solidity(labels, max_label, areas).tobytes()


def ellipses(seed: int) -> tuple[np.ndarray, int]:
    """A site of odd shape with up to 14 rotated, pitted ellipses, some
    cut by the border, and a ``max_label`` that may drop some of them."""
    rng = np.random.default_rng(100 + seed)
    h, w = rng.integers(1, 90, 2)
    labels = np.zeros((h, w), np.int32)
    yy, xx = np.mgrid[0:h, 0:w]
    for lab in range(1, int(rng.integers(1, 15)) + 1):
        cy, cx = rng.uniform(-5, h + 5), rng.uniform(-5, w + 5)
        a, b = rng.uniform(0.3, 25, 2)
        th = rng.uniform(0, np.pi)
        u = (yy - cy) * np.cos(th) + (xx - cx) * np.sin(th)
        v = (xx - cx) * np.cos(th) - (yy - cy) * np.sin(th)
        inside = ((u / a) ** 2 + (v / b) ** 2 <= 1) & (rng.random((h, w)) > rng.uniform(0, 0.6))
        labels[inside] = lab
    return labels, int(rng.integers(1, 18))


@pytest.mark.parametrize("seed", range(8))
def test_random_ellipses_match_the_reference(seed, reference):
    """The C++ chains over each row's first and last pixel and counts a
    row's columns as an interval; the reference chains over every pixel
    and tests every pixel of the box: the counts must not differ."""
    ref_hull, ref_solidity = reference
    for k in range(25):
        labels, max_label = ellipses(25 * seed + k)
        np.testing.assert_array_equal(native.hull_pixel_counts(labels, max_label),
                                      ref_hull(labels, max_label))
        assert native.solidity(labels, max_label).tobytes() == \
            ref_solidity(labels, max_label).tobytes()


def test_a_batch_equals_its_sites(reference):
    """The step's call: one ``(B, H, W)`` stack, hull and pixel counts of
    every site from one scan, equal to the reference site by site."""
    ref_hull, ref_solidity = reference
    stack = np.stack([CASES[f"blobs_{s}"][0] for s in range(6)])
    stack[2, :5] = 40  # an id above max_label across a whole band
    got = native.solidity_batch(stack, 16)
    assert got.shape == (6, 16) and got.dtype == np.float32
    assert got.tobytes() == np.stack([ref_solidity(site, 16) for site in stack]).tobytes()
    hull, area = native.hull_and_area_counts(stack, 16)
    np.testing.assert_array_equal(hull, np.stack([ref_hull(site, 16) for site in stack]))
    np.testing.assert_array_equal(area, np.stack(
        [np.bincount(np.where(site <= 16, site, 0).ravel(), minlength=17)[1:]
         for site in stack]))
    assert native.solidity_batch(stack[:0], 16).shape == (0, 16)


def test_hand_computed_counts():
    labels, _ = CASES["hand"]
    assert native.hull_pixel_counts(labels, 2).tolist() == [6, 4]
    assert native.solidity(labels, 2)[0] == np.float32(5.0 / 6.0)
    small, _ = CASES["small_and_collinear"]
    assert native.hull_pixel_counts(small, 8).tolist() == [1, 2, 2, 2, 6, 7, 4, 0]
    assert native.solidity(small, 8)[7] == 0.0


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """A broken source is an error, never a quiet switch to the numpy
    version."""
    bad = tmp_path / "hull.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "HOST_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(BuildError, match="failed"):
        native.solidity(CASES["hand"][0], 2)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(BuildError, match="no host compiler"):
        native.build()


def test_sites_must_be_two_dimensional():
    with pytest.raises(ValueError):
        native.hull_pixel_counts(np.zeros((2, 4, 4), np.int32), 3)
    with pytest.raises(ValueError):
        native.solidity(np.zeros((2, 4, 4), np.int32), 3)
    with pytest.raises(ValueError):
        native.solidity_batch(np.zeros((4, 4), np.int32), 3)
