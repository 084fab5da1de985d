"""Row 7, the distance transform, on the CPU: a numpy model of the card's
two passes against the closed form and the JAX package.

``csrc/distance_transform.cu`` computes ``min(D, max_distance + 1)``
(D the chessboard distance to the nearest in-image background pixel,
none: infinite) as a column pass -- g, the vertical distance to the
nearest background pixel of the column, saturated at the sentinel
``reach`` -- and a row pass that grows r for four neighbouring pixels at
a time until each window minimum of g is <= r.  :func:`two_pass_model`
repeats both passes step by step as the kernel takes them: the 256-row
chunks of the column pass, their 32-row segments as words of background
bits, the values folded into each from above and below (those from
below left by a bottom-to-top sweep in the first row of the chunk
beneath), the padded rows of g, the
row minimum shortcut, the four windows sharing their ends, the entries
past a row's ends read as ``reach``.  The model and the public wrapper
on the CPU (its plain version) are held bit for bit against the closed
form (scipy's chessboard transform), the TPU kernel in Pallas interpret
mode (caps up to 64: its erosion loop runs the cap's steps on full
sites) and the reference's XLA loop and native two-pass chamfer at every
cap, 255, 300 and 1000 included: the port takes every ``max_distance >=
0``, as the reference does.  The CUDA kernel itself is held against the
plain version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from test_torch_declump import _edge_masks, closed_form
from tmlibrary_tpu.ops import pallas_kernels as jpk
from tmlibrary_tpu.ops import segment_primary as j_sp
from tmlibrary_tpu_torch import benchmarks
from tmlibrary_tpu_torch.ops import kernels as tk
from tmlibrary_tpu_torch.ops import label as t_label
from tmlibrary_tpu_torch.ops import smooth as t_smooth
from tmlibrary_tpu_torch.ops import threshold as t_threshold

torch.set_num_threads(1)

CAPS = [0, 1, 2, 64, 254, 255, 300, 1000]
#: rows of a column-pass chunk and of its segments, columns of a strip
#: (``DT_CHUNK``, ``DT_SEG``, ``DT_STRIP``)
CHUNK, SEG, STRIP = 256, 32, 32
N = 600  # the 1xN and Nx1 sites: three chunks of the column pass


# ----------------------------------------------------------------- model
def _last(bits):
    """Per lane: the highest set bit of a segment's background word, -1
    where none (``31 - __clz``)."""
    return np.array([b.bit_length() - 1 for b in bits])


def _first(bits):
    """Per lane: the lowest set bit, -1 where none (``__ffs - 1``)."""
    return np.array([(b & -b).bit_length() - 1 for b in bits])


def _words(sm, rows):
    """Each segment's (first row, rows) and background word per column."""
    segs = [(r0, min(SEG, rows - r0)) for r0 in range(0, rows, SEG)]
    return segs, [[sum(1 << i for i in range(n) if not sm[r0 + i, c]) for c in range(STRIP)]
                  for r0, n in segs]


def _fold_up(up, segs, words, reach, to):
    """The value from below folded up to the top of segment ``to``."""
    for j in range(len(segs) - 1, to - 1, -1):
        e = _first(words[j])
        up = np.where(e >= 0, np.minimum(e, reach), np.minimum(up + segs[j][1], reach))
    return up


def column_pass(mask: np.ndarray, reach: int, pitch: int) -> np.ndarray:
    """g of one ``(H, W)`` site as ``dt_columns`` writes it: strips of 32
    columns (past the image: foreground), 256-row chunks cut into 8
    segments of 32 rows, each a word of background bits per column.  A
    row's value is the least of its distances to the last background bit
    at or above it and the first at or below it in the word, or, where
    there is none on a side, the value entering the segment from that
    side plus the offset -- folded over the segments beyond it (one with a
    background bit passes on its distance from its last or first bit, one
    without adds its length) from ``carry`` (the chunk above's last row)
    or from the value at the first row of the chunk beneath, which a
    bottom-to-top sweep leaves in that row of g; saturated at ``reach``,
    rows padded to ``pitch`` entries."""
    h, w = mask.shape
    g = np.zeros((h, pitch), np.int64)
    for x0 in range(0, w, STRIP):
        strip = np.ones((h, STRIP), bool)
        cols = min(STRIP, w - x0)
        strip[:, :cols] = mask[:, x0 : x0 + cols]
        gcols = min(STRIP, pitch - x0)
        chunks = list(range(0, h, CHUNK))
        up = np.full(STRIP, reach)
        for y0 in reversed(chunks[1:]):  # the values from below
            rows = min(CHUNK, h - y0)
            segs, words = _words(strip[y0 : y0 + rows], rows)
            up = _fold_up(up, segs, words, reach, 0)
            g[y0, x0 : x0 + gcols] = up[:gcols]
        carry = np.full(STRIP, reach)
        for y0 in chunks:
            rows = min(CHUNK, h - y0)
            below = g[y0 + rows, x0 : x0 + STRIP] if y0 + rows < h else np.full(STRIP, reach)
            below = np.concatenate([below[:gcols], np.full(STRIP - gcols, reach)])
            segs, words = _words(strip[y0 : y0 + rows], rows)
            for k, (r0, n) in enumerate(segs):
                down = carry
                for j in range(k):  # the segments above are whole
                    e = _last(words[j])
                    down = np.where(e >= 0, np.minimum(SEG - 1 - e, reach),
                                    np.minimum(down + SEG, reach))
                up_in = _fold_up(below, segs, words, reach, k + 1)
                for i in range(n):
                    a = _last([b & (2 ** (i + 1) - 1) for b in words[k]])
                    f = _first([b >> i for b in words[k]])
                    d = np.where(a >= 0, i - a, down + i + 1)
                    u = np.where(f >= 0, f, up_in + n - i)
                    g[y0 + r0 + i, x0 : x0 + gcols] = np.minimum(np.minimum(d, u), reach)[:gcols]
                if r0 + n == rows:
                    e = _last(words[k])
                    carry = np.minimum(np.where(e >= 0, n - 1 - e, down + n), reach)
    return g


def row_pass(g: np.ndarray, w: int, reach: int, cap: int) -> np.ndarray:
    """``dt_row`` on every row of one site: a row whose least g reaches
    ``reach`` is written at ``cap``; else each quad of 4 pixels shifts in
    the window ends g[x0 - r] and g[x0 + 3 + r] (``reach`` past the row)
    until each pixel's window minimum is <= r, and an r of ``reach``
    is written as ``cap``."""
    h = g.shape[0]
    out = np.zeros((h, w), np.float32)
    nq = (w + 3) // 4
    x0 = 4 * np.arange(nq)

    def at(i):
        return np.where((i >= 0) & (i < w), g[:, np.clip(i, 0, w - 1)], reach)

    least = g[:, :w].min(axis=1)
    a = [at(x0 + j) for j in range(4)]
    b = list(a)
    m = list(a)
    res = [np.where((m[j] == 0) | (x0 + j >= w), 0, -1) for j in range(4)]
    r = 0
    while any((rj < 0).any() for rj in res):
        r += 1
        assert r <= reach  # every m_j <= reach: found by r = reach at the latest
        a = [at(x0 - r)] + a[:3]
        b = b[1:] + [at(x0 + 3 + r)]
        for j in range(4):
            m[j] = np.minimum(m[j], np.minimum(a[j], b[j]))
            res[j] = np.where((res[j] < 0) & (m[j] <= r), r, res[j])
    for j in range(4):
        v = np.where(res[j] < reach, res[j], cap).astype(np.float32)
        v[least >= reach] = cap
        keep = x0 + j < w
        out[:, (x0 + j)[keep]] = v[:, keep]
    return out


def two_pass_model(masks: np.ndarray, max_distance: int) -> np.ndarray:
    r = tk.distance_reach(masks.shape, max_distance)
    h, w = masks.shape[-2:]
    return np.stack([row_pass(column_pass(m, r.reach, r.pitch), w, r.reach, r.cap)
                     for m in masks])


def scipy_closed_form(mask: np.ndarray, max_distance: int) -> np.ndarray:
    """``min(D, max_distance + 1)`` on the foreground from scipy's
    chessboard transform (-1 where a site has no background: D infinite)."""
    d = ndi.distance_transform_cdt(mask, metric="chessboard").astype(np.int64)
    d[d < 0] = max_distance + 1
    return np.minimum(d, max_distance + 1).astype(np.float32)


# ----------------------------------------------------------------- masks
@pytest.fixture(scope="module")
def declump_masks():
    """Path D's input: filled Otsu masks of the smoothed DAPI sites."""
    data = benchmarks.synthetic_cell_painting_batch(2, size=64, n_cells=8, seed=1)
    sm = t_smooth.gaussian_smooth(torch.from_numpy(data["DAPI"]), 1.5)
    return t_label.fill_holes(t_threshold.threshold_otsu(sm)).numpy()


def _mask_cases():
    rng = np.random.default_rng(8)
    edge = _edge_masks()
    centre = np.ones((48, 48), bool)
    centre[24, 24] = False
    ragged = np.ones((257, 130), bool)
    for _ in range(6):
        y, x = rng.integers(0, 257), rng.integers(0, 130)
        ragged[y, x] = False
    ragged[:40, :3] = False
    wide = np.ones((1, N), bool)
    wide[0, [7, 300, 301]] = False
    tall = np.ones((N, 1), bool)
    tall[[0, 420], 0] = False
    return {**{k: v[None] for k, v in edge.items()},
            "noise": (rng.random((2, 40, 44)) < 0.45),
            "centre": centre[None], "257x130": ragged[None],
            "1xN": wide[None], "Nx1": tall[None]}


MASKS = _mask_cases()


def _masks(case, declump_masks):
    return declump_masks if case == "declump" else MASKS[case]


# ----------------------------------------------------------------- holds
@pytest.mark.parametrize("case", ["declump", *MASKS])
@pytest.mark.parametrize("max_distance", CAPS)
def test_two_pass_model_and_wrapper_match_closed_form_xla_and_native(
        declump_masks, case, max_distance):
    masks = _masks(case, declump_masks)
    got = two_pass_model(masks, max_distance)
    plain = tk.distance_transform(torch.from_numpy(masks), max_distance).numpy()
    np.testing.assert_array_equal(got, plain)
    for g, m in zip(got, masks):
        np.testing.assert_array_equal(g, scipy_closed_form(m, max_distance))
        for method in ("xla", "native"):
            np.testing.assert_array_equal(g, np.asarray(
                j_sp.distance_transform_approx(m, max_distance, method=method)))


@pytest.mark.parametrize("case", ["declump", "full", "border", "noise", "centre", "1xN"])
@pytest.mark.parametrize("max_distance", [c for c in CAPS if c <= 64])
def test_two_pass_model_matches_pallas_interpret(declump_masks, case, max_distance):
    masks = _masks(case, declump_masks)
    got = two_pass_model(masks, max_distance)
    for g, m in zip(got, masks):
        np.testing.assert_array_equal(
            g, np.asarray(jpk.distance_transform(m, max_distance, interpret=True)))


@pytest.mark.parametrize("case", list(_edge_masks()))
def test_scipy_closed_form_is_the_brute_force_one(case):
    """The scipy closed form above equals the brute-force one of the
    declumping tests on the edge masks, at a cap each reaches and not."""
    m = _edge_masks()[case]
    for cap in (2, 300):
        np.testing.assert_array_equal(scipy_closed_form(m, cap), closed_form(m, cap))


def test_row_pass_steps_follow_the_distance():
    """A pixel costs its own distance + 1 steps: on a site with one
    background pixel the row pass runs until the farthest pixel of a quad
    finds it, and a row with no g below ``reach`` takes no step."""
    m = np.ones((1, 9, 9), bool)
    m[0, 4, 4] = False
    r = tk.distance_reach(m.shape, 254)
    g = column_pass(m[0], r.reach, r.pitch)
    assert r.reach == 9 and (g[:, 4] == np.abs(np.arange(9) - 4)).all()
    assert (g[:, [0, 1, 2, 3, 5, 6, 7, 8]] == r.reach).all()
    assert g.shape == (9, 16) and (g[:, 9:] == r.reach).all()  # the padded entries
    out = row_pass(g, 9, r.reach, r.cap)
    yy, xx = np.mgrid[:9, :9]
    np.testing.assert_array_equal(out, np.maximum(abs(yy - 4), abs(xx - 4)))


# -------------------------------------------------------- sentinel mapping
@pytest.mark.parametrize("shape, max_distance, cap, reach, pitch, dtype", [
    ((64, 256, 256), 64, 65, 65, 256, torch.uint8),     # path D: the cap is in reach
    ((64, 256, 256), 254, 255, 255, 256, torch.uint8),
    ((64, 256, 256), 300, 301, 256, 256, torch.int16),  # no in-image D reaches 256
    ((1, 257, 130), 1000, 1001, 257, 144, torch.int16),
    ((1, 1, 600), 0, 1, 1, 608, torch.uint8),
    ((1, 600, 1), 2, 3, 3, 16, torch.uint8),
    ((1, 1, 70000), 10**6, 10**6 + 1, 70000, 70000, torch.int32),  # past 16 bits
    ((1, 1, 70000), 2**31 - 1, 2**24, 70000, 70000, torch.int32),
    ((1, 2**25, 1), 2**31 - 1, 2**24, 2**24, 16, torch.int32),  # float32's whole numbers
])
def test_distance_reach_maps_the_sentinel(shape, max_distance, cap, reach, pitch, dtype):
    r = tk.distance_reach(shape, max_distance)
    assert (r.cap, r.reach, r.pitch, r.dtype) == (cap, reach, pitch, dtype)
    assert r.reach >= min(r.cap, max(shape[-2:]))  # no in-image D reads as the sentinel


def test_cap_beyond_float32_whole_numbers_matches_the_plain_sum():
    """The cap stops at 2**24 where the plain version's float32 sum of ones
    stops growing (checked on that sum, not by running 2**24 erosions)."""
    ones = torch.ones(3, dtype=torch.float32)
    total = torch.tensor(float(2**24 - 1)) + ones[0]
    assert float(total + ones[1]) == 2**24 == tk.distance_reach((1, 4, 4), 2**30).cap


def test_design_levers_append_their_variants(tmp_path):
    """The lever script's source is the shipped kernel with the designs it
    measures (one block a site, halving over a table of window minima,
    and the shipped steps up to r = 8 before it) and their entry points
    appended; a shipped source without the pieces they build on stops
    it."""
    from pathlib import Path

    from tmlibrary_tpu_torch.levers import distance_designs

    csrc = Path(tk.__file__).resolve().parent.parent / "csrc"
    shipped = (csrc / "distance_transform.cu").read_text()
    src = distance_designs.variant_source(csrc)
    assert src.startswith(shipped) and "DBL_ENTRY(dbl_doubling, false)" in src
    assert "DBL_ENTRY(dbl_hybrid, true)" in src and 'extern "C" int dsg_site(' in src
    assert "tm_distance_transform_site" not in shipped
    (tmp_path / "distance_transform.cu").write_text(shipped.replace("dt_columns<", "dt_cols<"))
    with pytest.raises(SystemExit):
        distance_designs.variant_source(tmp_path)
