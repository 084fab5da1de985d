"""The redesigned flood kernels' algorithms, pinned on the CPU.

``csrc/watershed_flood.cu`` and ``csrc/fill_holes.cu`` run on the card
only; their plain versions (``ops/kernels.py``) are the Jacobi and sweep
fixpoints of the first designs.  Here a numpy model of each on-chip design -- the
watershed's per-pixel band, level-start scans, frontier claims with
PENDING, directions and list overflow; the fill's bit words, carry-chain
row passes, transposes and column passes -- is held against the plain
version, the TPU kernel in interpret mode, the XLA twin and scipy, on
sites chosen to break them: plateaus with ties, checkerboard masks, large
and negative seed ids, spirals and serpentines, odd sizes.  The models
serve these tests only.  The route planners are tested as pure functions.
The kernels themselves are held against the plain versions on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from tmlibrary_tpu.ops import pallas_kernels as jpk
from tmlibrary_tpu.ops.label import fill_holes as j_fill
from tmlibrary_tpu.ops.segment_secondary import watershed_from_seeds as j_ws
from tmlibrary_tpu_torch.errors import DeviceError
from tmlibrary_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)

#: neighbour j of the kernels (csrc/common.cuh tm_dy/tm_dx)
DIRS = [(-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (1, -1), (1, 1)]
PENDING, NEVER = 0xFFFF, 0xFF


# ------------------------------------------------------- watershed model
def ws_levels(intensity, seeds, mask, n_levels):
    """lo, hi, span and the levels in float32, one IEEE op at a time; a
    NaN in the mask makes lo, hi, the span and every level NaN, as in the
    plain version and the reference (the kernel's tm_nanmin/tm_nanmax/
    tm_span)."""
    mp = mask | (seeds > 0)
    f32 = np.float32
    lo = np.minimum.reduce(intensity[mp], initial=f32(np.inf))
    hi = np.maximum.reduce(intensity[mp], initial=f32(-np.inf))
    span = f32(hi - lo) if np.isnan(f32(hi - lo)) else max(f32(hi - lo), f32(1e-6))
    return np.array([f32(hi - f32(f32(span * f32(i + 1)) / f32(n_levels)))
                     for i in range(n_levels)], np.float32)


def ws_bands(intensity, seeds, mask, levels):
    """The kernel's band byte: binary search for the first level i with
    ``v >= levels[i]`` (``n_levels`` if none), 255 where never eligible."""
    n_levels = len(levels)
    a = np.zeros(intensity.shape, np.int64)
    b = np.full(intensity.shape, n_levels, np.int64)
    while (a < b).any():
        active = a < b
        mid = (a + b) >> 1
        ge = intensity >= levels[np.minimum(mid, n_levels - 1)]
        b = np.where(active & ge, mid, b)
        a = np.where(active & ~ge, mid + 1, a)
    return np.where((seeds == 0) & mask, a, NEVER)


def _neighbour_labels(lab, y, x, n_neigh):
    """(k, n_neigh) labels of the neighbours of pixels (y, x), PENDING and
    out-of-site read as 0."""
    h, w = lab.shape
    out = np.zeros((len(y), n_neigh), np.int64)
    for j, (dy, dx) in enumerate(DIRS[:n_neigh]):
        yy, xx = y + dy, x + dx
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = np.zeros(len(y), np.int64)
        v[ok] = lab[yy[ok], xx[ok]]
        out[:, j] = np.where(v == PENDING, 0, v)
    return out


def ws_onchip_model(intensity, seeds, mask, n_levels, connectivity, cap, rng):
    """The on-chip watershed of one site, step by step.  Claims within a
    step are order-free (PENDING reads as 0 and no positive label moves),
    so each step claims in a random order.  Returns the labels and the
    number of steps that overflowed their list."""
    h, w = seeds.shape
    n_neigh = connectivity
    assert seeds.max(initial=0) <= tk.WS_MAX_ID and n_levels <= tk.WS_MAX_LEVELS
    lab = np.where(seeds > 0, seeds, 0).astype(np.int64)
    band = ws_bands(intensity, seeds, mask, ws_levels(intensity, seeds, mask, n_levels))
    overflows = 0

    def claim(y, x):
        """PENDING, the direction of the largest neighbour label, listed."""
        order = rng.permutation(len(y))
        y, x = y[order], x[order]
        best = _neighbour_labels(lab, y, x, n_neigh)
        lab[y, x] = PENDING
        band[y, x] = best.argmax(axis=1)  # first neighbour holding the max
        return y, x

    def scan(li, exact):
        labelled = np.zeros((h, w), bool)
        yy, xx = np.nonzero((lab == 0) & ((band == li) if exact else (band <= li)))
        has = _neighbour_labels(lab, yy, xx, n_neigh).max(axis=1, initial=0) > 0
        labelled[yy[has], xx[has]] = True
        return claim(*np.nonzero(labelled))

    def from_front(fy, fx, li):
        cand = set()
        for dy, dx in DIRS[:n_neigh]:
            for y, x in zip(fy + dy, fx + dx):
                if 0 <= y < h and 0 <= x < w and lab[y, x] == 0 and band[y, x] <= li:
                    cand.add((y, x))
        cand = sorted(cand)
        y = np.array([c[0] for c in cand], np.int64)
        x = np.array([c[1] for c in cand], np.int64)
        # every labelled neighbour of a candidate was labelled at the last
        # step, so the listed pixel its largest label comes from claims it
        # (the kernel's owner rule: no two threads claim one pixel)
        nb = _neighbour_labels(lab, y, x, n_neigh)
        front = set(zip(fy.tolist(), fx.tolist()))
        for j in range(n_neigh):
            dy, dx = DIRS[j]
            for yy, xx in zip(y[nb[:, j] > 0] + dy, x[nb[:, j] > 0] + dx):
                assert (yy, xx) in front
        return claim(y, x)

    for li in range(n_levels + 1):
        y, x = scan(li, exact=True)
        while len(y):
            j = band[y, x]
            lab[y, x] = lab[y + np.array(DIRS)[j, 0], x + np.array(DIRS)[j, 1]]
            if len(y) > cap:  # the kernel resolved by a scan, and scans again
                overflows += 1
                y, x = scan(li, exact=False)
            else:
                y, x = from_front(y, x, li)
    mp = mask | (seeds > 0)
    return np.where(mp, np.where(seeds != 0, seeds, lab), 0).astype(np.int32), overflows


# ------------------------------------------------------------------ sites
def _blobs(rng, shape, n, r):
    img = np.zeros(shape, np.float32)
    yy, xx = np.mgrid[0 : shape[0], 0 : shape[1]]
    for _ in range(n):
        y, x = rng.integers(0, shape[0]), rng.integers(0, shape[1])
        img += np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * (r / 2) ** 2)).astype(np.float32)
    return img


def ws_site(kind, rng):
    """(intensity, seeds, mask) of a tie-heavy or id-edge site."""
    h, w = (37, 70) if kind == "odd" else (48, 48)
    img = _blobs(rng, (h, w), 5, 9) + np.float32(0.05)
    mask = img > 0.15
    seeds = np.zeros((h, w), np.int32)
    pts = [(5, 5), (5, w - 6), (h - 6, w // 2), (h // 2, w // 2)]
    for k, (y, x) in enumerate(pts, start=1):
        seeds[y, x] = k
    if kind == "plateau":  # flat image, full mask, seeds at equal distances
        img = np.ones((h, w), np.float32)
        mask = np.ones((h, w), bool)
        seeds[:] = 0
        seeds[h // 2, w // 4], seeds[h // 2, 3 * w // 4], seeds[h // 4, w // 2] = 1, 3, 2
    elif kind == "checker":  # mask of isolated diagonal pixels
        yy, xx = np.mgrid[0:h, 0:w]
        mask = ((yy + xx) % 2 == 0) | (yy == h // 2)
    elif kind == "ids":  # ids up to the 16-bit limit, and negative ids
        seeds[seeds == 1] = tk.WS_MAX_ID
        seeds[seeds == 2] = 40000
        seeds[10:14, 20:24] = -7
        seeds[30, 0:6] = -1
    elif kind == "steps":  # a staircase: every level has pixels exactly on it
        levels = ws_levels(img, seeds, mask, 16)
        img = levels[(np.arange(h * w) % 16).reshape(h, w)].copy()
        img[seeds > 0] = levels[0]
    return img, seeds, mask


WS_KINDS = ["blobs", "plateau", "checker", "ids", "steps", "odd"]


@pytest.mark.parametrize("kind", WS_KINDS)
@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("cap", [None, 3])
def test_watershed_model_matches_plain_pallas_and_xla(kind, connectivity, cap):
    """The frontier model, with full lists and with lists of 3 (most
    steps overflow into scans), equals the plain Jacobi flood, the TPU
    kernel in interpret mode and the XLA twin."""
    rng = np.random.default_rng(11)
    img, seeds, mask = ws_site(kind, rng)
    n_levels = 16
    want = tk.watershed_flood_plain(*(torch.from_numpy(a[None]) for a in (img, seeds, mask)),
                                    n_levels, connectivity).numpy()[0]
    plan = tk.watershed_plan(img.shape, n_levels, cap)
    got, overflows = ws_onchip_model(img, seeds, mask, n_levels, connectivity, plan.cap, rng)
    np.testing.assert_array_equal(got, want)
    assert (overflows > 0) == (cap == 3)
    pallas = np.asarray(jpk.watershed_flood(img, seeds, mask, n_levels=n_levels,
                                            connectivity=connectivity, interpret=True))
    np.testing.assert_array_equal(want, pallas)
    xla = np.asarray(j_ws(img, seeds, mask, n_levels=n_levels, connectivity=connectivity,
                          method="xla"))
    np.testing.assert_array_equal(want, xla)
    if kind == "plateau":  # equidistant from 1 and 3: the tie goes to 3
        assert got[img.shape[0] // 2, img.shape[1] // 2] == 3
    if kind == "ids":  # a negative seed keeps its value inside the mask
        neg = seeds < 0
        assert (got[neg & mask] == seeds[neg & mask]).all() and (got[neg & ~mask] == 0).all()
        assert (neg & mask).any()


@pytest.mark.parametrize("n_levels", [1, 2, 16, 32, 254])
def test_watershed_model_across_level_counts(n_levels):
    rng = np.random.default_rng(n_levels)
    img, seeds, mask = ws_site("blobs", rng)
    want = tk.watershed_flood_plain(*(torch.from_numpy(a[None]) for a in (img, seeds, mask)),
                                    n_levels).numpy()[0]
    got, _ = ws_onchip_model(img, seeds, mask, n_levels, 8,
                             tk.watershed_plan(img.shape, n_levels).cap, rng)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_levels", [1, 16, 32, 254])
@pytest.mark.parametrize("kind", ["blobs", "steps"])
def test_band_is_the_first_eligible_level(n_levels, kind):
    """Band b means: not eligible at any level before b, eligible at b and
    every later level (the plain version's ``intensity >= level``), with
    n_levels for pixels only the mop-up admits; seeds and pixels outside
    the mask never; pixels exactly on a level are eligible at it."""
    img, seeds, mask = ws_site(kind, np.random.default_rng(3))
    img = img.copy()
    levels_t = tk.watershed_levels(torch.from_numpy(img[None]),
                                   torch.from_numpy((mask | (seeds > 0))[None]), n_levels)[0]
    levels = levels_t.numpy()
    np.testing.assert_array_equal(levels, ws_levels(img, seeds, mask, n_levels))
    img[0, : min(n_levels, img.shape[1])] = levels[: img.shape[1]]  # exactly on a level
    img[1, 0] = np.nan  # only the mop-up admits it
    band = ws_bands(img, seeds, mask, levels)
    free = (seeds == 0) & mask
    assert (band[~free] == NEVER).all()
    eligible = img[..., None] >= levels[None, None, :]  # (h, w, n_levels)
    first = np.where(eligible.any(-1), eligible.argmax(-1), n_levels)
    np.testing.assert_array_equal(band[free], first[free])
    assert (eligible[free] == (np.arange(n_levels)[None, :] >= band[free][:, None])).all()
    on_level = free[0, : min(n_levels, img.shape[1])]
    assert (band[0, : min(n_levels, img.shape[1])][on_level]
            <= np.arange(min(n_levels, img.shape[1]))[on_level]).all()
    if free[1, 0]:
        assert band[1, 0] == n_levels


# ----------------------------------------------------------- fill model
def brev(x):
    """Bit reversal of uint32 words (the kernel's ``__brev``)."""
    x = x.astype(np.uint32)
    for shift, m in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F), (8, 0x00FF00FF),
                     (16, 0x0000FFFF)):
        m = np.uint32(m)
        x = ((x >> np.uint32(shift)) & m) | ((x & m) << np.uint32(shift))
    return x


def to_words(bits):
    """(rows, cols) bool -> (rows padded to 32, words) uint32, bit i of
    word k = column 32k + i."""
    rows, cols = bits.shape
    out = np.zeros((-(-rows // 32) * 32, -(-cols // 32) * 32), bool)
    out[:rows, :cols] = bits
    packed = np.packbits(out.reshape(out.shape[0], -1, 32), axis=-1, bitorder="little")
    if not packed.shape[1]:
        return np.zeros((out.shape[0], 0), np.uint32)
    return packed.view(np.uint32)[..., 0]


def from_words(words, rows, cols):
    bits = np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little")
    return bits.reshape(words.shape[0], -1)[:rows, :cols].astype(bool)


def transpose_words(words):
    """The warp-ballot transpose of 32x32 tiles, as a whole-plane bit
    transpose of the padded plane."""
    bits = from_words(words, words.shape[0], words.shape[1] * 32)
    return to_words(bits.T)


def fill_up(b, s):
    return (((b + s) ^ b) & b) | s


def row_pass(B, R, rows, nn, order):
    """The kernel's row pass, one row at a time in ``order`` (in place)."""
    words = B.shape[1]
    changed = False
    zero = np.uint32(0)
    for y in order[order < rows]:
        def vert(k):
            if k < 0 or k >= words:
                return zero
            return (R[y - 1, k] if y > 0 else zero) | (R[y + 1, k] if y + 1 < rows else zero)

        carry = zero
        for k in range(words):
            bw, old = B[y, k], R[y, k]
            s = old | carry
            if nn:
                v = vert(k)
                s |= v
                if nn == 8:
                    s |= (v << np.uint32(1)) | (v >> np.uint32(1)) | \
                        (vert(k - 1) >> np.uint32(31)) | (vert(k + 1) << np.uint32(31))
            f = fill_up(bw, s & bw)
            carry = f >> np.uint32(31)
            changed |= bool(f != old)
            R[y, k] = f
        carry = zero
        for k in range(words - 1, -1, -1):
            bw, old = B[y, k], R[y, k]
            s = (old | (carry << np.uint32(31))) & bw
            f = brev(np.array([fill_up(brev(np.array([bw]))[0], brev(np.array([s]))[0])]))[0]
            carry = f & np.uint32(1)
            changed |= bool(f != old)
            R[y, k] = f
    return changed


def fill_onchip_model(mask, connectivity, rng):
    """The on-chip fill of one site; returns the filled mask and the
    number of row passes."""
    h, w = mask.shape
    with np.errstate(over="ignore"):
        bg = ~mask
        border = np.zeros_like(mask)
        border[0, :] = border[-1, :] = border[:, 0] = border[:, -1] = True
        Bm, Rm = to_words(bg), to_words(bg & border)
        Bt = transpose_words(Bm)
        passes = 0
        while True:
            passes += 1
            if not row_pass(Bm, Rm, h, connectivity, rng.permutation(Bm.shape[0])):
                break
            Rt = transpose_words(Rm)
            row_pass(Bt, Rt, w, 0, rng.permutation(Bt.shape[0]))
            Rm = transpose_words(Rt)
    return ~from_words(Rm, h, w), passes


def spiral(kh, kw):
    """A one-pixel background corridor carved through foreground, from a
    door on the border to the centre in a rectangular spiral over a
    ``kh`` x ``kw`` grid of cells (so every turn needs another pass); its
    last cell is cut off, a hole."""
    m = np.ones((2 * kh + 1, 2 * kw + 1), bool)
    top, left, bottom, right = 0, 0, kh - 1, kw - 1
    order = []
    while top <= bottom and left <= right:
        order += [(top, j) for j in range(left, right + 1)]
        order += [(i, right) for i in range(top + 1, bottom + 1)]
        if top < bottom:
            order += [(bottom, j) for j in range(right - 1, left - 1, -1)]
        if left < right:
            order += [(i, left) for i in range(bottom - 1, top, -1)]
        top, left, bottom, right = top + 1, left + 1, bottom - 1, right - 1
    m[0, 1] = False  # the door
    for i, j in order:
        m[2 * i + 1, 2 * j + 1] = False
    for (a, b), (c, d) in zip(order[:-2], order[1:-1]):
        m[a + c + 1, b + d + 1] = False
    return m


def serpentine_mask(h, w):
    m = np.zeros((h, w), bool)
    for r in range(0, h, 4):
        m[r, :] = True
        if r + 4 < h:
            col = w - 1 if (r // 4) % 2 == 0 else 0
            m[r : r + 5, col] = True
    return m


def fill_site(kind, rng):
    if kind == "spiral":
        return spiral(20, 20)
    if kind == "spiral_odd":
        return spiral(21, 34)
    if kind == "serpentine":
        return serpentine_mask(48, 48)
    if kind == "closed_serpentine":  # every band closed at both ends: all holes
        m = serpentine_mask(48, 48)
        m[:, 0] = m[:, -1] = True
        return m
    if kind == "noise":
        return rng.random((40, 70)) < 0.45
    if kind == "diagonal":  # holes open only through diagonal gaps
        m = np.zeros((33, 33), bool)
        m[8:25, 8:25] = True
        m[12:21, 12:21] = False
        m[8, 8] = False
        m[9, 9] = False
        m[10:12, 10:12] = False
        return m
    return _blobs(rng, (64, 64), 8, 10) > 0.3  # "blobs"


FILL_KINDS = ["spiral", "spiral_odd", "serpentine", "closed_serpentine", "noise", "diagonal",
              "blobs"]


@pytest.mark.parametrize("kind", FILL_KINDS)
@pytest.mark.parametrize("connectivity", [4, 8])
def test_fill_model_matches_plain_pallas_and_scipy(kind, connectivity):
    rng = np.random.default_rng(7)
    m = fill_site(kind, rng)
    want = tk.fill_holes_flood_plain(torch.from_numpy(m[None]), connectivity).numpy()[0]
    got, passes = fill_onchip_model(m, connectivity, rng)
    np.testing.assert_array_equal(got, want)
    structure = ndi.generate_binary_structure(2, 1 if connectivity == 4 else 2)
    np.testing.assert_array_equal(want, ndi.binary_fill_holes(m, structure=structure))
    np.testing.assert_array_equal(
        want, np.asarray(jpk.fill_holes_flood(m, connectivity, interpret=True)))
    np.testing.assert_array_equal(want, np.asarray(j_fill(m, connectivity, method="xla")))
    if kind == "spiral" and connectivity == 4:  # a pass a turn or two
        assert passes > 10
        assert want[~m].sum() == 1  # the cut-off cell, and nothing else, filled
    if kind == "blobs":
        assert passes <= 4


def test_fill_words_and_transpose_round_trip():
    bits = np.random.default_rng(1).random((45, 70)) < 0.5
    words = to_words(bits)
    assert words.shape == (64, 3)
    np.testing.assert_array_equal(from_words(words, 45, 70), bits)
    np.testing.assert_array_equal(from_words(transpose_words(words), 70, 45), bits.T)
    with np.errstate(over="ignore"):
        # fill_up: seeds at bits 1 and 5 of the runs 1..3 and 5..6
        b, s = np.uint32(0b1101110), np.uint32(0b0100010)
        assert fill_up(b, s) == 0b1101110
        assert brev(np.array([1], np.uint32))[0] == 1 << 31


# -------------------------------------------------------------- planners
def test_watershed_plan_routes():
    main = tk.watershed_plan((64, 256, 256), 16)
    assert main.route == "onchip" and main.cap == 8448
    assert tk.watershed_plan((1, 256, 256), 254).route == "onchip"
    assert tk.watershed_plan((1, 256, 256), 255) == tk.FloodPlan("global")
    assert tk.watershed_plan((1, 256, 257), 16) == tk.FloodPlan("global")
    assert tk.watershed_plan((1, 1024, 1024), 16) == tk.FloodPlan("global")
    assert tk.watershed_plan((1, 255, 253), 32).route == "onchip"
    assert tk.watershed_plan((1, 8, 8), 4).cap == 64  # never more than the pixels
    assert tk.watershed_plan((1, 256, 256), 16, cap=3).cap == 3
    for bad in (0, 8449):
        with pytest.raises(ValueError):
            tk.watershed_plan((1, 256, 256), 16, cap=bad)


def test_fill_plan_routes():
    assert tk.fill_plane_bytes(256, 256) == 32 * 1024
    assert tk.fill_plane_bytes(255, 253) == 32 * 1024
    assert tk.fill_plan((64, 256, 256)) == tk.FloodPlan("onchip")
    assert tk.fill_plan((1, 672, 672)) == tk.FloodPlan("onchip")
    assert tk.fill_plan((1, 673, 672)) == tk.FloodPlan("global")
    assert tk.fill_plan((1, 1024, 1024)) == tk.FloodPlan("global")


@pytest.mark.parametrize("plan", [tk.FloodPlan("onchip", 16), tk.FloodPlan("global")])
@pytest.mark.parametrize("connectivity", [4, 8])
def test_flood_launchers_raise_off_the_card(plan, connectivity):
    """Every route's launcher checks the device before it touches the
    kernel library, and counts nothing when it cannot launch."""
    meta = torch.zeros((1, 8, 8), dtype=torch.bool, device="meta")
    before = (tk.fill_holes_flood.launches, tk.watershed_flood.launches)
    with pytest.raises(DeviceError):
        tk.watershed_flood_launcher(meta.float(), meta.int(), meta, 4, connectivity, plan,
                                    tk.watershed_flood)
    with pytest.raises(DeviceError):
        tk.fill_holes_launcher(meta, connectivity, tk.FloodPlan(plan.route),
                               tk.fill_holes_flood)
    assert (tk.fill_holes_flood.launches, tk.watershed_flood.launches) == before
