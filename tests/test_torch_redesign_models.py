"""The redesigned ``grouped_stats`` and ``watershed3d_flood`` kernels'
algorithms, pinned on the CPU.

``csrc/grouped_stats.cu`` and ``csrc/watershed3d_flood.cu`` run on the
card only.  Here a numpy model of each design is held against the plain
version (and the 3-D flood's plain version against the Pallas kernel in
interpret mode):

- ``grouped_stats``: the box pass (pixels cut into bands, each band's
  warps pooling the z/y/x ranges of the lanes that share a label, one
  lane widening the site's box) and the walk (each object's 3-D box in
  row segments of 32 pixels, eight to a tile, the chain adding each
  channel's object pixels in pixel order) -- sums bit-exact, min and max
  exact and NaN-propagating, ids outside 1..K dropped, boxes that take
  3-D planes.
- ``watershed3d_flood``: the cluster route's frontier flood -- bands,
  level-start scans, owner claims with PENDING (the owner invariant
  asserted at every claim), directions, lists that never outgrow the
  volume -- on tied plateaus, id edges (above 16 bits, at 2**31 - 1, negative), odd
  shapes, Z=1 and 1, 8 and 254 levels.
"""

import numpy as np
import pytest
import torch

from tmlibrary_tpu.ops import pallas_kernels as jpk
from tmlibrary_tpu_torch.ops import fused_measure as fm
from tmlibrary_tpu_torch.ops import volume as tv

torch.set_num_threads(1)

f32 = np.float32


# ---------------------------------------------------- grouped_stats model
def gs_boxes_model(labels, planes, K, bands):
    """The box pass of one site: ``{k: [z0, z1, y0, y1, x0, x1]}`` for the
    ids 1..K present, pooled warp by warp within each band of pixels."""
    rows, w = labels.shape
    h = rows // planes
    flat = labels.reshape(-1)
    n = flat.size
    per = -(-n // bands)
    box = {}
    for b in range(bands):
        start, end = b * per, min(n, b * per + per)
        table = {}
        for warp0 in range(start, end, 32):
            p = np.arange(warp0, min(warp0 + 32, end))
            lab = flat[p]
            keep = (lab >= 1) & (lab <= K)
            r, x = np.divmod(p, w)
            z, y = np.divmod(r, h)
            for k in np.unique(lab[keep]):
                sel = lab == k
                got = [z[sel].min(), z[sel].max(), y[sel].min(), y[sel].max(),
                       x[sel].min(), x[sel].max()]
                old = table.get(k, got)
                table[k] = [min(old[0], got[0]), max(old[1], got[1]), min(old[2], got[2]),
                            max(old[3], got[3]), min(old[4], got[4]), max(old[5], got[5])]
        for k, t in table.items():
            old = box.get(k, t)
            box[k] = [min(old[0], t[0]), max(old[1], t[1]), min(old[2], t[2]),
                      max(old[3], t[3]), min(old[4], t[4]), max(old[5], t[5])]
    return box


def gs_walk_model(labels, values, planes, k, b):
    """The walk of object ``k``'s box ``b``: tiles of 8 segments of 32
    pixels in (z, y, x) order; returns the channels' (sum, min, max) and
    the pixel indices the chain consumed, in order."""
    rows, w = labels.shape
    h = rows // planes
    z0, z1, y0, y1, x0, x1 = b
    ny, per_row = y1 - y0 + 1, (x1 - x0 + 32) // 32
    segs = (z1 - z0 + 1) * ny * per_row
    n_ch = values.shape[0]
    s = np.zeros(n_ch, f32)
    lo = np.full(n_ch, np.inf, f32)
    hi = np.full(n_ch, -np.inf, f32)
    order = []
    flat_l, flat_v = labels.reshape(-1), values.reshape(n_ch, -1)
    for t in range(-(-segs // 8)):
        for seg in range(t * 8, min(t * 8 + 8, segs)):
            r, xs = divmod(seg, per_row)
            zz, yy = z0 + r // ny, y0 + r % ny
            x = x0 + xs * 32 + np.arange(32)
            x = x[x <= x1]
            p = (zz * h + yy) * w + x
            for q in p[flat_l[p] == k]:  # the ballot's set bits, low lane first
                v = flat_v[:, q]
                s = (s + v).astype(f32)
                lo = np.minimum(lo, v)
                hi = np.maximum(hi, v)
                order.append(int(q))
    return s, lo, hi, order


def gs_model(labels, values, K, planes=1, bands=3):
    """``(sums, mins, maxs)`` ``(K, C)`` of one site by the kernel's two
    passes, asserting that each chain consumed exactly its object's
    pixels in increasing pixel order."""
    n_ch = values.shape[0]
    sums = np.zeros((K, n_ch), f32)
    mins = np.full((K, n_ch), np.inf, f32)
    maxs = np.full((K, n_ch), -np.inf, f32)
    for k, b in gs_boxes_model(labels, planes, K, bands).items():
        s, lo, hi, order = gs_walk_model(labels, values, planes, k, b)
        assert order == np.flatnonzero(labels.reshape(-1) == k).tolist()
        sums[k - 1], mins[k - 1], maxs[k - 1] = s, lo, hi
    return sums, mins, maxs


def _label_site(kind, rng):
    """(labels (rows, W), values (C, rows, W), planes, K)."""
    if kind == "blobs":
        lab = np.zeros((70, 90), np.int32)
        for k in range(1, 15):
            y, x = rng.integers(0, 60), rng.integers(0, 80)
            lab[y : y + rng.integers(2, 14), x : x + rng.integers(2, 40)] = k
        lab[3:9, 60:70] = 40  # above K: dropped
        lab[50:52, 1:3] = -2  # negative: dropped
        return lab, 3, 1, 32
    if kind == "full":  # every slot present, a 2x2 object each
        lab = (np.arange(64 * 64) // 2 % 32 + (np.arange(64 * 64) // 128) * 32 + 1)
        lab = lab.reshape(64, 64).astype(np.int32)
        lab[lab > 1024] = 0
        return lab, 2, 1, 1024
    if kind == "site":  # one object as large as the site
        return np.ones((64, 96), np.int32), 7, 1, 4
    if kind == "volume":  # (Z*H, W) view of a 6x20x33 volume
        lab = np.zeros((6, 20, 33), np.int32)
        lab[1:5, 3:12, 2:30] = 1
        lab[0:6, 10:18, 5:9] = 2
        lab[2, 0:20, 20:33] = 3
        return lab.reshape(120, 33), 6, 6, 8
    if kind == "wide":  # more than a launch's channels
        lab = np.zeros((40, 70), np.int32)
        lab[5:30, 3:66] = 1
        lab[10:20, 20:40] = 2
        return lab, 33, 1, 2
    raise ValueError(kind)


GS_KINDS = ["blobs", "full", "site", "volume", "wide"]


@pytest.mark.parametrize("kind", GS_KINDS)
@pytest.mark.parametrize("nan", [False, True])
def test_grouped_stats_model_matches_plain_bit_for_bit(kind, nan):
    rng = np.random.default_rng(2)
    lab, n_ch, planes, K = _label_site(kind, rng)
    vals = (rng.random((n_ch, *lab.shape), dtype=np.float32) * 4000 + 200).astype(f32)
    vals[-1] = (vals[0] * vals[0]).astype(f32)
    if nan:
        ys, xs = np.nonzero(lab == 1)
        vals[0, ys[len(ys) // 2], xs[len(xs) // 2]] = np.nan
    got = gs_model(lab, vals, K, planes)
    shape = (1, planes, -1, lab.shape[1]) if planes > 1 else (1, *lab.shape)  # volumes 4-D
    want = fm.grouped_stats_plain(torch.from_numpy(lab).reshape(shape),
                                  [torch.from_numpy(v).reshape(shape) for v in vals], K)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_.numpy()[0])
    if nan:
        assert np.isnan(got[1][0, 0]) and np.isnan(got[0][0, 0])
        assert not np.isnan(got[1][1:, 0]).any()


@pytest.mark.parametrize("bands", [1, 2, 7, 64])
def test_grouped_stats_boxes_do_not_depend_on_bands(bands):
    """The box of every object is its exact (z, y, x) range, whatever the
    bands and however a band cuts a row."""
    rng = np.random.default_rng(bands)
    lab, _, planes, K = _label_site("volume", rng)
    got = gs_boxes_model(lab, planes, K, bands)
    vol = lab.reshape(planes, -1, lab.shape[1])
    for k in range(1, K + 1):
        zz, yy, xx = np.nonzero(vol == k)
        if not len(zz):
            assert k not in got
            continue
        assert got[k] == [zz.min(), zz.max(), yy.min(), yy.max(), xx.min(), xx.max()]


def test_grouped_stats_3d_boxes_skip_other_planes():
    """A 3-D box walks fewer rows than the (Z*H, W) view's 2-D box, and the
    sums are the same bits."""
    rng = np.random.default_rng(0)
    lab, n_ch, planes, K = _label_site("volume", rng)
    vals = (rng.random((n_ch, *lab.shape), dtype=np.float32) * 100).astype(f32)
    b3 = gs_boxes_model(lab, planes, K, 2)[1]
    b2 = gs_boxes_model(lab, 1, K, 2)[1]
    rows3 = (b3[1] - b3[0] + 1) * (b3[3] - b3[2] + 1)
    assert rows3 < b2[3] - b2[2] + 1
    for a, b in zip(gs_model(lab, vals, K, planes), gs_model(lab, vals, K, 1)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------- 3-D flood model
DIRS3 = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
         if (dz, dy, dx) != (0, 0, 0)]
PENDING3, NEVER3 = np.iinfo(np.int32).min, 0xFF


def w3_levels(img, seeds, mask, n_levels):
    mp = mask | (seeds > 0)
    lo = np.minimum.reduce(img[mp], initial=f32(np.inf))
    hi = np.maximum.reduce(img[mp], initial=f32(-np.inf))
    d = f32(hi - lo)
    span = d if np.isnan(d) else max(d, f32(1e-6))
    return np.array([f32(hi - f32(f32(span * f32(i + 1)) / f32(n_levels)))
                     for i in range(n_levels)], f32)


def _nb3(lab, pts):
    """(k, 26) labels around voxels ``pts`` (k, 3); beyond the volume,
    PENDING and negative ids read as 0."""
    out = np.zeros((len(pts), 26), np.int64)
    for j, d in enumerate(DIRS3):
        q = pts + np.array(d)
        ok = ((q >= 0) & (q < np.array(lab.shape))).all(axis=1)
        v = np.zeros(len(pts), np.int64)
        v[ok] = lab[tuple(q[ok].T)]
        out[:, j] = np.maximum(v, 0)
    return out


def w3_cluster_model(img, seeds, mask, n_levels, rng):
    """The cluster route's flood of one volume; returns the labels and the
    length of every step's list."""
    assert n_levels <= tv.W3_MAX_LEVELS
    levels = w3_levels(img, seeds, mask, n_levels)
    a = np.zeros(img.shape, np.int64)
    b = np.full(img.shape, n_levels, np.int64)
    while (a < b).any():  # the kernel's binary search
        act = a < b
        mid = (a + b) >> 1
        ge = img >= levels[np.minimum(mid, n_levels - 1)]
        b = np.where(act & ge, mid, b)
        a = np.where(act & ~ge, mid + 1, a)
    band = np.where((seeds == 0) & mask, a, NEVER3)
    lab = seeds.astype(np.int64).copy()
    lengths = []

    def claim(pts):
        pts = pts[rng.permutation(len(pts))]
        lengths.append(len(pts))
        best = _nb3(lab, pts)
        lab[tuple(pts.T)] = PENDING3
        band[tuple(pts.T)] = best.argmax(axis=1)
        return pts

    def scan(li):
        pts = np.argwhere((lab == 0) & (band == li))
        has = _nb3(lab, pts).max(axis=1, initial=0) > 0 if len(pts) else np.zeros(0, bool)
        return claim(pts[has])

    def from_front(front, li):
        fset = set(map(tuple, front.tolist()))
        shape = np.array(lab.shape)
        cand = set()
        for j, d in enumerate(DIRS3):  # the thread of each listed f, direction j
            q = front + np.array(d)
            q = q[((q >= 0) & (q < shape)).all(axis=1)]
            q = q[(lab[tuple(q.T)] == 0) & (band[tuple(q.T)] <= li)]
            nb = _nb3(lab, q)
            own = (nb.max(axis=1, initial=0) > 0) & (nb.argmax(axis=1) == 25 - j)  # f owns q
            cand.update(map(tuple, q[own].tolist()))
        pts = np.array(sorted(cand), np.int64).reshape(-1, 3)
        # every labelled neighbour of a candidate was labelled at the last
        # step (so the owner is listed), and every candidate has one owner
        nb = _nb3(lab, pts)
        for i, q in enumerate(pts):
            for j in np.flatnonzero(nb[i] > 0):
                assert tuple(q + np.array(DIRS3[j])) in fset
        want = np.argwhere((lab == 0) & (band <= li))
        has = _nb3(lab, want).max(axis=1, initial=0) > 0 if len(want) else np.zeros(0, bool)
        assert set(map(tuple, want[has].tolist())) == cand  # no candidate missed
        return claim(pts)

    for li in range(n_levels + 1):
        pts = scan(li)
        while len(pts):
            j = band[tuple(pts.T)]
            src = pts + np.array(DIRS3)[j]
            lab[tuple(pts.T)] = lab[tuple(src.T)]
            pts = from_front(pts, li)
    mp = mask | (seeds > 0)
    return np.where(mp, lab, 0).astype(np.int32), lengths


def w3_volume(kind, rng):
    """(intensity, seeds, mask) volumes that break the 3-D flood."""
    shape = {"odd": (5, 37, 41), "z1": (1, 40, 44)}.get(kind, (8, 24, 24))
    zz, yy, xx = np.mgrid[0 : shape[0], 0 : shape[1], 0 : shape[2]]
    img = np.zeros(shape, f32)
    for _ in range(4):
        c = [rng.integers(0, s) for s in shape]
        img += np.exp(-((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2) / 18.0).astype(f32)
    img = (img + rng.random(shape, dtype=np.float32) * f32(0.05)).astype(f32)
    mask = img > 0.2
    seeds = np.zeros(shape, np.int32)
    inside = np.argwhere(mask)
    for k in range(1, 5):
        seeds[tuple(inside[rng.integers(0, len(inside))])] = k
    if kind == "plateau":  # flat, full mask, seeds at mirrored places
        img = np.ones(shape, f32)
        mask = np.ones(shape, bool)
        seeds[:] = 0
        seeds[4, 12, 6], seeds[4, 12, 18] = 1, 2
    elif kind == "ids":
        seeds[seeds == 1] = 70000
        seeds[seeds == 2] = 2**31 - 1
        seeds[2:4, 3:6, 3:6] = -5
        seeds[7, 0, 0:4] = -1
    elif kind == "nan":
        img[tuple(np.argwhere(mask & (seeds == 0))[0])] = np.nan
    return img, seeds, mask


W3_KINDS = ["blobs", "plateau", "ids", "odd", "z1", "nan"]


@pytest.mark.parametrize("kind", W3_KINDS)
def test_w3_cluster_model_matches_plain(kind):
    """The frontier model equals the plain Jacobi flood."""
    rng = np.random.default_rng(13)
    img, seeds, mask = w3_volume(kind, rng)
    assert tv.watershed3d_plan(8).route == "cluster"
    got, _ = w3_cluster_model(img, seeds, mask, 8, rng)
    want = tv.watershed3d_flood_plain(*(torch.from_numpy(a[None]) for a in (img, seeds, mask)),
                                      8).numpy()[0]
    np.testing.assert_array_equal(got, want)
    if kind == "plateau":  # equidistant from 1 and 2: the tie goes to 2
        assert got[4, 12, 12] == 2
    if kind == "ids":
        neg = seeds < 0
        assert (got[neg & mask] == seeds[neg & mask]).all() and (got[neg & ~mask] == 0).all()
        assert (got == 2**31 - 1).sum() > 1 and (got == 70000).sum() > 1


@pytest.mark.parametrize("kind", W3_KINDS)
def test_w3_cluster_lists_never_outgrow_the_volume(kind):
    """A voxel is claimed at most once over the whole flood, so the lists
    of all steps together hold at most the free voxels of the mask, and no
    step's list (sized as the volume in the kernel) can overflow."""
    rng = np.random.default_rng(17)
    img, seeds, mask = w3_volume(kind, rng)
    _, lengths = w3_cluster_model(img, seeds, mask, 8, rng)
    assert sum(lengths) <= int((mask & (seeds == 0)).sum()) <= img.size
    assert max(lengths) <= img.size


@pytest.mark.parametrize("n_levels", [1, 8, 254])
def test_w3_cluster_model_across_level_counts(n_levels):
    rng = np.random.default_rng(n_levels)
    img, seeds, mask = w3_volume("blobs", rng)
    want = tv.watershed3d_flood_plain(*(torch.from_numpy(a[None]) for a in (img, seeds, mask)),
                                      n_levels).numpy()[0]
    got, _ = w3_cluster_model(img, seeds, mask, n_levels, rng)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["ids", "odd"])
def test_w3_plain_matches_pallas_on_edge_volumes(kind):
    """The plain version the model is held to equals the TPU kernel in
    interpret mode (``chunk=1``) on the id edges and the odd shape."""
    img, seeds, mask = w3_volume(kind, np.random.default_rng(13))
    want = tv.watershed3d_flood_plain(*(torch.from_numpy(a[None]) for a in (img, seeds, mask)),
                                      8).numpy()[0]
    pallas = np.asarray(jpk.watershed3d_flood(img, seeds, mask, n_levels=8, interpret=True,
                                              chunk=1))
    np.testing.assert_array_equal(want, pallas)


def test_w3_255_levels_take_the_global_route_and_the_plain_flood():
    img, seeds, mask = w3_volume("blobs", np.random.default_rng(1))
    assert tv.watershed3d_plan(255).route == "global"
    got = tv.watershed3d_flood(*(torch.from_numpy(a[None]) for a in (img, seeds, mask)), 255)
    assert (got.numpy()[0][seeds > 0] == seeds[seeds > 0]).all()


def test_w3_offsets_are_lexicographic_with_opposites_at_25_minus_j():
    """The kernel's direction numbering (``w3_offset``)."""
    for j, d in enumerate(DIRS3):
        i = j if j < 13 else j + 1
        assert d == (i // 9 - 1, (i // 3) % 3 - 1, i % 3 - 1)
        assert DIRS3[25 - j] == tuple(-np.array(d))
