"""The block union-find CC kernels' algorithm, pinned on the CPU.

``csrc/cc_union_find.cuh`` (shared by ``csrc/cc_min_propagate.cu`` and
``csrc/cc3d_min_propagate.cu``) runs on the card only.  Here a numpy
model of its three phases -- runs along x and local unions in a tile's
shared memory, unions across tile borders in global memory, flatten --
runs every union and every find as a coroutine that yields after each
load and each atomicMin, and a
seeded scheduler interleaves them in a random order (all at once, or a
few neighbours at a time, as a block's warps contend for one tile's
roots), so union-loop retries after a lost race happen as on the card.
The interleavings are sequentially consistent: a fault that needs the
card's weaker memory order (path compression during the unions lost
unions on the card and never here) is out of the model's reach, which
is why the kernels' finds write nothing while unions run.  Every write is
checked against the invariant the kernels' headers argue (``parent[p] <=
p`` and in ``p``'s component).  The model's labels are held bit for bit
against ``kernels.cc_min_propagate_plain`` and
``volume.cc3d_min_propagate_plain`` under every seed, and on the edge
sites against the Pallas kernels in interpret mode.
"""

import random
import zlib

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from chip_smoke import spiral_site
from tmlibrary_tpu.ops import pallas_kernels as jpk
from tmlibrary_tpu_torch import benchmarks
from tmlibrary_tpu_torch.ops import kernels as tk
from tmlibrary_tpu_torch.ops import volume as tv

torch.set_num_threads(1)

BIG = tk.BIG
SEEDS = (0, 1, 2)
#: the 13 backward offsets of the 26-neighbourhood, in the kernel's order
#: (``uf_offset``)
OFFSETS = ([(-1, j // 3 - 1, j % 3 - 1) for j in range(9)]
           + [(0, -1, dx) for dx in (-1, 0, 1)] + [(0, 0, -1)])


def in_neighbourhood(o, connectivity):
    nonzero = sum(d != 0 for d in o)
    return connectivity == 26 or nonzero == 1 or (connectivity == 18 and nonzero == 2)


def implied(o, below, north):
    """``uf_implied``: the edge is implied by face and in-plane edges."""
    dz, dy, dx = o
    return (dz == -1 and (dy or dx) and below) or (dz == 0 and dy == -1 and dx and north)


class Labels:
    """A label array whose every write checks the invariant: a label is
    ``BIG``, or at most its own index and in the same component.
    ``comp[p]`` is p's component (scipy's labels) in ``index(p)``'s
    frame; ``index`` maps a slot to the linear index it stands for."""

    def __init__(self, values, comp, index):
        self.v, self.comp, self.index = values, comp, index

    def check(self, p, value):
        assert self.index(value) <= self.index(p), (p, value)
        assert self.comp[self.index(value)] == self.comp[self.index(p)], (p, value)

    def atomic_min(self, p, value):
        old = self.v[p]
        if value < old:
            self.check(p, value)
            self.v[p] = value
        return old

    def store(self, p, value):
        self.check(p, value)
        self.v[p] = value


def find(lab, x):
    """``uf_find_*``: walk to the root, no writes (the kernels flatten only
    after the last union)."""
    while True:
        up = lab.v[x]
        yield
        if up == x:
            return x
        x = up


def union(lab, a, b):
    """``uf_union_shared`` / ``uf_union_global``: link the larger root under
    the smaller with an atomicMin; on a lost race go on with the new
    parent."""
    while True:
        a = yield from find(lab, a)
        b = yield from find(lab, b)
        if a == b:
            return
        if a > b:
            a, b = b, a
        old = lab.atomic_min(b, a)
        yield
        if old == b:
            return
        b = old


def flatten(lab, p):
    """Phase 3 for one voxel: its label to the root, a plain store."""
    l = lab.v[p]
    yield
    if l == BIG:
        return
    r = yield from find(lab, l)
    if r != l:
        lab.store(p, r)


def interleave(coroutines, rng, window=None):
    """Advance the coroutines one memory operation at a time, a randomly
    chosen one each step, until all have returned.  With ``window``, only
    that many neighbouring ones are live at a time, in their given order
    (as a block's warps run a tile's voxels), so they contend for the same
    roots."""
    queue = iter(coroutines)
    live = list(coroutines) if window is None else [c for _, c in zip(range(window), queue)]
    while live:
        i = rng.randrange(len(live))
        try:
            next(live[i])
        except StopIteration:
            nxt = next(queue, None) if window is not None else None
            if nxt is not None:
                live[i] = nxt
            else:
                live[i] = live[-1]
                live.pop()


#: live coroutines a seed runs: a few neighbours contending, a warp, all
WINDOWS = (4, 32, None)


def model_labels(mask, connectivity, tile, seed):
    """The three phases on one ``(Z, H, W)`` volume with ``tile`` =
    (TZ, TY, TX), every phase's unions interleaved by ``seed``."""
    Z, H, W = mask.shape
    TZ, TY, TX = tile
    rng = random.Random(seed)
    window = WINDOWS[seed % len(WINDOWS)]
    structure = ndi.generate_binary_structure(3, {6: 1, 18: 2, 26: 3}[connectivity])
    comp = ndi.label(mask, structure)[0].reshape(-1)
    flat = mask.reshape(-1)
    offsets = [o for o in OFFSETS if in_neighbourhood(o, connectivity) and not (TZ == 1 and o[0])]
    labels = np.full(Z * H * W, BIG, np.int64)

    def g(z, y, x):
        return (z * H + y) * W + x

    # phase 1: each tile, its unions interleaved; tiles in a random order
    tiles = [(z0, y0, x0) for z0 in range(0, Z, TZ) for y0 in range(0, H, TY)
             for x0 in range(0, W, TX)]
    rng.shuffle(tiles)
    for z0, y0, x0 in tiles:
        local = [(a, b, c) for a in range(TZ) for b in range(TY) for c in range(TX)]

        def glob(t, z0=z0, y0=y0, x0=x0):
            a, b, c = local[t]
            return g(z0 + a, y0 + b, x0 + c)

        def fg_at(a, b, c, z0=z0, y0=y0, x0=x0):
            z, y, x = z0 + a, y0 + b, x0 + c
            return z < Z and y < H and x < W and bool(flat[g(z, y, x)])

        def local_index(a, b, c):
            return (a * TY + b) * TX + c

        # each voxel starts at the first voxel of its run along x (the W
        # edges need no union)
        start = []
        for t, (a, b, c) in enumerate(local):
            first = c
            while first > 0 and fg_at(a, b, first - 1) and fg_at(a, b, c):
                first -= 1
            start.append(t - c + first)
        shared = Labels(start, comp, glob)
        work = []
        for t, (a, b, c) in enumerate(local):
            if not fg_at(a, b, c):
                continue
            below = a > 0 and fg_at(a - 1, b, c)
            north = b > 0 and fg_at(a, b - 1, c)
            west = c > 0 and fg_at(a, b, c - 1)
            for o in offsets:
                if o == (0, 0, -1):
                    continue
                aa, bb, cc = a + o[0], b + o[1], c + o[2]
                if implied(o, below, north) or aa < 0 or not 0 <= bb < TY or not 0 <= cc < TX:
                    continue
                # a face edge implied by W, W's face edge and the target's run
                if not fg_at(aa, bb, cc) or (o[2] == 0 and west and fg_at(aa, bb, cc - 1)):
                    continue
                work.append(union(shared, t, local_index(aa, bb, cc)))
        interleave(work, rng, window)
        roots = {}

        def output(t, z, y, x):
            roots[g(z, y, x)] = glob((yield from find(shared, t)))

        interleave([output(t, z0 + a, y0 + b, x0 + c) for t, (a, b, c) in enumerate(local)
                    if fg_at(a, b, c)], rng, window)
        for p, r in roots.items():
            labels[p] = r

    lab = Labels(labels, comp, lambda p: p)
    for p in np.flatnonzero(flat):  # phase 1's output already meets the invariant
        lab.check(p, labels[p])

    # phase 2: every tile's border unions at once, interleaved
    work = []
    for p in np.flatnonzero(flat):
        z, r = divmod(int(p), H * W)
        y, x = divmod(r, W)
        a, b, c = z % TZ, y % TY, x % TX
        below = z > 0 and flat[p - H * W]
        north = y > 0 and flat[p - W]
        west = c > 0 and flat[p - 1]
        for o in offsets:
            aa, bb, cc = a + o[0], b + o[1], c + o[2]
            if implied(o, below, north) or (aa >= 0 and 0 <= bb < TY and 0 <= cc < TX):
                continue
            zz, yy, xx = z + o[0], y + o[1], x + o[2]
            if zz < 0 or not 0 <= yy < H or not 0 <= xx < W or not flat[g(zz, yy, xx)]:
                continue
            if o[2] == 0 and west and flat[g(zz, yy, xx) - 1]:
                continue  # implied by W, W's own crossing edge and the target's run
            work.append(union(lab, int(p), g(zz, yy, xx)))
    interleave(work, rng, window)

    # phase 3: every voxel at once, interleaved with the others' stores
    interleave([flatten(lab, p) for p in range(Z * H * W)], rng, window)
    return labels.reshape(Z, H, W).astype(np.int32)


# ------------------------------------------------------------------ sites
def serpentine(h, w):
    m = np.zeros((h, w), bool)
    for r in range(0, h, 4):
        m[r, :] = True
        if r + 4 < h:
            m[r : r + 5, w - 1 if (r // 4) % 2 == 0 else 0] = True
    return m


def spiral(h, w):
    """A 1-px foreground corridor from the border to the centre in a
    rectangular spiral (the background corridor of the smoke's
    ``spiral_site``), cropped or padded to ``h`` x ``w``."""
    cells = max(1, (min(h, w) - 1) // 2)
    corridor = ~spiral_site(torch, cells).numpy()
    out = np.zeros((h, w), bool)
    ch, cw = min(h, corridor.shape[0]), min(w, corridor.shape[1])
    out[:ch, :cw] = corridor[:ch, :cw]
    return out


def site(name, h, w):
    rng = np.random.default_rng(zlib.crc32(f"{name}{h}x{w}".encode()))
    if name == "empty":
        return np.zeros((h, w), bool)
    if name == "full":
        return np.ones((h, w), bool)
    if name == "single":
        m = np.zeros((h, w), bool)
        m[h - 1, w - 1] = True
        return m
    if name == "serpentine":
        return serpentine(h, w)
    if name == "spiral":
        return spiral(h, w)
    if name == "checkerboard":
        return (np.add.outer(np.arange(h), np.arange(w)) % 2) == 0
    if name == "noise":
        return rng.random((h, w)) < 0.45
    if name == "blobs":  # the Otsu-style cut of the synthetic DAPI channel
        dapi = benchmarks.synthetic_cell_painting_batch(1, size=max(h, w), seed=3)["DAPI"][0]
        dapi = dapi[:h, :w]
        return dapi > np.quantile(dapi, 0.8)
    raise KeyError(name)


SITES = ["empty", "full", "single", "serpentine", "spiral", "checkerboard", "noise", "blobs"]
SHAPES_2D = [(64, 64), (70, 45), (1, 97), (97, 1)]
TILES_2D = [(1, 32, 32), (1, 8, 8), (1, 1, 1), (1, 5, 7)]


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("shape", SHAPES_2D, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", SITES)
def test_union_find_model_matches_plain_2d(name, shape, connectivity):
    """Every tile shape and union order gives the plain version's labels
    bit for bit (2-D connectivity 4 and 8 are the kernel's 6 and 26 on
    one plane)."""
    m = site(name, *shape)
    want = tk.cc_min_propagate_plain(torch.from_numpy(m[None]), connectivity).numpy()[0]
    conn3 = 6 if connectivity == 4 else 26
    tiles = TILES_2D if shape == (64, 64) or name in ("spiral", "noise") else TILES_2D[:2]
    for tile in tiles:
        for seed in SEEDS:
            got = model_labels(m[None], conn3, tile, seed)[0]
            np.testing.assert_array_equal(got, want, err_msg=f"tile {tile}, seed {seed}")


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("name", ["serpentine", "spiral", "checkerboard", "noise"])
def test_union_find_model_matches_pallas_on_edge_sites(name, connectivity):
    """On a ragged 70x45 site the model equals the TPU kernel in interpret
    mode (the reference's fixpoint), which equals scipy's components."""
    m = site(name, 70, 45)
    want = np.asarray(jpk.cc_min_propagate(m, connectivity, interpret=True))
    conn3 = 6 if connectivity == 4 else 26
    for seed in SEEDS:
        np.testing.assert_array_equal(model_labels(m[None], conn3, (1, 32, 32), seed)[0], want)


def volume(name, shape):
    z, h, w = shape
    rng = np.random.default_rng(zlib.crc32(f"{name}{shape}".encode()))
    if name == "empty":
        return np.zeros(shape, bool)
    if name == "full":
        return np.ones(shape, bool)
    if name == "single":
        m = np.zeros(shape, bool)
        m[-1, -1, -1] = True
        return m
    if name == "noise":  # near the 3-D site-percolation thresholds
        return rng.random(shape) < 0.3
    if name == "checkerboard":
        zz, yy, xx = np.indices(shape)
        return (zz + yy + xx) % 2 == 0
    if name == "serpentine":  # the 2-D serpentine on every other plane, joined at a corner
        m = np.zeros(shape, bool)
        m[::2] = serpentine(h, w)
        m[:, 0, 0] = True
        return m
    if name == "blobs":  # the synthetic z-stack's nuclei
        vol = benchmarks.synthetic_volume_batch(1, size=max(h, w), depth=max(z, 8),
                                                seed=3)["DAPI"][0]
        vol = vol[:z, :h, :w]
        return vol > np.quantile(vol, 0.85)
    raise KeyError(name)


VOLUMES = ["empty", "full", "single", "noise", "checkerboard", "serpentine", "blobs"]
SHAPES_3D = [(8, 32, 32), (3, 17, 29), (1, 20, 33)]
TILES_3D = [(4, 8, 8), (2, 3, 5)]


@pytest.mark.parametrize("connectivity", [6, 18, 26])
@pytest.mark.parametrize("shape", SHAPES_3D, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", VOLUMES)
def test_union_find_model_matches_plain_3d(name, shape, connectivity):
    m = volume(name, shape)
    want = tv.cc3d_min_propagate_plain(torch.from_numpy(m[None]), connectivity).numpy()[0]
    seeds = SEEDS if shape != (8, 32, 32) else SEEDS[:1]
    for tile in TILES_3D:
        for seed in seeds:
            got = model_labels(m, connectivity, tile, seed)
            np.testing.assert_array_equal(got, want, err_msg=f"tile {tile}, seed {seed}")


@pytest.mark.parametrize("connectivity", [6, 18, 26])
@pytest.mark.parametrize("name", ["noise", "serpentine"])
def test_union_find_model_matches_pallas_3d(name, connectivity):
    m = volume(name, (3, 17, 29))
    want = np.asarray(jpk.cc3d_min_propagate(m, connectivity, interpret=True, chunk=1))
    for seed in SEEDS:
        np.testing.assert_array_equal(model_labels(m, connectivity, (2, 16, 32), seed), want)


def test_model_catches_a_link_by_plain_store():
    """The model's interleaving is live: with the atomicMin of the union
    loop replaced by a load and a later plain store (the fault the
    kernels' headers rule out), concurrent links to one root overwrite
    each other and a noise site loses unions under some order."""
    m = site("noise", 40, 40)
    want = tk.cc_min_propagate_plain(torch.from_numpy(m[None]), 8).numpy()[0]
    real = union

    def union_plain_store(lab, a, b):
        while True:
            a = yield from find(lab, a)
            b = yield from find(lab, b)
            if a == b:
                return
            if a > b:
                a, b = b, a
            old = lab.v[b]
            yield
            lab.store(b, a)
            if old == b:
                return
            b = old

    lost = 0
    for seed in SEEDS:
        globals()["union"] = union_plain_store
        try:
            got = model_labels(m[None], 26, (1, 1, 1), seed)[0]
        finally:
            globals()["union"] = real
        lost += not np.array_equal(got, want)
    assert lost > 0
