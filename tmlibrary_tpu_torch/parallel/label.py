"""Connected components and watershed over a spatially sharded mosaic.

Counterpart: ``tmlibrary_tpu/parallel/label.py:45-684``
(``distributed_connected_components`` and ``_2d``,
``sharded_segment_mosaic`` and ``_2d``,
``distributed_watershed_from_seeds`` and ``_2d``).  An object that
crosses a seam between two ranks' blocks must get one id on both sides,
numbered in ``scipy.ndimage.label``'s scan order over the whole mosaic,
bit for bit, at any mesh shape.

Connected components, in three steps:

1. each rank labels its block with the CC kernel
   (:func:`~tmlibrary_tpu_torch.ops.kernels.cc_min_propagate`, table
   row 2): every pixel gets its component's minimum row-major index in
   the block, which maps to the global index by a monotone change of
   coordinates, so it is the component's minimum global index within
   the block;
2. each rank pairs the labels that touch across its lower and right
   seams (and, at 8-connectivity on a tile mesh, its two lower corners);
   the pairs of every rank are gathered, and each rank joins them into
   equivalence classes whose representative is the class's minimum, the
   component's first pixel in the whole mosaic;
3. roots (pixels whose label is their own global index) are gathered as
   sorted lists, and a pixel's id is its label's rank among them plus
   one, the reference's all-gather and ``searchsorted``.

A rank that holds more than ``max_roots_per_shard`` roots raises
:class:`ShardingError`, as the reference's static root table does.  The
reference joins seams in rounds until a ``psum`` of change flags is 0;
joining the gathered pairs once gives the same classes.

The watershed runs the level-ordered flood of
:func:`~tmlibrary_tpu_torch.ops.kernels.watershed_flood_plain` with
global levels (the masked minimum and maximum reduced over the ranks)
and one adopt step at a time, each on the block extended by a 1-pixel
halo of the neighbours' labels (zero at the mosaic's border, the
single-device shift fill), until no rank changes: the synchronous
schedule of the whole image, so every tie breaks the same way.

Like :mod:`.halo`, the ``*_block`` functions take and return this
rank's block, so :func:`segment_mosaic_block` and
:func:`watershed_block` keep the smoothed mosaic, its mask and both
label images sharded (Otsu's cut is taken from the blocks' histograms
summed over the ranks); the reference's names take the full mosaic and
return the full result on every member rank, on a mesh of row bands or
of tiles alike (the reference's ``_2d`` names are the same functions).
A mesh of one rank calls the single-device op on the whole mosaic (the
reference's one-device shortcut, ``:109-113``, ``:623-635``), so on one
card the whole mosaic goes through the CC and watershed kernels.

The block functions take an optional ``mark``, called with a stage's
name when its work has been queued (the jterator step's stage clock).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tmlibrary_tpu_torch.errors import ShardingError
from tmlibrary_tpu_torch.ops import kernels
from tmlibrary_tpu_torch.ops.histogram import histogram_counts
from tmlibrary_tpu_torch.ops.label import compact_roots
from tmlibrary_tpu_torch.ops.segment_secondary import _adopt_step, watershed_from_seeds
from tmlibrary_tpu_torch.ops.threshold import _otsu_argmax, otsu_bins, otsu_value
from tmlibrary_tpu_torch.parallel import distributed
from tmlibrary_tpu_torch.parallel.halo import exchange_edges, gather_blocks, gaussian_smooth_block
from tmlibrary_tpu_torch.parallel.mesh import Mesh

#: linear labels are int32, as the reference's ``_BIG`` is
_INT32_PIXELS = 2**31 - 1


def _noop(stage: str) -> None:
    pass


def _check(h: int, w: int, mesh: Mesh, connectivity: int) -> tuple[int, int]:
    mesh.check_divides(h, w)
    if connectivity not in (4, 8):
        raise ValueError("connectivity must be 4 or 8")
    if h * w >= _INT32_PIXELS:
        raise ValueError(f"mosaic {h}x{w} too large for int32 linear labels")
    return h, w


def _seam_pairs(lab: torch.Tensor, msk: torch.Tensor, mesh: Mesh,
                connectivity: int) -> torch.Tensor:
    """``(P, 2)`` int64 pairs of global labels that touch across this
    block's lower and right seams and lower corners."""
    pairs = []

    def join(a_lab, a_msk, b_lab, b_msk, diagonal: bool):
        # a: this block's edge (n,), b: the neighbour's facing edge (n,)
        n = a_lab.shape[0]
        for d in ((-1, 0, 1) if diagonal else (0,)):
            lo, hi = max(0, -d), min(n, n - d)
            if lo >= hi:
                continue
            ok = a_msk[lo:hi] & b_msk[lo + d:hi + d]
            pairs.append(torch.stack([a_lab[lo:hi][ok], b_lab[lo + d:hi + d][ok]], 1))

    diag = connectivity == 8
    # rows: the next block's top row against this bottom row
    _, below = exchange_edges(torch.stack([lab[0].double(), msk[0].double()]),
                              torch.stack([lab[-1].double(), msk[-1].double()]), mesh, 0)
    if below is not None:
        join(lab[-1], msk[-1], below[0].long(), below[1].bool(), diag)
    # columns: the right block's left column against this right column
    _, right = exchange_edges(torch.stack([lab[:, 0].double(), msk[:, 0].double()]),
                              torch.stack([lab[:, -1].double(), msk[:, -1].double()]), mesh, 1)
    if right is not None:
        join(lab[:, -1], msk[:, -1], right[0].long(), right[1].bool(), diag)
    if diag and mesh.grid[1] > 1:
        # lower corners: the diagonal neighbours' facing corner pixels
        corners = torch.stack([lab[0, 0], msk[0, 0], lab[0, -1], msk[0, -1]]).double()
        parts = distributed.all_gather(corners, mesh.group)
        r, c = mesh.coords()
        for dc, mine, theirs in ((1, (-1, -1), 0), (-1, (-1, 0), 2)):
            nb = mesh.rank_at(r + 1, c + dc)
            if nb is not None and bool(msk[mine]) and bool(parts[nb][theirs + 1]):
                pairs.append(torch.stack([lab[mine], parts[nb][theirs].long()])[None])
    if not pairs:
        return torch.zeros((0, 2), dtype=torch.int64, device=lab.device)
    return torch.cat(pairs).to(torch.int64)


def _join_classes(pairs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(nodes, root)``: the sorted labels that appear in ``pairs`` and
    each one's class minimum."""
    nodes, inv = np.unique(pairs.ravel(), return_inverse=True)
    edges = inv.reshape(-1, 2)
    root = np.arange(len(nodes))
    while True:
        m = np.minimum(root[edges[:, 0]], root[edges[:, 1]])
        new = root.copy()
        np.minimum.at(new, edges[:, 0], m)
        np.minimum.at(new, edges[:, 1], m)
        new = new[new]  # nodes are sorted: the index minimum is the label minimum
        if np.array_equal(new, root):
            return nodes, nodes[root]
        root = new


def cc_block(block: torch.Tensor, mesh: Mesh, h: int, w: int, connectivity: int = 8,
             max_roots_per_shard: int = 4096, mark=_noop) -> tuple[torch.Tensor, torch.Tensor]:
    """Label this rank's block of an ``(h, w)`` mask sharded on ``mesh``
    (row bands or tiles); ids ``1..N`` in scipy scan order over the whole
    mosaic.  Returns ``(label block, count)``; raises
    :class:`ShardingError` when a shard holds more than
    ``max_roots_per_shard`` components."""
    _check(h, w, mesh, connectivity)
    block = block.to(torch.bool).contiguous()
    local = kernels.cc_min_propagate(block[None], connectivity)
    mark("cc_min_propagate")
    if mesh.size == 1:
        labels, count = compact_roots(block[None], local)
        mark("compaction")
        return labels[0], count[0]
    local = local[0].to(torch.int64)
    ys, xs = mesh.block_slices(h, w)
    bh, bw = block.shape
    gy = (ys.start + torch.arange(bh, device=block.device, dtype=torch.int64))[:, None]
    gx = (xs.start + torch.arange(bw, device=block.device, dtype=torch.int64))[None, :]
    linear = gy * w + gx
    lab = torch.where(block, (ys.start + local // bw) * w + xs.start + local % bw,
                      torch.full_like(local, -1))

    pairs = _seam_pairs(lab, block, mesh, connectivity)
    every = torch.cat(distributed.all_gather_rows(pairs, mesh.group)).cpu().numpy()
    if len(every):
        nodes, roots = _join_classes(every)
        nodes_t = torch.from_numpy(nodes).to(lab.device)
        roots_t = torch.from_numpy(roots).to(lab.device)
        at = torch.clamp(torch.searchsorted(nodes_t, lab), max=len(nodes) - 1)
        lab = torch.where(block & (nodes_t[at] == lab), roots_t[at], lab)

    is_root = block & (lab == linear)
    roots = torch.sort(linear[is_root]).values
    gathered = distributed.all_gather_rows(roots, mesh.group)
    most = max(len(g) for g in gathered)
    if most > max_roots_per_shard:
        raise ShardingError(f"a shard holds {most} components > "
                            f"max_roots_per_shard={max_roots_per_shard}; raise the bound")
    all_roots = torch.sort(torch.cat(gathered)).values
    rank = torch.searchsorted(all_roots, lab)
    out = torch.where(block, rank + 1, torch.zeros_like(rank)).to(torch.int32)
    mark("compaction")
    return out, torch.tensor(len(all_roots), dtype=torch.int32)


def distributed_connected_components(
    mask: torch.Tensor, mesh: Mesh, connectivity: int = 8, max_roots_per_shard: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`cc_block` over a full ``(H, W)`` mask, gathered on every
    member rank; raises :class:`ShardingError` when the sides do not
    divide the mesh."""
    if mask.dim() != 2:
        raise ValueError(f"expected an (H, W) mosaic, got {tuple(mask.shape)}")
    h, w = _check(*mask.shape, mesh, connectivity)
    labels, count = cc_block(mesh.block(mask), mesh, h, w, connectivity, max_roots_per_shard)
    return gather_blocks(labels, mesh, h, w), count


#: the reference's name for the tile mesh: one function serves both
distributed_connected_components_2d = distributed_connected_components


def sharded_otsu_value(block: torch.Tensor, mesh: Mesh, valid: torch.Tensor | None = None,
                       bins: int = 256) -> torch.Tensor:
    """Otsu's cut over every rank's block (only its ``valid`` pixels when
    given), bit-identical to
    :func:`~tmlibrary_tpu_torch.ops.threshold.otsu_value` of the whole
    image: the range is reduced over the ranks and the integer histograms
    summed.  A float32 scalar."""
    vals = (block if valid is None else block[valid]).to(torch.float32).reshape(1, -1)
    if mesh.size == 1:
        return otsu_value(vals, bins)[0]
    inf = torch.full((1,), float("inf"), device=vals.device)
    lo = vals.amin(dim=1) if vals.numel() else inf
    hi = vals.amax(dim=1) if vals.numel() else -inf
    lo = distributed.all_reduce(lo, dist.ReduceOp.MIN, mesh.group)
    hi = distributed.all_reduce(hi, dist.ReduceOp.MAX, mesh.group)
    idx, centers = otsu_bins(vals, lo, hi, bins)
    counts = distributed.all_reduce(histogram_counts(idx, bins), group=mesh.group)
    return _otsu_argmax(counts.to(torch.float32), centers)[0]


def segment_mosaic_block(block: torch.Tensor, mesh: Mesh, h: int, w: int, sigma: float = 1.5,
                         threshold=None, valid: torch.Tensor | None = None,
                         connectivity: int = 8, mark=_noop) -> tuple[torch.Tensor, torch.Tensor]:
    """Smooth, threshold and label this rank's block of an ``(h, w)``
    mosaic: halo-exact Gaussian, Otsu's cut over the whole smoothed mosaic
    (its ``valid`` pixels when given) when ``threshold`` is None, then
    :func:`cc_block`.  Returns ``(label block, count)``."""
    smoothed = gaussian_smooth_block(block.to(torch.float32), mesh, sigma)
    mark("smooth")
    t = sharded_otsu_value(smoothed, mesh, valid) if threshold is None else torch.tensor(
        float(threshold), dtype=torch.float32, device=block.device)
    mark("otsu")
    return cc_block(smoothed > t, mesh, h, w, connectivity, mark=mark)


def sharded_segment_mosaic(intensity, mesh: Mesh, sigma: float = 1.5,
                           threshold: float | None = None, connectivity: int = 8):
    """:func:`segment_mosaic_block` over a full mosaic, gathered on every
    member rank.  Returns ``(labels, count)``."""
    img = torch.as_tensor(intensity).to(torch.float32)
    h, w = img.shape
    labels, count = segment_mosaic_block(mesh.block(img), mesh, h, w, sigma, threshold,
                                         connectivity=connectivity)
    return gather_blocks(labels, mesh, h, w), count


sharded_segment_mosaic_2d = sharded_segment_mosaic


# ---------------------------------------------------------------- watershed
def _halo1_zero(lab: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``(bh + 2, bw + 2)``: the block with a 1-pixel ring of its
    neighbours' labels, corners included, zero at the mosaic's border."""
    zero_row = torch.zeros_like(lab[:1])
    up, down = exchange_edges(lab[:1], lab[-1:], mesh, 0)
    ext = torch.cat([zero_row if up is None else up, lab, zero_row if down is None else down])
    zero_col = torch.zeros_like(ext[:, :1])
    left, right = exchange_edges(ext[:, :1], ext[:, -1:], mesh, 1)
    return torch.cat([zero_col if left is None else left, ext,
                      zero_col if right is None else right], dim=1)


def watershed_block(img: torch.Tensor, lab: torch.Tensor, msk: torch.Tensor, mesh: Mesh,
                    n_levels: int = 32, connectivity: int = 8) -> torch.Tensor:
    """Level-ordered watershed flooding of this rank's blocks of a mosaic
    sharded on ``mesh`` (intensity, seeds, mask), bit-identical to the
    block of
    :func:`~tmlibrary_tpu_torch.ops.segment_secondary.watershed_from_seeds`
    on the whole mosaic."""
    img, lab, msk = img.to(torch.float32), lab.to(torch.int32), msk.to(torch.bool)
    if mesh.size == 1:
        return watershed_from_seeds(img[None], lab[None], msk[None], n_levels=n_levels,
                                    connectivity=connectivity)[0]
    if connectivity not in (4, 8):
        raise ValueError("connectivity must be 4 or 8")
    img, lab, msk = img.contiguous(), lab.contiguous(), msk.contiguous()
    msk = msk | (lab > 0)
    inf = torch.tensor(float("inf"), device=img.device)
    lo = distributed.all_reduce(torch.where(msk, img, inf).amin()[None], dist.ReduceOp.MIN,
                                mesh.group)
    hi = distributed.all_reduce(torch.where(msk, img, -inf).amax()[None], dist.ReduceOp.MAX,
                                mesh.group)
    levels = kernels.levels_from_range(lo, hi, n_levels)[0]

    def flood(labels, allowed):
        allowed_ext = torch.nn.functional.pad(allowed, (1, 1, 1, 1), value=False)
        while True:
            new = _adopt_step(_halo1_zero(labels, mesh)[None], allowed_ext[None],
                              connectivity)[0, 1:-1, 1:-1]
            changed = distributed.any_rank(bool((new != labels).any()), img.device, mesh.group)
            labels = new
            if not changed:
                return labels

    for i in range(n_levels):
        lab = flood(lab, msk & (img >= levels[i]))
    lab = flood(lab, msk)
    return torch.where(msk, lab, torch.zeros_like(lab))


def distributed_watershed_from_seeds(intensity, seeds, mask, mesh: Mesh, n_levels: int = 32,
                                     connectivity: int = 8) -> torch.Tensor:
    """:func:`watershed_block` over full mosaics, gathered on every
    member rank."""
    intensity = torch.as_tensor(intensity)
    h, w = intensity.shape
    mesh.check_divides(h, w)
    blocks = (mesh.block(torch.as_tensor(t)) for t in (intensity, seeds, mask))
    return gather_blocks(watershed_block(*blocks, mesh, n_levels, connectivity), mesh, h, w)


distributed_watershed_from_seeds_2d = distributed_watershed_from_seeds
