"""Core analytics ops: tiled kNN, randomized PCA, spectral embedding.

Counterpart: ``tmlibrary_tpu/analytics/ops.py``.  The reference leaves
all three to XLA (tall matmuls, ``lax.top_k``, QR/SVD, ``segment_sum``);
the port runs them in PyTorch on ``device`` (cuBLAS and ``torch.linalg``
on the card), in IEEE float32: matmuls on the card run with TF32 off
whatever the caller's global flag says.

kNN
    ``d2 = |q|^2 - 2 q @ x.T + |x|^2`` over query tiles of
    :func:`knn_tile_rows` rows (the last one padded, so every tile has
    one shape), then the k smallest.  ``lax.top_k`` breaks ties by the
    lowest index and ``torch.topk`` promises no order among equal
    values, so the k smallest are taken of an int64 key: the distance's
    float32 bits in IEEE total order in the high word, the column in
    the low word.
PCA
    Randomized range finder: ``Y = Xc @ G`` for JAX's Gaussian test
    matrix (:mod:`~tmlibrary_tpu_torch.analytics.rng`), QR-stabilised
    power iterations, the small projected SVD, each component's largest
    loading made positive.  It runs in float64 and returns float32: on a
    flat spectrum (the bench's iid population) the float32 iteration
    amplifies the summation order of its long products, so the card and
    the CPU part by more than the 1e-4 tier of ``chip_smoke.py``; in
    float64 they agree to float32 rounding, and each stays within the
    reference's own float32 error of the other.
Spectral embedding
    Median-bandwidth Gaussian weights on the kNN graph, then 60 steps of
    orthogonal iteration on ``D^-1/2 (W + W.T) D^-1/2`` with the trivial
    eigenvector deflated.  Its segment sums run in a fixed order, so a
    repeated call is bit-identical on the card: the forward half is a
    sum over each row's k neighbours, the transpose half a sum over a
    padded in-edge table built once by a stable argsort (no atomics).
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from tmlibrary_tpu_torch.analytics import rng
from tmlibrary_tpu_torch.device import resolve_device

#: budget for one (tile, N) float32 distance block
KNN_TILE_BLOCK_BYTES = 256 * 1024 * 1024

_TF32_LOCK = threading.RLock()


@contextlib.contextmanager
def float32_matmuls(device: torch.device):
    """IEEE float32 matmuls on the card (TF32 off) for the duration;
    nothing on the CPU."""
    if device.type != "cuda":
        yield
        return
    with _TF32_LOCK:
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """A float32 tensor of ``x`` on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    a = np.ascontiguousarray(x, np.float32)
    return torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)


def knn_tile_rows(n: int, block_bytes: int = KNN_TILE_BLOCK_BYTES) -> int:
    """Rows per query tile such that the (tile, n) float32 distance
    block stays under ``block_bytes`` (at least 8 rows)."""
    return max(8, min(n, block_bytes // max(1, 4 * n)))


def sq_norms(a: torch.Tensor) -> torch.Tensor:
    """Row sums of squares over the last axis."""
    return (a * a).sum(dim=-1)


def sq_distances(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The matmul expansion ``|q|^2 - 2 q @ x.T + |x|^2`` (Q, N)."""
    return sq_norms(q)[:, None] - (2.0 * q) @ x.T + sq_norms(x)[None]


def _ordered(d: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 keys in IEEE total order (-0.0 below +0.0)."""
    b = d.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def topk_smallest(d: torch.Tensor, k: int) -> torch.Tensor:
    """Column indices of the ``k`` smallest entries of each row of ``d``,
    smallest first, equal values by the lowest column (``lax.top_k`` of
    ``-d``)."""
    cols = torch.arange(d.shape[-1], device=d.device, dtype=torch.int64)
    key = (_ordered(d) << 32) | cols
    return torch.topk(key, k, dim=-1, largest=False, sorted=True).indices


def topk_largest(d: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries of each row, largest first,
    equal values by the lowest index (``lax.top_k``)."""
    cols = torch.arange(d.shape[-1], device=d.device, dtype=torch.int64)
    key = (_ordered(d) << 32) | (0x7FFFFFFF - cols)
    return torch.topk(key, k, dim=-1, largest=True, sorted=True).indices


def _knn_tile(q: torch.Tensor, x: torch.Tensor, base: int, k: int,
              exclude_self: bool) -> tuple[torch.Tensor, torch.Tensor]:
    d2 = sq_distances(q, x)
    if exclude_self:
        rows = base + torch.arange(q.shape[0], device=q.device)
        self_hit = torch.arange(x.shape[0], device=q.device)[None, :] == rows[:, None]
        d2 = d2 + torch.where(self_hit, float("inf"), 0.0)
    idx = topk_smallest(d2, k)
    dist = torch.sqrt(torch.clamp_min(torch.gather(d2, 1, idx), 0.0))
    return idx.to(torch.int32), dist


def knn(x, k: int, queries=None, tile: int | None = None,
        device: "str | torch.device" = "cuda") -> tuple[np.ndarray, np.ndarray]:
    """k nearest neighbours by brute force, tiled over the query axis:
    ``(indices (Q, k) int32, distances (Q, k) float32)``, nearest first.
    With ``queries=None`` the store queries itself and each row's own
    row is excluded; ``k`` is clamped to the population."""
    dev = resolve_device(device)
    xt = as_tensor(x, dev)
    n = int(xt.shape[0])
    self_query = queries is None
    q_all = xt if self_query else as_tensor(queries, dev)
    nq = int(q_all.shape[0])
    k = min(int(k), n - 1 if self_query else n)
    if k <= 0:
        return np.zeros((nq, 0), np.int32), np.zeros((nq, 0), np.float32)
    tile = int(tile) if tile else knn_tile_rows(n)
    idx_out = np.empty((nq, k), np.int32)
    dist_out = np.empty((nq, k), np.float32)
    with float32_matmuls(dev), torch.no_grad():
        for start in range(0, nq, tile):
            stop = min(start + tile, nq)
            q = q_all[start:stop]
            if stop - start < tile:  # one shape for every tile
                q = torch.nn.functional.pad(q, (0, 0, 0, tile - (stop - start)))
            idx, dist = _knn_tile(q, xt, start, k, self_query)
            idx_out[start:stop] = idx[: stop - start].cpu().numpy()
            dist_out[start:stop] = dist[: stop - start].cpu().numpy()
    return idx_out, dist_out


def pca(x, n_components: int = 2, n_iter: int = 8, seed: int = 0,
        device: "str | torch.device" = "cuda") -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Randomized-SVD PCA: ``(scores (N, k), components (k, F),
    explained_variance_ratio (k,))``, deterministic given ``seed``."""
    dev = resolve_device(device)
    xt = as_tensor(x, dev).double()
    n, f = int(xt.shape[0]), int(xt.shape[1])
    with torch.no_grad():
        xc = xt - xt.mean(dim=0, keepdim=True)
        rank = min(n, f)
        n_components = min(int(n_components), rank)
        sketch = min(n_components + 8, rank)
        g = rng.normal(rng.prng_key(seed), (f, sketch), device=dev).double()
        y = xc @ g
        for _ in range(int(n_iter)):  # QR per step keeps the power iteration stable
            y, _ = torch.linalg.qr(xc @ (xc.T @ y))
        q, _ = torch.linalg.qr(y)
        b = q.T @ xc
        _, s, vt = torch.linalg.svd(b, full_matrices=False)
        comps = vt[:n_components]
        # largest-|loading| coordinate positive: one answer on every device
        lead = torch.argmax(comps.abs(), dim=1)
        flip = torch.sign(comps[torch.arange(n_components, device=dev), lead])
        comps = comps * flip[:, None]
        scores = xc @ comps.T
        denom = float(max(n - 1, 1))
        var = (xc * xc).sum() / denom
        explained = (s[:n_components] ** 2) / denom
        ratio = explained / torch.clamp_min(var, 1e-12)
    return (scores.float().cpu().numpy(), comps.float().cpu().numpy(),
            ratio.float().cpu().numpy())


def median_bandwidth_weights(dists: torch.Tensor) -> torch.Tensor:
    """``exp(-(d / sigma)^2)`` with each row's ``sigma`` its median
    neighbour distance (the mean of the two middle ones for even k, as
    ``np.median``), at least 1e-6."""
    s, _ = torch.sort(dists, dim=1)
    k = s.shape[1]
    med = s[:, k // 2] if k % 2 else (s[:, k // 2 - 1] + s[:, k // 2]) / 2.0
    sigma = torch.clamp_min(med, 1e-6)[:, None]
    return torch.exp(-((dists / sigma) ** 2))


def in_edge_table(cols: torch.Tensor, n: int) -> torch.Tensor:
    """(n, max in-degree) edge ids by target node, in edge order, padded
    with -1: a stable argsort of the targets, cut into rows."""
    order = torch.sort(cols, stable=True).indices
    counts = torch.bincount(cols, minlength=n)
    width = max(1, int(counts.max()))
    starts = torch.cumsum(counts, 0) - counts
    sorted_cols = cols[order]
    slot = torch.arange(cols.numel(), device=cols.device) - starts[sorted_cols]
    table = torch.full((n, width), -1, dtype=torch.int64, device=cols.device)
    table[sorted_cols, slot] = order
    return table


def _spectral(neighbors: torch.Tensor, weights: torch.Tensor, n: int,
              n_components: int, n_iter: int) -> torch.Tensor:
    k = neighbors.shape[1]
    cols = neighbors.reshape(-1).to(torch.int64)
    rows = torch.arange(n, device=neighbors.device).repeat_interleave(k)
    vals = weights.reshape(-1)
    table = in_edge_table(cols, n)
    valid = table >= 0
    safe = torch.clamp_min(table, 0)
    in_vals = torch.where(valid, vals[safe], 0.0)   # (n, width)
    in_src = rows[safe]                             # (n, width)
    deg = weights.sum(dim=1) + in_vals.sum(dim=1)
    inv_sqrt = 1.0 / torch.sqrt(torch.clamp_min(deg, 1e-12))
    nbr = neighbors.to(torch.int64)

    def matvec(v):  # (n, c): D^-1/2 (W + W.T) D^-1/2 v without W
        u = v * inv_sqrt[:, None]
        fwd = (weights[:, :, None] * u[nbr]).sum(dim=1)
        bwd = (in_vals[:, :, None] * u[in_src]).sum(dim=1)
        return (fwd + bwd) * inv_sqrt[:, None]

    triv = torch.sqrt(torch.clamp_min(deg, 1e-12))
    triv = triv / torch.linalg.norm(triv)
    v = rng.normal(rng.prng_key(7), (n, n_components), device=neighbors.device)
    for _ in range(int(n_iter)):
        w = matvec(v)
        w = w - triv[:, None] * (triv @ w)[None, :]
        v, _ = torch.linalg.qr(w)
    # largest-|coordinate| entry of each column positive
    lead = torch.argmax(v.abs(), dim=0)
    flip = torch.sign(v[lead, torch.arange(n_components, device=v.device)])
    return v * flip[None, :]


def spectral_embedding(x, n_components: int = 2, k: int = 15, n_iter: int = 60,
                       tile: int | None = None, graph=None,
                       device: "str | torch.device" = "cuda") -> np.ndarray:
    """UMAP-style layout: kNN graph -> Gaussian edge weights -> the top
    non-trivial eigenvectors of the normalised adjacency.  Returns (N,
    n_components) float32.  ``graph`` supplies a precomputed self-kNN
    ``(neighbors, dists)``; without it the brute-force sweep runs."""
    dev = resolve_device(device)
    n = int(np.asarray(x).shape[0]) if not isinstance(x, torch.Tensor) else int(x.shape[0])
    k = max(1, min(int(k), n - 1))
    if graph is not None:
        neighbors, dists = graph
    else:
        neighbors, dists = knn(x, k, tile=tile, device=dev)
    with float32_matmuls(dev), torch.no_grad():
        nbr = torch.from_numpy(np.ascontiguousarray(neighbors)).to(dev)
        d = as_tensor(dists, dev)
        out = _spectral(nbr, median_bandwidth_weights(d), n, int(n_components), int(n_iter))
    return out.cpu().numpy()
