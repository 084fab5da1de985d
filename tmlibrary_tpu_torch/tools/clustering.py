"""Clustering tool: k-means over object features.

Counterpart: ``tmlibrary_tpu/tools/clustering.py``.  Lloyd's algorithm
in PyTorch with the reference's seeding, iteration count and
empty-cluster reseed; it is also the IVF index's centroid trainer
(``analytics/index.py``).

- ``greedy`` seeding starts from JAX's ``randint(PRNGKey(seed), (), 0,
  n)`` row (drawn bit for bit by :mod:`~tmlibrary_tpu_torch.analytics.rng`),
  then takes, k - 1 times, the row farthest from its nearest centroid
  so far, over the reference's ``(n, k, F)`` broadcast;
- ``stride`` seeding takes the rows of ``jnp.linspace(0, n - 1, k)``
  as XLA computes them (:func:`stride_rows`);
- the centroid update is the one-hot ``(k, n) @ (n, F)`` product and
  its row sums, so the card sums in a fixed order (no atomics) and a
  repeated run is bit-identical.
"""

from __future__ import annotations

import numpy as np
import torch

from tmlibrary_tpu_torch.analytics import ops, rng
from tmlibrary_tpu_torch.device import resolve_device
from tmlibrary_tpu_torch.tools.base import Tool, ToolResult, register_tool


def _reseed_empty(updated: torch.Tensor, counts: torch.Tensor, x: torch.Tensor,
                  d_assign: torch.Tensor) -> torch.Tensor:
    """Each dead centroid (no members after an assignment) takes one of
    the farthest points: the i-th dead slot the i-th largest distance to
    its assigned centroid, equal distances by the lowest row; live
    slots keep their update."""
    k = updated.shape[0]
    k_far = min(int(k), int(x.shape[0]))
    far_idx = ops.topk_largest(d_assign, k_far)
    dead = counts <= 0
    rank = torch.clamp(torch.cumsum(dead.to(torch.int32), 0) - 1, 0, k_far - 1)
    return torch.where(dead[:, None], x[far_idx[rank]], updated)


def stride_rows(n: int, k: int) -> np.ndarray:
    """``jnp.linspace(0, n - 1, k).astype(int32)`` as XLA evaluates it:
    its division by ``k - 1`` becomes a product with the float32
    reciprocal, reassociated as ``((n - 1) * (1 / (k - 1))) * i`` in
    float32 and truncated; the last row is ``n - 1``."""
    if k == 1:
        return np.zeros(1, np.int64)
    scale = np.float32(n - 1) * (np.float32(1) / np.float32(k - 1))
    out = np.append(scale * np.arange(k - 1, dtype=np.float32), np.float32(n - 1))
    return out.astype(np.int32).astype(np.int64)


def _greedy_seeds(x: torch.Tensor, k: int, seed: int) -> torch.Tensor:
    n = x.shape[0]
    first = int(rng.randint(rng.prng_key(seed), (), 0, n))
    cent = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    cent[0] = x[first]
    slots = torch.arange(k, device=x.device)[None, :]
    for i in range(1, k):
        d2 = ((x[:, None, :] - cent[None]) ** 2).sum(dim=-1)  # (n, k)
        d2 = torch.where(slots < i, d2, float("inf"))
        cent[i] = x[torch.argmax(d2.min(dim=1).values)]
    return cent


def lloyd_assign(x: torch.Tensor, cent: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The assignment half of a Lloyd step: (nearest centroid of every row,
    lowest on ties; its squared distance)."""
    d2 = ops.sq_distances(x, cent)
    assign = torch.argmin(d2, dim=1)
    return assign, torch.gather(d2, 1, assign[:, None])[:, 0]


def lloyd_update(x: torch.Tensor, cent: torch.Tensor, assign: torch.Tensor,
                 d_assign: torch.Tensor) -> torch.Tensor:
    """The update half: each centroid the mean of its rows (a one-hot
    product, summed in a fixed order), a dead one reseeded from the
    farthest rows."""
    slots = torch.arange(cent.shape[0], device=x.device)[:, None]
    onehot = (slots == assign[None, :]).to(torch.float32)  # (k, n)
    sums = onehot @ x
    counts = onehot.sum(dim=1)
    new = torch.where(counts[:, None] > 0, sums / torch.clamp_min(counts[:, None], 1.0), cent)
    return _reseed_empty(new, counts, x, d_assign)


def kmeans(x, k: int, n_iter: int = 50, seed: int = 0, init: str = "greedy",
           device: "str | torch.device" = "cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """k-means; returns (assignments (N,) int64, centroids (k, F)
    float32) as tensors on ``device``."""
    dev = resolve_device(device)
    x = ops.as_tensor(x, dev)
    with ops.float32_matmuls(dev), torch.no_grad():
        if init == "stride":
            cent = x[torch.from_numpy(stride_rows(x.shape[0], int(k))).to(dev)]
        else:
            cent = _greedy_seeds(x, int(k), seed)
        for _ in range(int(n_iter)):
            cent = lloyd_update(x, cent, *lloyd_assign(x, cent))
        assign, _ = lloyd_assign(x, cent)
    return assign, cent


@register_tool("clustering")
class Clustering(Tool):
    """k-means over object features.  Payload: ``objects_name``,
    optional ``k`` (default 3), ``features`` and ``index``
    (``auto|ivf|brute``): on the ivf path the persisted IVF codebook at
    ``n_cells=k`` is reused (sampled training and one assignment pass,
    the same trainer).  Reports per-cluster sizes and the inertia."""

    def process(self, payload: dict) -> ToolResult:
        from tmlibrary_tpu_torch.analytics.index import IvfIndex, resolve_index_mode

        objects_name = payload["objects_name"]
        k = int(payload.get("k", 3))
        features = payload.get("features")
        ids, x, feat_cols = self.load_feature_matrix(objects_name, features)
        resolved, source = resolve_index_mode(payload.get("index"), n_objects=len(x),
                                              device=self.device)
        index_info: dict = {"index": resolved, "index_source": source}
        if resolved == "ivf":
            fs = self.feature_store(objects_name)
            idx_obj = IvfIndex.ensure(fs, features, n_cells=k, device=self.device)
            assign_np = idx_obj.assignments().astype(np.int32)
            cent_np = np.asarray(idx_obj.centroids, np.float32)
            index_info["index_digest"] = idx_obj.digest
            index_info["index_cache"] = idx_obj.cache_state
        else:
            assign, cent = kmeans(x, k, device=self.device)
            assign_np = assign.cpu().numpy().astype(np.int32)
            cent_np = cent.cpu().numpy()
        ids["value"] = assign_np
        sizes = np.bincount(assign_np, minlength=k)
        inertia = float(((x - cent_np[assign_np]) ** 2).sum()) if len(x) else 0.0
        return ToolResult(
            tool=self.name, objects_name=objects_name, layer_type="categorical", values=ids,
            attributes={
                "k": k,
                "features": feat_cols,
                "centroids": cent_np.tolist(),
                "cluster_sizes": {str(i): int(c) for i, c in enumerate(sizes)},
                "inertia": round(inertia, 4),
                **index_info,
            },
        )
