"""IVF (inverted-file) kNN index over the feature store.

Counterpart: ``tmlibrary_tpu/analytics/index.py``.  C ≈ 4√N centroids
are trained with the clustering tool's k-means (on at most
``TRAIN_SAMPLE_CAP`` strided rows; greedy seeding up to 64 cells,
strided beyond), every object goes to its nearest cell, and a query
scores only the members of its ``top_p`` nearest cells:

- explicit queries run query-major (each query probes its own cells),
  tiled over the query axis like brute force;
- the self sweep runs cell-major: the queries of one cell share the
  members of that cell's ``top_p`` nearest cells as candidates, so the
  distances are one batched ``(cap, m)`` product per cell.

Ties in every top-k go to the lowest index, as ``lax.top_k``'s do
(:func:`~tmlibrary_tpu_torch.analytics.ops.topk_smallest`).  The index
persists under ``<analytics>/<objects>/index/<selection>/`` with the
reference's file names and meta keys, keyed on the store's content
digest, and :meth:`IvfIndex.ensure` rebuilds it when the digest moved.

Mode resolution (:func:`resolve_index_mode`): an explicit request beats
``TMX_ANALYTICS_INDEX``, which beats the ``analytics_index`` setting
(``TM_ANALYTICS_INDEX``), which beats auto (ivf from
``TMX_ANALYTICS_INDEX_MIN`` objects, 4096 by default).  The reference's
link between config and auto, the machine-written tuning verdict, is not
ported: the port has no tuning file.  The reference also counts index
builds, hits and fallbacks in its telemetry registry, which the port
does not have; ``IvfIndex.cache_state`` and :func:`knn_search`'s
``info`` carry the same facts.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from tmlibrary_tpu_torch import config
from tmlibrary_tpu_torch.analytics import ops
from tmlibrary_tpu_torch.analytics.store import FeatureStore
from tmlibrary_tpu_torch.atomicio import atomic_write_text
from tmlibrary_tpu_torch.device import resolve_device
from tmlibrary_tpu_torch.errors import NotSupportedError, StoreError

INDEX_MODES = ("auto", "ivf", "brute")
INDEX_SCHEMA_VERSION = 1

#: auto mode: brute force below this many objects
DEFAULT_AUTO_MIN_OBJECTS = 4096

#: cells probed per query by default
DEFAULT_TOP_P = 8

#: auto cell count is this multiple of √N
AUTO_CELLS_SQRT_MULT = 4

#: build-time recall sample: this many strided queries vs exact kNN
RECALL_SAMPLE = 128
RECALL_K = 10

#: centroid training runs on at most this many strided rows
TRAIN_SAMPLE_CAP = 8192

#: greedy seeding up to this many cells, strided seeding beyond
GREEDY_SEED_MAX_CELLS = 64


def auto_min_objects() -> int:
    """The auto-mode brute -> ivf cutover (``TMX_ANALYTICS_INDEX_MIN``)."""
    try:
        return int(os.environ.get("TMX_ANALYTICS_INDEX_MIN", DEFAULT_AUTO_MIN_OBJECTS))
    except ValueError:
        return DEFAULT_AUTO_MIN_OBJECTS


def _validate(mode: str) -> str:
    if mode not in INDEX_MODES:
        raise NotSupportedError(f"unknown analytics index mode '{mode}' "
                                f"(expected one of {INDEX_MODES})")
    return mode


def resolve_index_mode(explicit: str | None = None, n_objects: int | None = None
                       ) -> tuple[str, str]:
    """``("ivf" or "brute", source)``: the explicit request, else
    ``TMX_ANALYTICS_INDEX``, else the ``analytics_index`` setting, else
    auto by store size; a bad name at any of the first three raises.
    ``source`` names the link that decided."""
    if explicit and explicit != "auto":
        return _validate(str(explicit)), "payload"
    env = os.environ.get("TMX_ANALYTICS_INDEX")
    if env and env != "auto":
        return _validate(env), "env"
    configured = config.setting("analytics_index", "auto")
    if configured and configured != "auto":
        return _validate(configured), "config"
    if n_objects is not None and int(n_objects) >= auto_min_objects():
        return "ivf", "auto"
    return "brute", "auto"


# ---------------------------------------------------------------- search
def _masked_topk(d2: torch.Tensor, cand: torch.Tensor, invalid: torch.Tensor,
                 k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k nearest candidates (invalid slots at +inf): their rows and
    distances."""
    d2 = torch.where(invalid, float("inf"), d2)
    pos = ops.topk_smallest(d2, k)
    idx = torch.gather(cand.expand_as(d2), -1, pos)
    dist = torch.sqrt(torch.clamp_min(torch.gather(d2, -1, pos), 0.0))
    return idx.to(torch.int32), dist


def _ivf_tile(q, x, cent, members, k: int, top_p: int):
    """One tile of explicit queries through the cell lists: the top_p
    nearest cells of each query, their members' distances, the top k."""
    cells = ops.topk_smallest(ops.sq_distances(q, cent), top_p)       # (T, P)
    cand = members[cells].reshape(q.shape[0], -1)                     # (T, P*cap)
    cx = x[torch.clamp_min(cand, 0)]                                  # (T, M, F)
    d2 = (ops.sq_norms(q)[:, None] - 2.0 * torch.einsum("tf,tmf->tm", q, cx)
          + ops.sq_norms(cx))
    return _masked_topk(d2, cand, cand < 0, k)


def _ivf_self_tile(x, mem, cand, k: int):
    """Self-kNN of a tile of cells: each cell's members query the
    members of its top_p nearest cells in one batched product."""
    qx = x[torch.clamp_min(mem, 0)]                                   # (Ct, cap, F)
    cx = x[torch.clamp_min(cand, 0)]                                  # (Ct, m, F)
    d2 = (ops.sq_norms(qx)[:, :, None] - 2.0 * torch.einsum("cqf,cmf->cqm", qx, cx)
          + ops.sq_norms(cx)[:, None, :])
    bad = (cand[:, None, :] < 0) | (cand[:, None, :] == mem[:, :, None])
    return _masked_topk(d2, cand[:, None, :], bad, k)


def assign_cells(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid cell of every row (lowest cell on ties)."""
    return torch.argmin(ops.sq_distances(x, cent), dim=1).to(torch.int32)


def ivf_build_arrays(x, n_cells: int | None = None, seed: int = 0, n_iter: int = 25,
                     device: "str | torch.device" = "cuda"
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Train the cells on a raw matrix: ``(centroids (C, F) float32,
    members (C, cap) int32 padded -1, assignments (N,) int32)``."""
    from tmlibrary_tpu_torch.tools.clustering import kmeans

    dev = resolve_device(device)
    x = np.ascontiguousarray(x, np.float32)
    n = int(x.shape[0])
    if n == 0:
        raise StoreError("cannot build an IVF index over an empty store")
    c = (int(n_cells) if n_cells
         else max(1, int(round(AUTO_CELLS_SQRT_MULT * math.sqrt(n)))))
    c = max(1, min(c, n))
    train_n = min(n, max(TRAIN_SAMPLE_CAP, 2 * c))
    train = x if train_n >= n else x[np.linspace(0, n - 1, train_n).astype(np.int64)]
    init = "greedy" if c <= GREEDY_SEED_MAX_CELLS else "stride"
    _, cent = kmeans(train, c, n_iter, seed, init, device=dev)
    with ops.float32_matmuls(dev), torch.no_grad():
        assign = assign_cells(ops.as_tensor(x, dev), cent).cpu().numpy()
    counts = np.bincount(assign, minlength=c)
    cap = max(1, int(counts.max()))
    members = np.full((c, cap), -1, np.int32)
    order = np.argsort(assign, kind="stable")  # row order within cells
    starts = np.cumsum(counts) - counts
    slot = np.arange(n) - starts[assign[order]]
    members[assign[order], slot] = order
    return cent.cpu().numpy().astype(np.float32), members, assign.astype(np.int32)


def ivf_search_arrays(x, centroids, members, k: int, queries=None,
                      top_p: int | None = None, tile: int | None = None,
                      device: "str | torch.device" = "cuda") -> tuple[np.ndarray, np.ndarray]:
    """IVF kNN over raw arrays, with ``ops.knn``'s contract (nearest
    first, self excluded when ``queries`` is None).  Rows whose probed
    cells hold fewer than k members report the shortfall as +inf
    distance."""
    dev = resolve_device(device)
    xt = ops.as_tensor(x, dev)
    cent = ops.as_tensor(centroids, dev)
    mem_np = np.asarray(members, np.int64)
    mem = torch.from_numpy(mem_np).to(dev)
    n = int(xt.shape[0])
    c, cap = mem_np.shape
    self_query = queries is None
    nq = n if self_query else int(np.asarray(queries).shape[0])
    k = min(int(k), n - 1 if self_query else n)
    if k <= 0:
        return np.zeros((nq, 0), np.int32), np.zeros((nq, 0), np.float32)
    top_p = int(top_p) if top_p else DEFAULT_TOP_P
    while top_p < c and top_p * cap < k + 1:  # enough members to fill k (+ self)
        top_p += 1
    top_p = min(top_p, c)
    m = top_p * cap
    idx_out = np.empty((nq, k), np.int32)
    dist_out = np.empty((nq, k), np.float32)
    with ops.float32_matmuls(dev), torch.no_grad():
        if self_query:
            cellrank = ops.topk_smallest(ops.sq_distances(cent, cent), top_p)   # (C, P)
            cand = mem[cellrank].reshape(c, m)
            cells_tile = (max(1, min(c, int(tile))) if tile else
                          max(1, min(c, ops.KNN_TILE_BLOCK_BYTES // max(1, 4 * cap * m))))
            valid = mem_np >= 0
            for start in range(0, c, cells_tile):
                stop = min(start + cells_tile, c)
                mem_t, cand_t = mem[start:stop], cand[start:stop]
                pad = cells_tile - (stop - start)
                if pad:  # one shape for every tile
                    mem_t = torch.nn.functional.pad(mem_t, (0, 0, 0, pad), value=-1)
                    cand_t = torch.nn.functional.pad(cand_t, (0, 0, 0, pad), value=-1)
                idx, dist = _ivf_self_tile(xt, mem_t, cand_t, k)
                v = valid[start:stop]
                rows = mem_np[start:stop][v]
                idx_out[rows] = idx[: stop - start].cpu().numpy()[v]
                dist_out[rows] = dist[: stop - start].cpu().numpy()[v]
            return idx_out, dist_out
        q_all = ops.as_tensor(queries, dev)
        if tile:
            tile = int(tile)
        else:
            per_row = 4 * m * (int(xt.shape[1]) + 2)
            tile = max(8, min(nq, ops.KNN_TILE_BLOCK_BYTES // max(1, per_row)))
        for start in range(0, nq, tile):
            stop = min(start + tile, nq)
            q = q_all[start:stop]
            if stop - start < tile:
                q = torch.nn.functional.pad(q, (0, 0, 0, tile - (stop - start)))
            idx, dist = _ivf_tile(q, xt, cent, mem, k, top_p)
            idx_out[start:stop] = idx[: stop - start].cpu().numpy()
            dist_out[start:stop] = dist[: stop - start].cpu().numpy()
    return idx_out, dist_out


def measure_recall(x, centroids, members, k: int = RECALL_K, top_p: int | None = None,
                   sample: int = RECALL_SAMPLE,
                   device: "str | torch.device" = "cuda") -> float:
    """recall@k of the query-major IVF search against exact brute force
    on a strided query sample."""
    n = int(np.asarray(x).shape[0])
    k = max(1, min(int(k), n - 1))
    take = max(1, min(int(sample), n))
    rows = np.linspace(0, n - 1, take).astype(np.int64)
    q = np.asarray(x, np.float32)[rows]
    exact_idx, _ = ops.knn(x, k, queries=q, device=device)
    ivf_idx, _ = ivf_search_arrays(x, centroids, members, k, queries=q, top_p=top_p,
                                   device=device)
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ivf_idx, exact_idx))
    return round(hits / float(exact_idx.size), 6)


# ------------------------------------------------------------ persistence
def selection_key(features: list[str] | None, n_cells: int | None = None) -> str:
    """Directory key of one (feature selection, cell count) pair."""
    sel = ("all" if not features
           else hashlib.sha256(json.dumps(list(features)).encode()).hexdigest()[:12])
    return sel if n_cells is None else f"{sel}-c{int(n_cells)}"


def index_dir(fs: FeatureStore, features: list[str] | None = None,
              n_cells: int | None = None) -> Path:
    """Where one selection's persisted index artifacts live."""
    return fs.root / "index" / selection_key(features, n_cells)


def _index_digest(centroids: np.ndarray, members: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(centroids, np.float32).tobytes())
    h.update(np.ascontiguousarray(members, np.int32).tobytes())
    return h.hexdigest()


class IvfIndex:
    """The persisted artifact; open through :meth:`ensure`."""

    def __init__(self, root: Path, meta: dict, centroids: np.ndarray, members: np.ndarray,
                 device: "str | torch.device" = "cuda"):
        self.root = Path(root)
        self.meta = meta
        self.centroids = centroids
        self.members = members
        self.device = device
        #: how :meth:`ensure` produced this instance ("build" | "hit")
        self.cache_state = "build"

    @property
    def digest(self) -> str:
        return self.meta["digest"]

    @property
    def n_cells(self) -> int:
        return int(self.meta["n_cells"])

    @property
    def recall_at_k(self) -> float | None:
        return self.meta.get("recall_at_k")

    def assignments(self) -> np.ndarray:
        """(N,) int32 cell of every object row."""
        return np.load(self.root / "assignments.npy")

    @classmethod
    def build(cls, fs: FeatureStore, features: list[str] | None = None,
              n_cells: int | None = None, seed: int = 0, n_iter: int = 25,
              device: "str | torch.device" = "cuda") -> "IvfIndex":
        _, x, feat_cols = fs.standardized(features)
        centroids, members, assign = ivf_build_arrays(x, n_cells=n_cells, seed=seed,
                                                      n_iter=n_iter, device=device)
        recall = measure_recall(x, centroids, members, device=device)
        root = index_dir(fs, features, n_cells)
        root.mkdir(parents=True, exist_ok=True)
        np.save(root / "centroids.npy", centroids)
        np.save(root / "members.npy", members)
        np.save(root / "assignments.npy", assign)
        counts = np.bincount(assign, minlength=centroids.shape[0])
        meta = {
            "schema_version": INDEX_SCHEMA_VERSION,
            "kind": "ivf",
            "objects_name": fs.meta.get("objects_name"),
            "store_digest": fs.digest,
            "features": feat_cols,
            "selection": selection_key(features, n_cells),
            "n_objects": int(x.shape[0]),
            "n_cells": int(centroids.shape[0]),
            "cell_capacity": int(members.shape[1]),
            "cell_fill": round(float(counts.mean()) / max(1, int(members.shape[1])), 4),
            "seed": int(seed),
            "n_iter": int(n_iter),
            "digest": _index_digest(centroids, members),
            "recall_at_k": recall,
            "recall_k": RECALL_K,
            "recall_sample": RECALL_SAMPLE,
            "default_top_p": DEFAULT_TOP_P,
            "built_at": time.time(),
        }
        atomic_write_text(root / "index_meta.json", json.dumps(meta, indent=2, sort_keys=True))
        return cls(root, meta, centroids, members, device=device)

    @classmethod
    def ensure(cls, fs: FeatureStore, features: list[str] | None = None,
               n_cells: int | None = None, seed: int = 0, rebuild: bool = False,
               device: "str | torch.device" = "cuda") -> "IvfIndex":
        """Open, or (re)build when the recorded store digest is not the
        live store's."""
        root = index_dir(fs, features, n_cells)
        meta_path = root / "index_meta.json"
        if not rebuild and meta_path.exists():
            try:
                meta = json.loads(meta_path.read_text())
                if (meta.get("schema_version") == INDEX_SCHEMA_VERSION
                        and meta.get("store_digest") == fs.digest
                        and (n_cells is None or int(meta.get("n_cells", -1)) == int(n_cells))
                        and (root / "centroids.npy").exists()
                        and (root / "members.npy").exists()):
                    out = cls(root, meta, np.load(root / "centroids.npy"),
                              np.load(root / "members.npy"), device=device)
                    out.cache_state = "hit"
                    return out
            except (OSError, ValueError, KeyError, TypeError):
                pass  # corrupt artifact: rebuild
        return cls.build(fs, features, n_cells=n_cells, seed=seed, device=device)

    def search(self, x, k: int, queries=None, top_p: int | None = None,
               tile: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        return ivf_search_arrays(x, self.centroids, self.members, k, queries=queries,
                                 top_p=top_p, tile=tile, device=self.device)


# ------------------------------------------------------------- dispatcher
def knn_search(fs: FeatureStore, x, k: int, queries=None, mode: str | None = None,
               features: list[str] | None = None, top_p: int | None = None,
               tile: int | None = None, device: "str | torch.device" = "cuda"
               ) -> tuple[np.ndarray, np.ndarray, dict[str, Any]]:
    """The one kNN dispatch every consumer goes through; ``x`` is the
    store's standardized matrix for ``features``.  Returns ``(idx, dist,
    info)``, ``info`` naming the resolved mode and why, and on the ivf
    path the index digest, cache state and recall@k.  An index failure
    falls back to brute force (``info["index_fallback"]``)."""
    requested, source = resolve_index_mode(mode, n_objects=int(np.asarray(x).shape[0]))
    info: dict[str, Any] = {"index": requested, "index_source": source}
    if requested == "ivf":
        try:
            idx_obj = IvfIndex.ensure(fs, features, device=device)
            out_idx, out_dist = idx_obj.search(x, k, queries=queries, top_p=top_p, tile=tile)
            info.update({
                "index_digest": idx_obj.digest,
                "index_cache": idx_obj.cache_state,
                "recall_at_k": idx_obj.recall_at_k,
                "n_cells": idx_obj.n_cells,
                "top_p": int(top_p) if top_p else DEFAULT_TOP_P,
            })
            return out_idx, out_dist, info
        except Exception as exc:  # degrade, never fail the query
            info.update({"index": "brute", "index_fallback": str(exc)})
    out_idx, out_dist = ops.knn(x, k, queries=queries, tile=tile, device=device)
    return out_idx, out_dist, info
