"""Analytics tools: kNN, PCA, embedding, spatial -- over the feature store.

Counterpart: ``tmlibrary_tpu/analytics/tools.py``.  Each is a registered
:class:`~tmlibrary_tpu_torch.tools.base.Tool` with the reference's
payload, ``values`` columns and attributes, run on the tool's device.
"""

from __future__ import annotations

import numpy as np

from tmlibrary_tpu_torch.analytics import ops, spatial
from tmlibrary_tpu_torch.analytics.store import FeatureStore
from tmlibrary_tpu_torch.errors import NotSupportedError
from tmlibrary_tpu_torch.tools.base import Tool, ToolResult, register_tool


def assemble_knn_result(objects_name: str, ids: dict, idx: np.ndarray, dist: np.ndarray,
                        feat_cols: list[str], store_digest: str, tile_rows: int,
                        info: dict) -> ToolResult:
    """The knn result of a finished neighbour sweep, shared by :class:`Knn`
    and the fused multi-query path (``analytics/query.py``)."""
    k_eff = idx.shape[1]
    n = len(ids["label"])
    ids["value"] = (dist.mean(axis=1).astype(np.float64) if k_eff
                    else np.zeros(n, np.float64))
    for j in range(k_eff):
        ids[f"nn{j}"] = idx[:, j].astype(np.int32)
        ids[f"nnd{j}"] = dist[:, j].astype(np.float64)
    return ToolResult(
        tool="knn", objects_name=objects_name, layer_type="continuous", values=ids,
        attributes={
            "k": k_eff,
            "features": feat_cols,
            "tile_rows": tile_rows,
            "mean_distance": float(dist.mean()) if dist.size else 0.0,
            "store_digest": store_digest,
            **info,
        },
    )


@register_tool("knn")
class Knn(Tool):
    """k nearest neighbours over the standardized feature matrix, through
    the IVF index or tiled brute force.  Payload: ``objects_name``,
    optional ``k`` (10), ``features``, ``tile``, ``index``
    (``auto|ivf|brute``), ``top_p``.  ``value`` is each object's mean
    distance to its k neighbours; ``nn0..`` / ``nnd0..`` carry the
    neighbour rows and distances."""

    def process(self, payload: dict) -> ToolResult:
        from tmlibrary_tpu_torch.analytics.index import knn_search

        objects_name = payload["objects_name"]
        k = int(payload.get("k", 10))
        features = payload.get("features")
        fs = FeatureStore.ensure(self.store, objects_name)
        ids, x, feat_cols = fs.standardized(features)
        idx, dist, info = knn_search(fs, x, k, mode=payload.get("index"), features=features,
                                     top_p=payload.get("top_p"), tile=payload.get("tile"),
                                     device=self.device)
        return assemble_knn_result(
            objects_name, ids, idx, dist, feat_cols, fs.digest,
            int(payload.get("tile") or ops.knn_tile_rows(len(x))), info)


@register_tool("pca")
class Pca(Tool):
    """Randomized-SVD PCA.  Payload: ``objects_name``, optional
    ``n_components`` (2), ``features``.  ``value`` is the PC1 score;
    ``pc0..`` carry every component's scores."""

    def process(self, payload: dict) -> ToolResult:
        objects_name = payload["objects_name"]
        n_components = int(payload.get("n_components", 2))
        fs = FeatureStore.ensure(self.store, objects_name)
        ids, x, feat_cols = fs.standardized(payload.get("features"))
        scores, comps, ratio = ops.pca(x, n_components, device=self.device)
        ids["value"] = scores[:, 0].astype(np.float64)
        for j in range(scores.shape[1]):
            ids[f"pc{j}"] = scores[:, j].astype(np.float64)
        return ToolResult(
            tool=self.name, objects_name=objects_name, layer_type="continuous", values=ids,
            attributes={
                "n_components": int(scores.shape[1]),
                "features": feat_cols,
                "explained_variance_ratio": [round(float(r), 6) for r in ratio],
                "components": np.round(comps, 6).tolist(),
                "store_digest": fs.digest,
            },
        )


@register_tool("embedding")
class Embedding(Tool):
    """kNN-graph spectral embedding.  Payload: ``objects_name``, optional
    ``n_components`` (2), ``k`` (15), ``features``, ``index`` and
    ``top_p`` for the graph's kNN.  ``value`` is the first coordinate;
    ``emb0..`` carry all of them."""

    def process(self, payload: dict) -> ToolResult:
        from tmlibrary_tpu_torch.analytics.index import knn_search

        objects_name = payload["objects_name"]
        n_components = int(payload.get("n_components", 2))
        k = int(payload.get("k", 15))
        features = payload.get("features")
        fs = FeatureStore.ensure(self.store, objects_name)
        ids, x, feat_cols = fs.standardized(features)
        k_eff = max(1, min(k, len(x) - 1))
        neighbors, dists, info = knn_search(
            fs, x, k_eff, mode=payload.get("index"), features=features,
            top_p=payload.get("top_p"), tile=payload.get("tile"), device=self.device)
        emb = ops.spectral_embedding(x, n_components=n_components, k=k_eff,
                                     graph=(neighbors, dists), device=self.device)
        ids["value"] = emb[:, 0].astype(np.float64)
        for j in range(emb.shape[1]):
            ids[f"emb{j}"] = emb[:, j].astype(np.float64)
        return ToolResult(
            tool=self.name, objects_name=objects_name, layer_type="continuous", values=ids,
            attributes={
                "n_components": int(emb.shape[1]),
                "k": k,
                "features": feat_cols,
                "method": "spectral",
                "store_digest": fs.digest,
                **info,
            },
        )


@register_tool("spatial")
class Spatial(Tool):
    """Integral-image spatial statistics.  Payload: ``objects_name``,
    ``statistic`` (``density``, the default, or ``enrichment``), optional
    ``grid`` (64), ``radius`` (2), ``windows`` (``[site_index, y0, x0,
    y1, x1]`` bin windows to count), and for enrichment a
    ``mark_feature`` and ``mark_threshold`` (default: the feature's
    median).  ``value`` is the per-object statistic."""

    def process(self, payload: dict) -> ToolResult:
        objects_name = payload["objects_name"]
        statistic = payload.get("statistic", "density")
        if statistic not in ("density", "enrichment"):
            raise NotSupportedError(f"spatial statistic '{statistic}' not supported "
                                    "(have: density, enrichment)")
        grid = int(payload.get("grid", spatial.DEFAULT_GRID))
        radius = int(payload.get("radius", 2))
        fs = FeatureStore.ensure(self.store, objects_name)
        ids = fs.identity()
        centroids = fs.centroids()
        mark = None
        attrs: dict = {"statistic": statistic, "grid": grid, "radius": radius,
                       "store_digest": fs.digest}
        if statistic == "enrichment":
            feature = payload.get("mark_feature")
            if not feature:
                raise NotSupportedError("spatial enrichment needs a 'mark_feature'")
            if feature not in fs.features:
                raise NotSupportedError(f"feature '{feature}' not found (have: "
                                        f"{sorted(fs.features)})")
            col = fs.column(feature)
            thresh = payload.get("mark_threshold")
            if thresh is None:
                thresh = float(np.nanmedian(col))
            mark = (col > float(thresh)).astype(np.float32)
            attrs["mark_feature"] = feature
            attrs["mark_threshold"] = float(thresh)
            attrs["marked_fraction"] = round(float(mark.mean()), 6)
        index = spatial.build_index(ids["site_index"], centroids, mark=mark, grid=grid,
                                    device=self.device)
        if statistic == "density":
            values = spatial.density(index, radius_bins=radius)
        else:
            values = spatial.enrichment(index, radius_bins=radius)
        ids["value"] = values
        attrs["n_sites"] = int(len(index.site_ids))
        windows = payload.get("windows")
        if windows:
            wins = np.asarray(windows, np.int64)
            site_to_row = {int(s): i for i, s in enumerate(index.site_ids)}
            rows = np.array([site_to_row.get(int(s), -1) for s in wins[:, 0]], np.int64)
            if (rows < 0).any():
                bad = sorted({int(s) for s, r in zip(wins[:, 0], rows) if r < 0})
                raise NotSupportedError(f"window sites not in store: {bad}")
            counts = index.window_counts(np.concatenate([rows[:, None], wins[:, 1:]], axis=1))
            attrs["windows"] = [
                {"site_index": int(s), "window": [int(v) for v in w], "count": float(c)}
                for s, w, c in zip(wins[:, 0], wins[:, 1:], counts)
            ]
        return ToolResult(tool=self.name, objects_name=objects_name, layer_type="continuous",
                          values=ids, attributes=attrs)
