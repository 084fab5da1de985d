"""Query execution: one tool invocation over the feature store, cached
by content digest.

Counterpart: ``tmlibrary_tpu/analytics/query.py``, behind ``tmx-torch
query``.  The cache key is ``sha256(store digest || canonical payload)``
cut to 24 hex characters -- the reference's key for the same store and
payload -- and a result persists as an ordinary ``ToolResult`` under
``<store>/tools/queries/<key>/`` with a ``query.json`` provenance
sidecar, so a repeated query on unchanged features loads the saved
result, and a changed store (new digest) never serves a stale one.

The reference also emits trace spans (``emit``) and counts
``tmx_analytics_*`` series in its telemetry registry; the port has no
such registry.  ``emit`` is accepted and unused, and the summary's
``cache`` field says whether a query hit, missed or rode a fused sweep.
"""

from __future__ import annotations

import hashlib
import json
import time
from pathlib import Path
from typing import TYPE_CHECKING, Any, Callable

import numpy as np

from tmlibrary_tpu_torch.analytics.store import FeatureStore
from tmlibrary_tpu_torch.atomicio import atomic_write_text
from tmlibrary_tpu_torch.errors import NotSupportedError
from tmlibrary_tpu_torch.tools.base import ToolResult, get_tool, n_rows

if TYPE_CHECKING:  # pragma: no cover
    from tmlibrary_tpu_torch.models.store import ExperimentStore

#: tools answerable through the query path (documentation and CLI help)
QUERY_TOOLS = ("clustering", "heatmap", "classification", "knn", "pca", "embedding",
               "spatial")


def canonical_payload(payload: dict[str, Any]) -> str:
    """Sorted-key, minimal-separator JSON: the payload half of the key."""
    return json.dumps(payload, sort_keys=True, separators=(",", ":"))


def query_key(store_digest: str, payload: dict[str, Any]) -> str:
    """sha256(store content digest || canonical payload), 24 hex chars."""
    h = hashlib.sha256()
    h.update(store_digest.encode())
    h.update(canonical_payload(payload).encode())
    return h.hexdigest()[:24]


def queries_dir(store: "ExperimentStore") -> Path:
    """The query-result cache root under the experiment's tools dir."""
    d = store.tools_dir / "queries"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _provenance(cache_dir: Path, key: str, tool: str, payload: dict, digest: str,
                elapsed: float, **extra) -> None:
    atomic_write_text(cache_dir / "query.json", json.dumps({
        "key": key, "tool": tool, "payload": payload, "store_digest": digest,
        "elapsed_s": elapsed, "cached_at": time.time(), **extra}))


def run_query(store: "ExperimentStore", payload: dict[str, Any], use_cache: bool = True,
              emit: Callable[..., Any] | None = None,
              device: str = "cuda") -> dict[str, Any]:
    """Answer one analytics query on ``device``; returns the summary.
    ``payload`` carries ``tool`` and ``objects_name``, the rest is the
    tool's own payload."""
    payload = dict(payload)
    tool_name = payload.get("tool")
    if not tool_name:
        raise NotSupportedError("query payload needs a 'tool'")
    if not payload.get("objects_name"):
        raise NotSupportedError("query payload needs an 'objects_name'")
    tool_cls = get_tool(tool_name)  # unknown tool: fail before any work
    t0 = time.monotonic()
    fs = FeatureStore.ensure(store, payload["objects_name"])
    key = query_key(fs.digest, payload)
    cache_dir = queries_dir(store) / key
    if use_cache and (cache_dir / "result.json").exists():
        result = ToolResult.load(cache_dir)
        return _summary(result, key, fs.digest, "hit", round(time.monotonic() - t0, 4),
                        cache_dir)
    tool_payload = {k: v for k, v in payload.items() if k != "tool"}
    result = tool_cls(store, device=device).process(tool_payload)
    result.save(cache_dir)
    elapsed = round(time.monotonic() - t0, 4)
    _provenance(cache_dir, key, tool_name, payload, fs.digest, elapsed)
    return _summary(result, key, fs.digest, "miss", elapsed, cache_dir)


def fusion_signature(payload: dict[str, Any]) -> str | None:
    """The fusable identity of a payload (everything but ``k`` of a knn
    query), or None when the tool cannot share a sweep: the k-prefix of
    a larger-k sweep is the smaller-k answer, since every row is sorted
    nearest first with ties by the lowest index."""
    if payload.get("tool") != "knn":
        return None
    return canonical_payload({k: v for k, v in payload.items() if k != "k"})


def run_query_batch(store: "ExperimentStore", payloads: list[dict[str, Any]],
                    use_cache: bool = True, emit: Callable[..., Any] | None = None,
                    device: str = "cuda") -> list[dict[str, Any]]:
    """Answer fusable knn queries with one sweep at the largest k: hits
    are served first, then each remaining query's result is sliced from
    the shared sweep, assembled as the sequential path assembles it and
    cached under its own key (the first ``miss``, the rest ``fused``).
    Summaries come back in payload order."""
    payloads = [dict(p) for p in payloads]
    if not payloads:
        return []
    if len(payloads) == 1:
        return [run_query(store, payloads[0], use_cache=use_cache, device=device)]
    sig = fusion_signature(payloads[0])
    if sig is None or any(fusion_signature(p) != sig for p in payloads[1:]):
        raise NotSupportedError("run_query_batch needs payloads sharing one fusion signature")
    from tmlibrary_tpu_torch.analytics import ops
    from tmlibrary_tpu_torch.analytics.index import knn_search
    from tmlibrary_tpu_torch.analytics.tools import assemble_knn_result

    t0 = time.monotonic()
    fs = FeatureStore.ensure(store, payloads[0]["objects_name"])
    keys = [query_key(fs.digest, p) for p in payloads]
    out: list[dict[str, Any] | None] = [None] * len(payloads)
    pending: list[int] = []
    for i, key in enumerate(keys):
        cache_dir = queries_dir(store) / key
        if use_cache and (cache_dir / "result.json").exists():
            out[i] = _summary(ToolResult.load(cache_dir), key, fs.digest, "hit",
                              round(time.monotonic() - t0, 4), cache_dir)
        else:
            pending.append(i)
    if not pending:
        return out
    ref = payloads[pending[0]]
    features = ref.get("features")
    k_max = max(int(payloads[i].get("k", 10)) for i in pending)
    ids, x, feat_cols = fs.standardized(features)
    idx, dist, info = knn_search(fs, x, k_max, mode=ref.get("index"), features=features,
                                 top_p=ref.get("top_p"), tile=ref.get("tile"), device=device)
    window = len(pending)
    tile_rows = int(ref.get("tile") or ops.knn_tile_rows(len(x)))
    leader_key = keys[pending[0]]
    for rank, i in enumerate(pending):
        p, key = payloads[i], keys[i]
        k_i = min(int(p.get("k", 10)), idx.shape[1])
        result = assemble_knn_result(
            p["objects_name"], {c: v.copy() for c, v in ids.items()},
            np.ascontiguousarray(idx[:, :k_i]), np.ascontiguousarray(dist[:, :k_i]),
            feat_cols, fs.digest, tile_rows, info)
        cache_dir = queries_dir(store) / key
        result.save(cache_dir)
        elapsed = round(time.monotonic() - t0, 4)
        _provenance(cache_dir, key, "knn", p, fs.digest, elapsed, fusion_window=window,
                    fused_with=leader_key)
        summary = _summary(result, key, fs.digest, "miss" if rank == 0 else "fused",
                           elapsed, cache_dir)
        summary["fusion_window"] = window
        if rank:
            summary["fused_with"] = leader_key
        out[i] = summary
    return out


def _summary(result: ToolResult, key: str, digest: str, cache: str, elapsed: float,
             cache_dir: Path) -> dict[str, Any]:
    return {
        "tool": result.tool,
        "objects_name": result.objects_name,
        "layer_type": result.layer_type,
        "n_objects": n_rows(result.values),
        "cache": cache,
        "key": key,
        "store_digest": digest,
        "elapsed_s": elapsed,
        "result_dir": str(cache_dir),
        "attributes": result.attributes,
    }
