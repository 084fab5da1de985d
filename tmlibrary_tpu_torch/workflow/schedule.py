"""Work-aware site scheduling: cost-model batch packing.

Counterpart: ``tmlibrary_tpu/workflow/schedule.py``.  Directory-order
batching lets one dense site drag a whole batch to a big capacity rung.
The plan:

1. **Per-site cost prediction**: per-site object counts from prior runs
   (persisted feature shards harvested before ``delete_previous_output``,
   plus the live per-site EWMA ``capacity.note_site_counts`` accumulates
   from every completed batch); sites with no history fall back to a
   prior the caller derives (the routing-key peak, else the densest
   harvested site).
2. **Rung-homogeneous batch packing**: sites sorted by predicted count
   and sliced into the same batch-size multiset directory order would
   have produced.
3. **Balanced shard order** within each batch
   (:func:`balanced_shard_order`, the port's copy of
   ``tmlibrary_tpu/parallel/mesh.py:46``; with one device the order is
   the packed one).

The plan is a pure function of (site list, history snapshot, ladder,
batch size, device count, description digest), written to a
``schedule_plan.json`` side file.  Per-site results persist by site
index, so packing on or off gives the same store.

The mode (:func:`resolve_schedule`) is the step's explicit ``schedule``
argument, else the ``schedule`` setting (``TM_SCHEDULE`` or the INI
file), else the tuning verdict measured on the asking backend
(:func:`tmlibrary_tpu_torch.tuning.tuned_schedule`), else ``pack``.  The
JAX package also reads a ``TMX_SCHEDULE`` env, which its CLI sets; the
port's ``workflow submit --schedule`` passes the step argument instead.
The harvest reads the
``site_index`` column of the Parquet feature shards either package
writes.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from pathlib import Path

import numpy as np

from tmlibrary_tpu_torch.capacity import select_capacity, site_count_snapshot
from tmlibrary_tpu_torch.io import parquet

#: accepted mode spellings; "pack"/"on" force packing, "off" disables,
#: "auto" defers down the precedence chain (and ultimately packs)
SCHEDULE_MODES = ("auto", "pack", "off")

_ON_VALUES = ("pack", "on", "1", "true", "yes")
_OFF_VALUES = ("off", "none", "0", "false", "no")

#: plan format version (schedule_plan.json)
PLAN_VERSION = 1


def _normalize(value) -> str | None:
    """Canonical mode for a raw knob value, or None when unset/auto."""
    text = str(value or "").strip().lower()
    if not text or text == "auto":
        return None
    if text in _ON_VALUES:
        return "pack"
    if text in _OFF_VALUES:
        return "off"
    raise ValueError(
        f"schedule mode '{value}' is not one of {SCHEDULE_MODES}"
    )


def resolve_schedule(explicit: str | None = None,
                     backend: str | None = None) -> tuple[str, str]:
    """The effective schedule mode and where it came from: an explicit
    ``pack``/``off`` request (``"cli"``), else the ``schedule`` setting
    (``"config"``), else the tuning verdict of ``backend`` (``cuda`` by
    default; ``"tuning"``), else ``pack`` (``"default"``): the plan
    degenerates to directory order with no history, so packing costs
    nothing on a cold start.  Returns ``(mode, source)``."""
    from tmlibrary_tpu_torch import config, tuning

    for value, source in ((explicit, "cli"), (config.setting("schedule", "auto"), "config"),
                          (tuning.tuned_schedule(backend), "tuning")):
        mode = _normalize(value)
        if mode is not None:
            return mode, source
    return "pack", "default"


def schedule_enabled(mode: str) -> bool:
    """True when ``mode`` packs (everything except ``off``)."""
    return str(mode or "").strip().lower() not in _OFF_VALUES


# --------------------------------------------------------------- predictor
def predict_site_counts(
    key: str, sites: list[int], prior: float,
) -> list[float]:
    """Predicted per-site object counts: the EWMA history entry when one
    exists (``capacity.site_count_snapshot``), else ``prior`` — the
    cold-start fallback the caller derives from the routing-key peak or
    the capacity ceiling.  Pure read; never mutates history."""
    table = site_count_snapshot(key)
    prior = float(prior)
    return [float(table.get(int(s), prior)) for s in sites]


def harvest_store_counts(store) -> dict[int, int]:
    """Per-site object counts from a PRIOR run's persisted feature
    shards: for every objects family under ``features/``, the number of
    feature rows per ``site_index``; per site, the max over families
    (the densest family sets the capacity rung).  Returns ``{}`` when
    nothing is persisted: cold start is a supported state, never an
    error."""
    counts: dict[int, int] = {}
    try:
        features_root = Path(store.root) / "features"
        if not features_root.is_dir():
            return {}
        for family_dir in sorted(features_root.iterdir()):
            if not family_dir.is_dir():
                continue
            for shard in sorted(family_dir.glob("*.parquet")):
                try:
                    column = parquet.read_table(shard, columns=["site_index"])["site_index"]
                except Exception:
                    continue
                sites, n = np.unique(column, return_counts=True)
                for site, k in zip(sites.tolist(), n.tolist()):
                    counts[site] = max(counts.get(site, 0), int(k))
    except Exception:
        return {}
    return counts


# ----------------------------------------------------------------- packing
def contiguous_shard_work(
    weights: list[float], n_shards: int,
) -> list[float]:
    """Per-shard predicted work under the PLAIN contiguous split (the
    pre-balancing layout) — the "before" half of the skew comparison.
    Padding lanes (appended at the end, zero real work) are accounted
    like :func:`balanced_shard_order` does."""
    n = len(weights)
    n_shards = max(1, int(n_shards))
    if n_shards == 1 or n <= 1:
        return [float(sum(weights))]
    chunk = -(-n // n_shards)
    return [
        float(sum(weights[s * chunk:(s + 1) * chunk]))
        for s in range(n_shards)
    ]


def balanced_shard_order(
    items: "list", weights: "list[float]", n_shards: int,
) -> "tuple[list, list[float]]":
    """Permute ``items`` so the contiguous equal-size chunks that
    a device mesh slices off the leading axis carry near-equal
    total ``weights`` (greedy LPT over the shard loads).

    The workflow layer pads a batch to a multiple of the mesh size by
    appending dummy lanes at the END, so the last shard's capacity is
    reduced by the pad it will absorb.  Deterministic: ties break on the
    original item order, never on dict/hash order.  Returns the permuted
    items and the per-shard predicted loads (padding lanes count zero).
    """
    n = len(items)
    n_shards = max(1, int(n_shards))
    if n_shards == 1 or n <= 1:
        return list(items), [float(sum(weights))] if items else [0.0]
    chunk = -(-n // n_shards)  # ceil: the post-padding per-shard width
    # padding lanes fill from the END of the leading axis, so trailing
    # shards lose capacity to the pad they will absorb (possibly whole
    # shards, when n < (n_shards - 1) * chunk)
    capacity = [max(0, min(chunk, n - s * chunk)) for s in range(n_shards)]
    shards: list[list[int]] = [[] for _ in range(n_shards)]
    loads = [0.0] * n_shards
    order = sorted(range(n), key=lambda i: (-float(weights[i]), i))
    for i in order:
        best = min(
            (s for s in range(n_shards) if len(shards[s]) < capacity[s]),
            key=lambda s: (loads[s], s),
        )
        shards[best].append(i)
        loads[best] += float(weights[i])
    permuted = [items[i] for s in shards for i in s]
    return permuted, loads


def pack_plan(
    sites: list[int],
    predicted: list[float],
    batch_size: int,
    ladder: tuple[int, ...],
    n_devices: int,
    seed: str,
    mode: str = "pack",
    source: str = "default",
) -> dict:
    """The deterministic packing plan: batches (site lists), per-batch
    predicted capacity rung, and per-batch balanced shard loads.

    Packing preserves the batch-size multiset directory order would have
    produced (``ceil(n / batch_size)`` batches, all but the last full),
    so every compiled input signature — (padded batch, rung) — is one
    the unpacked run compiles too; no new signatures are ever minted
    (the reference's zero-new-compiles contract).
    Sites are ordered by predicted count descending (LPT flavor, ties on
    site index) and sliced consecutively: each batch's rung is set by
    its densest member, which is adjacent in sorted order, so rung
    mixing inside a batch is minimal by construction.  ``seed`` (the
    description digest) joins the plan digest so two descriptions never
    share a plan identity.
    """
    n = len(sites)
    batch_size = max(1, int(batch_size))
    n_devices = max(1, int(n_devices))
    order = sorted(range(n), key=lambda i: (-float(predicted[i]), sites[i]))
    batches = []
    for start in range(0, n, batch_size):
        idxs = order[start:start + batch_size]
        bsites = [int(sites[i]) for i in idxs]
        bpred = [float(predicted[i]) for i in idxs]
        peak = max(bpred) if bpred else 0.0
        rung = select_capacity(int(math.ceil(peak)), ladder)
        naive_work = contiguous_shard_work(bpred, n_devices)
        balanced, work = balanced_shard_order(bsites, bpred, n_devices)
        pred_by_site = dict(zip(bsites, bpred))
        balanced_pred = [pred_by_site[s] for s in balanced]
        batches.append({
            "sites": balanced,
            "predicted": [round(p, 3) for p in balanced_pred],
            "rung": int(rung),
            "shard_work": [round(w, 3) for w in work],
            "shard_work_naive": [round(w, 3) for w in naive_work],
        })
    plan = {
        "version": PLAN_VERSION,
        "mode": mode,
        "source": source,
        "seed": str(seed),
        "batch_size": batch_size,
        "n_devices": n_devices,
        "ladder": [int(c) for c in ladder],
        "n_sites": n,
        "history": {
            str(int(sites[i])): round(float(predicted[i]), 3)
            for i in range(n)
        },
        "batches": batches,
    }
    plan["digest"] = plan_digest(plan)
    return plan


def plan_digest(plan: dict) -> str:
    """Content digest of a plan (digest field excluded): a re-derived
    plan matches a recorded one iff the digests match."""
    body = {k: v for k, v in plan.items() if k != "digest"}
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def _skew(loads: list[float]) -> float:
    return (max(loads) - min(loads)) if len(loads) > 1 else 0.0


def plan_event(plan: dict) -> dict:
    """The compact ``schedule_plan`` ledger-event payload: the plan's
    identity and the occupancy and shard skew it predicts packed and
    unpacked (the reference's ``plan_event``, field for field)."""
    batches = plan.get("batches") or []
    ladder = plan.get("ladder") or []
    ceiling = ladder[-1] if ladder else 0
    pred_total = sum(sum(b.get("predicted") or []) for b in batches)
    packed_slots = sum(b["rung"] * len(b.get("sites") or []) for b in batches)
    # the unpacked counterfactual: every batch at the rung the global
    # predicted peak selects (what peak-routing converges to)
    peak = max((max(b.get("predicted") or [0.0]) for b in batches), default=0.0)
    flat_rung = select_capacity(int(math.ceil(peak)), tuple(ladder)) if ladder else ceiling
    flat_slots = sum(flat_rung * len(b.get("sites") or []) for b in batches)
    skew_packed = sum(_skew(b.get("shard_work") or [0.0]) for b in batches)
    skew_naive = sum(_skew(b.get("shard_work_naive") or [0.0]) for b in batches)
    rungs: dict[str, int] = {}
    for b in batches:
        rungs[str(b["rung"])] = rungs.get(str(b["rung"]), 0) + 1
    return {
        "plan_digest": plan.get("digest"),
        "mode": plan.get("mode"),
        "source": plan.get("source"),
        "n_batches": len(batches),
        "n_sites": int(plan.get("n_sites") or 0),
        "n_devices": int(plan.get("n_devices") or 1),
        "rungs": rungs,
        "pred_occupancy_packed": round(pred_total / packed_slots, 4) if packed_slots else 0.0,
        "pred_occupancy_unpacked": round(pred_total / flat_slots, 4) if flat_slots else 0.0,
        "pred_skew_packed": round(skew_packed, 3),
        "pred_skew_unpacked": round(skew_naive, 3),
    }


# -------------------------------------------------------------- plan file
def write_plan(path, plan: dict | None) -> None:
    """Persist the plan side file atomically (None removes it — a
    schedule-off re-init must not leave a stale plan behind)."""
    path = Path(path)
    if plan is None:
        path.unlink(missing_ok=True)
        return
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    tmp.write_text(json.dumps(plan, sort_keys=True))
    os.replace(tmp, path)


def load_plan(path) -> dict | None:
    """The recorded plan, or None when absent/unreadable (a torn write
    degrades to "no plan", never to an error on the resume path)."""
    try:
        plan = json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return None
    return plan if isinstance(plan, dict) and plan.get("batches") else None
