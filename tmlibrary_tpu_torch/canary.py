"""Synthetic canary probes + fleet anomaly detection (DESIGN.md §27).

Counterpart: ``tmlibrary_tpu/canary.py``, which imports no JAX; the port keeps
its own copy, held equal to it on the same inputs by
``tests/test_torch_slo_canary.py``.

Two halves of the observability plane's *proactive* layer:

Canary probes
    The serve daemon periodically enqueues a tiny self-addressed
    ``kind="canary"`` job per host.  The probe rides the normal
    spool → claim → done lifecycle — so its end-to-end latency measures
    the whole serving pipeline, not a hand-picked code path — but it is
    **invisible to tenants**: it never enters the admission queue (no
    quota, no WDRR deficit, no retry budget, no breaker), it never feeds
    the per-tenant SLO series, and its result is discarded (the spool
    file is deleted, not archived).  Its latency/success stream into the
    time-series and into :func:`slo.canary_report`'s per-host
    availability — the fleet's black-box health signal.

Anomaly detection
    An EWMA/z-score detector over ledger-derived signal streams —
    canary latency, job latency (throughput inverse), queue wait,
    scheduling-delay straggler skew, reclaim cadence, SLO burn.  The
    pinned contract: :func:`anomaly_report` is a **pure function of the
    ordered event window** — no wall clock, no randomness, no process
    state — so replaying a ledger reproduces the live daemon's anomaly
    sequence bit-identically (the same replay discipline as
    ``registry_from_ledger``).  Detection is latched inside the pure
    function itself: one anomaly per excursion, re-armed only when the
    stream returns under the threshold.  Like QC and SLO burn, anomalies
    are warn-only: a latched ``anomaly`` ledger event and a
    ``tmx_anomalies_total{metric,host}`` tick, never an abort.
"""

from __future__ import annotations

import math
import time
import zlib
from typing import Iterable

from tmlibrary_tpu_torch import faults
from tmlibrary_tpu_torch.errors import TransientDeviceError
from tmlibrary_tpu_torch.workflow.admission import JobSpec

#: the reserved job kind and pseudo-tenant canary probes run under; the
#: pseudo-tenant never reaches the admission queue or the SLO report —
#: it exists so ledger events are self-describing
CANARY_KIND = "canary"
CANARY_TENANT = "_canary"

#: a foreign host's probe older than this is debris from a dead daemon;
#: any live host may sweep it to ``rejected/`` (canaries are
#: self-addressed, so nobody else will ever execute it)
CANARY_STALE_S = 120.0

# ---- pinned detector constants (DESIGN.md §27) — part of the replay
# contract: live detection and ledger replay must run the same math
#: EWMA smoothing factor for mean and variance
ANOMALY_ALPHA = 0.3
#: samples a stream must accumulate before it can flag (warmup)
ANOMALY_MIN_SAMPLES = 5
#: |z| at or above this flags an anomaly
ANOMALY_THRESHOLD = 4.0
#: z denominator floor, relative to |EWMA|: keeps near-constant streams
#: (sub-ms canary latencies) from flagging on harmless jitter
ANOMALY_REL_FLOOR = 0.5
#: absolute z denominator floor, in the signal's own units (seconds for
#: the latency streams) — the scale below which excursions are noise
ANOMALY_ABS_FLOOR = 0.05
#: burn values are clamped here so an "inf" burn cannot poison the EWMA
ANOMALY_VALUE_CLAMP = 1e6


# ------------------------------------------------------------------ probe
def make_probe_spec(serve_root, host: str, seq: int,
                    now: float | None = None) -> JobSpec:
    """One self-addressed canary job spec.

    The job id embeds the submission time so a restarted daemon's first
    probe can never collide with a predecessor's; ``payload.seq`` is the
    per-daemon probe counter (the fault-injection context — chaos plans
    target "the Nth probe" through it)."""
    now = time.time() if now is None else float(now)
    return JobSpec(
        job_id=f"canary-{host}-{int(now * 1000):013x}",
        root=str(serve_root),
        tenant=CANARY_TENANT,
        kind=CANARY_KIND,
        submitted_at=now,
        payload={"host": host, "seq": int(seq)},
    )


def run_probe(payload: dict | None = None) -> dict:
    """Execute one canary probe: a tiny deterministic CPU checksum — the
    probe measures the *serving pipeline* (spool, claim, dispatch), not
    device throughput, so the work itself is microseconds.

    The ``canary_probe`` fault site fires here with the probe sequence
    as its batch context.  A ``hang`` fault sleeps then raises
    :class:`TransientDeviceError`; the probe absorbs it as a *degraded*
    success — a transient device blip is exactly what a canary exists to
    measure, and the inflated end-to-end latency is the signal.  Any
    other exception propagates and the probe fails."""
    payload = payload or {}
    degraded = False
    try:
        faults.maybe_fire("canary_probe", batch=payload.get("seq"))
    except TransientDeviceError:
        degraded = True
    seed = f"{payload.get('host', '')}/{payload.get('seq', 0)}"
    checksum = zlib.crc32(seed.encode())
    return {"ok": True, "degraded": degraded, "checksum": checksum}


# -------------------------------------------------------------- detector
def signal_samples(events: Iterable[dict]) -> list[tuple]:
    """Extract the detector's signal streams from ledger events, in
    event order: ``(metric, host, ts, value)`` tuples.

    Streams (the metric names the anomaly events carry):

    * ``canary_latency`` — canary ``job_done.elapsed_s``
    * ``job_seconds`` — non-canary ``job_done.elapsed_s`` (throughput
      inverse)
    * ``queue_wait`` — ``job_admitted.queue_wait_s``
    * ``straggler_skew`` — ``job_started.sched_delay_s`` (admit→start
      delay, the serving tier's straggler signal)
    * ``reclaim_gap`` — seconds between consecutive ``job_reclaimed``
      events per host (a shrinking gap is a reclaim storm)
    * ``slo_burn`` — ``slo_burn.burn`` values, clamped

    Pure: no wall clock, no state beyond the events themselves."""
    out: list[tuple] = []
    last_reclaim: dict[str, float] = {}
    for ev in events:
        kind = ev.get("event")
        ts = ev.get("ts")
        if ts is None:
            continue
        ts = float(ts)
        host = str(ev.get("host", "")) or "host0"
        if kind == "job_done" and ev.get("elapsed_s") is not None:
            metric = ("canary_latency" if ev.get("kind") == CANARY_KIND
                      else "job_seconds")
            out.append((metric, host, ts, float(ev["elapsed_s"])))
        elif (kind == "job_admitted"
              and ev.get("queue_wait_s") is not None
              and ev.get("kind") != CANARY_KIND):
            out.append(("queue_wait", host, ts,
                        float(ev["queue_wait_s"])))
        elif (kind == "job_started"
              and ev.get("sched_delay_s") is not None
              and ev.get("kind") != CANARY_KIND):
            out.append(("straggler_skew", host, ts,
                        float(ev["sched_delay_s"])))
        elif kind == "job_reclaimed":
            prev = last_reclaim.get(host)
            last_reclaim[host] = ts
            if prev is not None:
                out.append(("reclaim_gap", host, ts, max(0.0, ts - prev)))
        elif kind == "slo_burn":
            try:
                burn = float(ev.get("burn"))
            except (TypeError, ValueError):
                continue
            out.append(("slo_burn", host, ts,
                        min(burn, ANOMALY_VALUE_CLAMP)))
    return out


class _StreamState:
    __slots__ = ("mean", "var", "n", "armed", "anomalies")

    def __init__(self):
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.armed = True
        self.anomalies = 0


def anomaly_report(events: Iterable[dict],
                   alpha: float = ANOMALY_ALPHA,
                   min_samples: int = ANOMALY_MIN_SAMPLES,
                   threshold: float = ANOMALY_THRESHOLD) -> list[dict]:
    """The full anomaly sequence for an event window.

    A pure, prefix-stable function: the report over a ledger prefix is
    exactly the first k entries of the report over the full ledger, so a
    live daemon emitting anomalies incrementally and a post-hoc replay
    of the final ledger agree bit-identically (the acceptance contract).
    ``anomaly`` events in the input are ignored — the detector never
    feeds on its own output.

    Each record: ``{"metric", "host", "seq", "ts", "value", "ewma",
    "zscore"}`` with ``seq`` the anomaly's index within its
    (metric, host) stream.  Values are rounded here, once, so the ledger
    events the daemon writes carry exactly these numbers."""
    streams: dict[tuple, _StreamState] = {}
    out: list[dict] = []
    samples = signal_samples(
        ev for ev in events if ev.get("event") != "anomaly")
    for metric, host, ts, value in samples:
        st = streams.setdefault((metric, host), _StreamState())
        if st.n >= min_samples:
            std = math.sqrt(max(st.var, 0.0))
            floor = max(std, ANOMALY_REL_FLOOR * abs(st.mean),
                        ANOMALY_ABS_FLOOR)
            z = (value - st.mean) / floor
            if abs(z) >= threshold:
                if st.armed:
                    st.armed = False
                    out.append({
                        "metric": metric, "host": host,
                        "seq": st.anomalies, "ts": round(ts, 6),
                        "value": round(value, 6),
                        "ewma": round(st.mean, 6),
                        "zscore": round(z, 3),
                    })
                    st.anomalies += 1
                # anomalous samples never update the EWMA — a spike must
                # not drag the baseline toward itself, or a sustained
                # degradation would self-normalize and unlatch
                continue
            st.armed = True
        d = value - st.mean
        if st.n == 0:
            st.mean = value
        else:
            st.mean += alpha * d
            st.var = (1.0 - alpha) * (st.var + alpha * d * d)
        st.n += 1
    return out
