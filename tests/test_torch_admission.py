"""The port's admission queue against the JAX package's.

``tmlibrary_tpu_torch.workflow.admission`` keeps its own copy of the
reference's pure admission policy.  Random streams of offers, takes and
job outcomes (hypothesis, seeded) go through both queues: every
decision (admitted, reason, ``retry_after_s``), the weighted
deficit-round-robin service order, ``take_matching``, ``drain`` and the
status snapshots must be equal, value for value.
"""

import numpy as np
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tmlibrary_tpu.workflow import admission as j_adm
from tmlibrary_tpu_torch.workflow import admission

TENANTS = ("prod", "dev", "batch")
NOW = 1_000.0

op = st.one_of(
    st.tuples(st.just("offer"), st.sampled_from(TENANTS), st.integers(0, 2),
              st.integers(-1, 2), st.booleans(), st.integers(0, 40)),
    st.tuples(st.just("take")),
    st.tuples(st.just("result"), st.sampled_from(TENANTS), st.booleans()),
    st.tuples(st.just("fuse"), st.integers(0, 3)),
)


def replay(mod, config: dict, ops) -> list:
    queue = mod.AdmissionQueue(mod.AdmissionConfig(**config), clock=lambda: NOW)
    out = []
    for i, o in enumerate(ops):
        if o[0] == "offer":
            _, tenant, attempt, priority, expired, jid = o
            job = mod.JobSpec(job_id=f"j{jid}", root="/r", tenant=tenant, priority=priority,
                              attempt=attempt, submitted_at=float(i),
                              deadline=NOW - 1 if expired else None)
            out.append(("offer", queue.offer(job).to_dict()))
        elif o[0] == "take":
            job = queue.take()
            out.append(("take", None if job is None else job.job_id))
        elif o[0] == "result":
            queue.record_result(o[1], ok=o[2])
        else:
            out.append(("fuse", [j.job_id for j in queue.take_matching(
                lambda j: int(j.job_id[1:]) % 2 == 0, o[1])]))
        out.append(("snapshot", queue.snapshot(now=NOW)))
    out.append(("drain", [j.job_id for j in queue.drain()]))
    return out


CONFIGS = st.fixed_dictionaries({
    "max_queue": st.integers(2, 12),
    "low_watermark": st.integers(0, 6),
    "tenant_quota": st.integers(1, 8),
    "retry_budget": st.integers(0, 3),
    "tenant_weights": st.sampled_from([{}, {"prod": 3.0, "dev": 1.0},
                                       {"prod": 0.5, "batch": 2.0}]),
    "breaker_threshold": st.integers(1, 3),
})


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(config=CONFIGS, ops=st.lists(op, max_size=80))
def test_decisions_and_service_order_equal_the_references(config, ops):
    assert replay(admission, config, ops) == replay(j_adm, config, ops)


def test_wdrr_serves_by_weight_over_a_seeded_stream():
    rng = np.random.default_rng(7)
    ops = [("offer", str(rng.choice(["prod", "dev"])), 0, int(rng.integers(0, 3)), False, i)
           for i in range(40)] + [("take",)] * 45
    config = {"max_queue": 64, "tenant_quota": 32, "tenant_weights": {"prod": 3.0, "dev": 1.0}}
    ours = replay(admission, config, ops)
    assert ours == replay(j_adm, config, ops)
    served = [o[1] for o in ours if o[0] == "take" and o[1] is not None]
    assert len(served) == 40
    assert served[-1] is not None


def test_pinned_reasons_and_retry_after_equal_the_references():
    assert admission.SHED_REASONS == j_adm.SHED_REASONS
    assert admission.RETRY_AFTER_S == j_adm.RETRY_AFTER_S
    for reason in list(admission.RETRY_AFTER_S) + ["no_such_reason"]:
        assert admission.reject(reason).to_dict() == j_adm.reject(reason).to_dict()


def test_shedding_hysteresis_equals_the_references():
    ops = [("offer", "prod", 0, 0, False, i) for i in range(10)] + [("take",)] * 6 + \
        [("offer", "dev", 0, 0, False, 20 + i) for i in range(4)]
    config = {"max_queue": 6, "low_watermark": 2, "tenant_quota": 16}
    ours = replay(admission, config, ops)
    assert ours == replay(j_adm, config, ops)
    reasons = [o[1]["reason"] for o in ours if o[0] == "offer"]
    assert reasons[:6] == [None] * 6 and set(reasons[6:10]) == {"queue_full"}
    # the queue drained to 0 <= low watermark: admission resumes
    assert reasons[10:] == [None] * 4


def test_job_specs_round_trip_between_packages():
    spec = admission.JobSpec(job_id="a", root="/r", tenant="t", priority=2, deadline=5.0,
                             attempt=1, submitted_at=3.0, trace_id="x", kind="query",
                             payload={"tool": "knn"}, claim_epoch=4, affinity_key="k")
    ref = j_adm.JobSpec.from_dict(spec.to_dict())
    assert ref.to_dict() == spec.to_dict()
    assert admission.JobSpec.from_dict(ref.to_dict()) == spec
    cfg = admission.AdmissionConfig.from_library_config()
    assert cfg == admission.AdmissionConfig(**vars(j_adm.AdmissionConfig.from_library_config()))
