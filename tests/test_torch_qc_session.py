"""The port's QC session (``tmlibrary_tpu_torch/qc.py``) against the JAX
package's ``tmlibrary_tpu/qc.py`` on the same inputs: the gate's
resolution, ``P2Quantile``, ``FeatureSketch``, ``merge_sketch_dicts``,
``QCSession.observe_batch``/``observe_illumination``/``snapshot`` (summaries,
flags and profiles equal, the write time aside), profile files and their
merge, the ledger fallback, ``filter_profile_kind``, ``compare_profiles``
and its exit codes, ``record_summary``, and the ``qc`` CLI verb's exit
codes.  Every comparison is exact: both sessions run the same float64
host arithmetic.
"""

import json
import math

import numpy as np
import pytest

from tmlibrary_tpu import qc as jqc
from tmlibrary_tpu_torch import cli
from tmlibrary_tpu_torch import qc
from tmlibrary_tpu_torch.models.experiment import grid_experiment
from tmlibrary_tpu_torch.models.store import ExperimentStore
from tmlibrary_tpu_torch.workflow.engine import RunLedger


@pytest.fixture(autouse=True)
def _fresh_sessions(monkeypatch):
    for mod in (qc, jqc):
        mod.set_enabled(None)
        mod.reset_session()
    monkeypatch.delenv("TMX_QC", raising=False)
    monkeypatch.delenv("TM_QC", raising=False)
    monkeypatch.delenv("TMX_HOST_ID", raising=False)
    monkeypatch.delenv("TMX_QC_STALE_HOURS", raising=False)
    yield
    for mod in (qc, jqc):
        mod.set_enabled(None)
        mod.reset_session()


def strip_time(profile: dict) -> dict:
    return {k: v for k, v in profile.items() if k != "written_at_unix"}


def test_constants_match_the_reference():
    for name in ("QC_SCHEMA_VERSION", "MODEL_OBJECTS", "EXIT_OK", "EXIT_DRIFT", "EXIT_STALE",
                 "EXIT_NO_REFERENCE", "SATURATION_FLAG_FRAC", "Z_FLAG_THRESHOLD",
                 "Z_MIN_SITES", "QUANTILE_SAMPLE_CAP", "WORST_SITES_KEPT", "FLAGGED_KEPT"):
        assert getattr(qc, name) == getattr(jqc, name), name


@pytest.mark.parametrize("override,env,setting,want", [
    (None, None, None, False),
    (None, None, "1", True),
    (None, "0", "1", False),
    (None, "yes", None, True),
    (False, "1", "1", False),
    (True, "off", None, True),
])
def test_the_gate_resolves_as_the_reference(monkeypatch, override, env, setting, want):
    if env is not None:
        monkeypatch.setenv("TMX_QC", env)
    if setting is not None:
        monkeypatch.setenv("TM_QC", setting)
    qc.set_enabled(override)
    jqc.set_enabled(override)
    assert qc.enabled() is jqc.enabled() is want
    assert (qc.get_session() is qc._NULL_SESSION) is not want
    assert qc.get_session(True) is not qc._NULL_SESSION
    assert qc.get_session(False) is qc._NULL_SESSION


def test_the_null_session_does_nothing():
    s = qc.get_session()
    assert s.enabled is False
    assert s.observe_batch("jterator", [0]) is None
    assert s.observe_illumination("DAPI", [1.0], [2.0]) is None
    assert s.snapshot() == {}
    assert qc.record_summary() is None


@pytest.mark.parametrize("q", [0.5, 0.95, 0.1])
@pytest.mark.parametrize("n", [0, 3, 5, 400])
def test_p2_quantile_matches(q, n):
    values = np.random.default_rng(n).lognormal(size=n)
    a, b = qc.P2Quantile(q), jqc.P2Quantile(q)
    for v in values:
        a.update(v)
        b.update(v)
    got, want = a.value(), b.value()
    assert (math.isnan(got) and math.isnan(want)) or got == want
    assert a.count == b.count == n


def test_feature_sketch_and_merge_match():
    rng = np.random.default_rng(2)
    batches = [rng.normal(size=k) for k in (0, 7, 300, 1000)]
    batches[2][[3, 9]] = np.nan
    batches[3][5] = np.inf
    sketches = [qc.FeatureSketch(), qc.FeatureSketch()]
    j_sketches = [jqc.FeatureSketch(), jqc.FeatureSketch()]
    for i, vals in enumerate(batches):
        assert sketches[i % 2].update(vals) == j_sketches[i % 2].update(vals)
    a, b = (s.to_dict() for s in sketches)
    ja, jb = (s.to_dict() for s in j_sketches)
    assert a == ja and b == jb
    assert a["nan"] + b["nan"] == 2 and a["inf"] + b["inf"] == 1
    assert qc.merge_sketch_dicts(a, b) == jqc.merge_sketch_dicts(ja, jb)
    assert qc.merge_sketch_dicts({}, {}) == jqc.merge_sketch_dicts({}, {})
    assert qc.FeatureSketch().to_dict() == jqc.FeatureSketch().to_dict()


def _batches(n_batches=4, b=8, seed=0):
    """Seeded jterator batches as the persist path hands them over."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        counts = {"cells": rng.integers(0, 12, b).astype(np.int32),
                  "nuclei": rng.integers(0, 12, b).astype(np.int32)}
        if i == 3:
            counts["nuclei"][2] = 90  # an object-count outlier once armed
        feats = {"Intensity_mean_DAPI": rng.normal(500, 50, (b, 16)).astype(np.float32),
                 "Morphology_area": rng.integers(5, 90, (b, 16)).astype(np.float32)}
        if i == 1:
            feats["Intensity_mean_DAPI"][0, 0] = np.nan
        image = {"DAPI": {"saturation_frac": rng.uniform(0, 0.3, b).astype(np.float32),
                          "background": rng.normal(300, 5, b).astype(np.float32),
                          "focus_tenengrad": rng.normal(50, 2, b).astype(np.float32),
                          "laplacian_var": rng.normal(9, 1, b).astype(np.float32)}}
        if i == 2:
            image["DAPI"]["saturation_frac"][4] = 0.8
            image["DAPI"]["focus_tenengrad"][1] = 1.0  # out of focus
        model = {"flow_mag": rng.uniform(0, 3, (b, 64)).astype(np.float32),
                 "cell_prob": rng.uniform(0, 1, (b, 64)).astype(np.float32)}
        out.append({"sites": list(range(i * b, (i + 1) * b)), "image_stats": image,
                    "counts": counts,
                    "measurements": {"nuclei": feats, "cells": feats,
                                     qc.MODEL_OBJECTS: model},
                    "saturated": i == 0})
    return out


def _observe(mod, batches):
    s = mod.QCSession()
    s.observe_illumination("DAPI", np.float32([1.0, 50.0, 99.9]), [100.0, 700.0, 4000.0])
    summaries = [s.observe_batch("jterator", **b) for b in batches]
    return s, summaries


def test_observe_batch_and_snapshot_match():
    batches = _batches()
    got_s, got = _observe(qc, batches)
    want_s, want = _observe(jqc, batches)
    assert got == want
    assert any(x["flagged_sites"] for x in got)
    assert any(f["reason"] == "object_count" for x in got for f in x["flagged_sites"])
    assert {f["reason"] for x in got for f in x["flagged_sites"]} >= {"saturation", "focus"}
    snap, jsnap = got_s.snapshot(), want_s.snapshot()
    assert strip_time(snap) == strip_time(jsnap)
    assert snap["host"] == "host0" and snap["illumination"]["DAPI"]["p99.9"] == 4000.0
    assert "__model__.flow_mag" in snap["features"]
    assert snap["features"]["__model__.flow_mag"]["count"] == 4 * 8 * 64
    assert snap["guards"]["nan_columns"] == ["cells.Intensity_mean_DAPI",
                                             "nuclei.Intensity_mean_DAPI"]


def test_profiles_merge_and_the_ledger_fallback(tmp_path, monkeypatch):
    batches = _batches(seed=5)
    profiles = []
    for host, part in (("host0", batches[:2]), ("host1", batches[2:])):
        monkeypatch.setenv("TMX_HOST_ID", host)
        s, _ = _observe(qc, part)
        profiles.append((host, s.snapshot()))
        qc.write_profile(qc.profile_path(tmp_path), s.snapshot())
    assert sorted(p.name for p in tmp_path.glob("qc.*.json")) == ["qc.host0.json",
                                                                    "qc.host1.json"]
    pairs = qc.load_run_profiles(tmp_path)
    assert [h for h, _ in pairs] == ["host0", "host1"]
    assert pairs == jqc.load_run_profiles(tmp_path)
    merged = qc.merge_profiles(pairs)
    assert merged == jqc.merge_profiles(pairs)
    assert merged["steps"]["jterator"]["sites"] == 32
    assert qc.load_profile(tmp_path / "absent.json") is None
    _, summaries = _observe(qc, batches)
    events = [{"event": "qc_batch", "step": "jterator", "batch": i, "summary": {
        k: v for k, v in s.items() if k != "flagged_sites"}} for i, s in enumerate(summaries)]
    events += [{"event": "qc_site", "step": "jterator", "batch": 2, **f}
               for f in summaries[2]["flagged_sites"]]
    assert qc.qc_from_ledger(events) == jqc.qc_from_ledger(events)


def _profile(shift=0.0, nan=0, sat=0.1, written=None):
    return {"written_at_unix": written or 1000.0,
            "features": {"nuclei.area": {"count": 10, "p50": 50.0 + shift, "p95": 60.0,
                                         "nan": nan, "inf": 0},
                         "__model__.cell_prob": {"count": 64, "p50": 0.4 + shift / 100,
                                                 "p95": 0.9, "nan": 0, "inf": 0}},
            "channels": {"DAPI": {"saturation_frac": {"max": sat}}}}


@pytest.mark.parametrize("current,reference,kw", [
    (_profile(), None, {}),
    (_profile(), _profile(), {}),
    (_profile(shift=5.0), _profile(), {}),
    (_profile(nan=2), _profile(), {}),
    (_profile(sat=0.5), _profile(), {}),
    (_profile(), _profile(written=1.0), {"stale_hours": 0.1, "now": 4000.0}),
    (_profile(shift=5.0), _profile(written=1.0), {"stale_hours": 0.1, "now": 4000.0}),
    (_profile(shift=1.0), _profile(), {"threshold": 1.0}),
])
@pytest.mark.parametrize("kind", [None, "run", "model"])
def test_compare_profiles_and_its_exit_codes(current, reference, kw, kind):
    if kind is not None:
        current = qc.filter_profile_kind(current, kind)
        assert current == jqc.filter_profile_kind(current, kind)
        reference = qc.filter_profile_kind(reference, kind)
    kw = {"now": 4000.0, **kw}  # one clock for both
    got = qc.compare_profiles(current, reference, **kw)
    assert got == jqc.compare_profiles(current, reference, **kw)
    assert got["exit_code"] in (qc.EXIT_OK, qc.EXIT_DRIFT, qc.EXIT_STALE, qc.EXIT_NO_REFERENCE)


def test_filter_profile_kind():
    p = _profile()
    assert list(qc.filter_profile_kind(p, "model")["features"]) == ["__model__.cell_prob"]
    assert qc.filter_profile_kind(p, "model")["channels"] == {}
    assert list(qc.filter_profile_kind(p, "run")["features"]) == ["nuclei.area"]
    assert qc.filter_profile_kind(None, "run") is None
    with pytest.raises(ValueError):
        qc.filter_profile_kind(p, "other")


def test_record_summary_matches():
    qc.set_enabled(True)
    jqc.set_enabled(True)
    assert qc.record_summary() is None
    batches = _batches(seed=3)
    for mod in (qc, jqc):
        for b in batches:
            mod.get_session().observe_batch("jterator", **b)
    assert qc.record_summary() == jqc.record_summary() is not None


def test_the_qc_verb_exit_codes(tmp_path, capsys):
    exp = grid_experiment("q", well_rows=1, well_cols=1, sites_per_well=(1, 1),
                          channel_names=("DAPI",), site_shape=(8, 8))
    root = tmp_path / "s"
    store = ExperimentStore.create(root, exp)
    assert cli.main(["qc", "--root", str(root)]) == 1  # no evidence
    capsys.readouterr()
    s, summaries = _observe(qc, _batches(seed=7))
    qc.write_profile(store.workflow_dir / "qc.json", s.snapshot())
    assert cli.main(["qc", "--root", str(root), "--json"]) == qc.EXIT_NO_REFERENCE
    out = json.loads(capsys.readouterr().out)
    assert out["source"] == "qc.json" and out["verdict"]["status"] == "no_reference"
    same = tmp_path / "same.json"
    qc.write_profile(same, s.snapshot())
    for kind in ("run", "model"):
        assert cli.main(["qc", "--root", str(root), "--reference", str(same),
                         "--profile-kind", kind]) == qc.EXIT_OK
    drifted = s.snapshot()
    for sk in drifted["features"].values():
        if sk.get("p50") is not None:
            sk["p50"] = sk["p50"] * 3 + 100.0
    qc.write_profile(same, drifted)
    assert cli.main(["qc", "--root", str(root), "--reference", str(same)]) == qc.EXIT_DRIFT
    text = capsys.readouterr().out
    assert "drift verdict: drift (exit 1)" in text
    # without qc.json the verb reads the ledger's qc events
    (store.workflow_dir / "qc.json").unlink()
    ledger = RunLedger(store.workflow_dir / "ledger.jsonl")
    for i, summary in enumerate(summaries):
        ledger.append(step="jterator", event="qc_batch", batch=i,
                      summary={k: v for k, v in summary.items() if k != "flagged_sites"})
    assert cli.main(["qc", "--root", str(root), "--json"]) == qc.EXIT_NO_REFERENCE
    assert json.loads(capsys.readouterr().out)["source"] == "ledger"
