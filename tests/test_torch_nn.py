"""The port's DL segmentation (``tmlibrary_tpu_torch/nn``, the
``segment_dl_*`` modules, the ``dl`` configuration) against the JAX
package's on the same seeded inputs.

- Weights: seeded init byte-identical, content digests equal on the same
  parameters and on the same ``.npz`` written by either package; save,
  load, list, the resolve memo and ``stage_weights``.
- The U-Net head within ``HEAD_TIER`` (``chip_smoke.py``) of the
  reference's on the same standardized input, on 64x64, 96x96 and an odd
  67x45 site (the edge padding and the stride-2 SAME padding), and for an
  ``in=2`` net; the standardization within a few ulps (the port sums each
  site in float64, XLA-CPU in its own float32 order, so the means differ
  by ulps: exactness stops there); the sigmoid within 2 ulps near the
  0.6 threshold.
- The decoder bit-exact: ``follow_flows`` on zero flow, at the borders
  and on random flows; ``decode_flows`` on the reference's own head
  across thresholds, ``min_area``, connectivity and a capacity below the
  count; ``decode_secondary`` and its flood route against the port's
  plain ``propagate_labels``.
- End to end through ``build_batch_fn`` against the reference's
  ``build_batch_fn(jit=False)``: labels equal, or every decision that
  differs within the head tier of its boundary (``dl_flips``) and the
  labels those decisions give equal to each side's; features by
  ``FEATURE_TIERS`` on the sites whose labels agree; the ``__qc__``
  samples and the QC-on/off identity; the weight digests in the
  pipeline's identity; batch invariance of the head.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import FEATURE_TIERS, HEAD_TIER, dl_flips, feature_tier
from tmlibrary_tpu import nn as jnn
from tmlibrary_tpu.benchmarks import dl_description as j_dl_description
from tmlibrary_tpu.benchmarks import synthetic_cell_painting_batch
from tmlibrary_tpu.jterator import modules as j_modules
from tmlibrary_tpu.jterator.description import PipelineDescription as JDescription
from tmlibrary_tpu.jterator.pipeline import MODEL_QC_KEY as J_MODEL_QC_KEY
from tmlibrary_tpu.jterator.pipeline import ImageAnalysisPipeline as JPipeline
from tmlibrary_tpu.models.experiment import grid_experiment as j_grid_experiment
from tmlibrary_tpu.models.store import ExperimentStore as JStore
from tmlibrary_tpu.ops.segment_secondary import propagate_labels as j_propagate
from tmlibrary_tpu_torch import benchmarks, cli, nn
from tmlibrary_tpu_torch.errors import StoreError
from tmlibrary_tpu_torch.jterator import modules
from tmlibrary_tpu_torch.jterator.description import PipelineDescription
from tmlibrary_tpu_torch.jterator.pipeline import (
    MODEL_QC_KEY,
    ImageAnalysisPipeline,
    from_jax_inputs,
    pipeline_identity,
    site_result_to_numpy,
    weight_digests,
)
from tmlibrary_tpu_torch.models.experiment import grid_experiment
from tmlibrary_tpu_torch.models.store import ExperimentStore
from tmlibrary_tpu_torch.ops import kernels
from tmlibrary_tpu_torch.ops.segment_secondary import propagate_labels

torch.set_num_threads(1)

SPECS = ("seed:0", "seed:3:base=4:depth=1", "seed:5:in=2")
THRESHOLD = 0.6


@pytest.fixture(autouse=True)
def _weights_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TMX_WEIGHTS_DIR", str(tmp_path / "weights"))


def dapi(n, size, seed=1):
    return synthetic_cell_painting_batch(n, size=size, seed=seed, dapi_only=True)["DAPI"]


def j_heads(params, images):
    """The reference's standardized images and ``(B, 3, H, W)`` heads."""
    cfg = jnn.infer_config(params)
    norm = np.stack([np.asarray(jnn.normalize_image(jnp.asarray(x))) for x in images])
    heads = np.stack([np.asarray(jnn.unet_apply(params, jnp.asarray(x), cfg)) for x in norm])
    return norm, np.ascontiguousarray(heads.transpose(0, 3, 1, 2))


def j_prob(head):
    return np.asarray(jax.nn.sigmoid(jnp.asarray(head[:, 2])))


def t_heads(spec, images):
    """The port's standardized images, heads and probabilities on the CPU."""
    net, _ = nn.unet_for(spec, torch.device("cpu"))
    norm = nn.normalize_image(torch.from_numpy(images))
    head = net(norm[:, None])
    return norm.numpy(), head.numpy(), torch.sigmoid(head[:, 2]).numpy()


# ------------------------------------------------------------------ weights
@pytest.mark.parametrize("spec", SPECS)
def test_seeded_weights_are_byte_identical(spec):
    want, want_digest, want_cfg = jnn.resolve_weights(spec)
    got, digest, cfg = nn.resolve_weights(spec)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
    assert digest == want_digest == nn.weights_digest(spec) == jnn.params_digest(got)
    assert (cfg.in_channels, cfg.base_channels, cfg.depth) == \
        (want_cfg.in_channels, want_cfg.base_channels, want_cfg.depth)
    assert nn.infer_config(got) == cfg


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_digests_agree_on_a_checkpoint_written_by_either_package(tmp_path, writer):
    params = nn.init_unet_params(9, nn.UNetConfig(base_channels=4, depth=1))
    save = nn.save_weights if writer == "port" else jnn.save_weights
    path = save("ckpt", params, meta={"trained": False}, directory=tmp_path)
    for load in (nn.load_weights, jnn.load_weights):
        got, meta = load(str(path))
        assert meta == {"trained": False}
        assert nn.params_digest(got) == jnn.params_digest(got) == nn.params_digest(params)
    assert nn.weights_digest(str(path)) == jnn.weights_digest(str(path))
    assert nn.list_weights(tmp_path) == jnn.list_weights(tmp_path)


def test_save_load_list_and_the_memo_follow_the_file(tmp_path):
    a = nn.init_unet_params(1, nn.UNetConfig(base_channels=4, depth=1))
    b = nn.init_unet_params(2, nn.UNetConfig(base_channels=4, depth=1))
    path = nn.save_weights("net", a)
    assert path.parent == nn.weights_dir() and path.name == "net.npz"
    got, meta = nn.load_weights("net")
    assert meta == {} and all(np.array_equal(got[k], a[k]) for k in a)
    first = nn.weights_digest("net")
    assert first == nn.params_digest(a) == jnn.weights_digest("net")
    nn.save_weights("net", {**b, "extra/b": np.zeros(1, np.float32)})
    assert nn.weights_digest("net") != first  # the memo follows the file's identity
    rows = nn.list_weights()
    assert [r["name"] for r in rows] == ["net"] and rows[0]["n_arrays"] == len(b) + 1
    assert rows == jnn.list_weights()
    with pytest.raises(StoreError):
        nn.resolve_weights("absent")
    with pytest.raises(StoreError):
        nn.resolve_weights("  ")


def test_stage_weights_matches_the_reference_store(tmp_path):
    params = nn.init_unet_params(4, nn.UNetConfig(base_channels=4, depth=1))
    exp = grid_experiment("w", well_rows=1, well_cols=1, sites_per_well=(1, 1),
                          channel_names=("DAPI",), site_shape=(8, 8))
    jexp = j_grid_experiment("w", well_rows=1, well_cols=1, sites_per_well=(1, 1),
                             channel_names=("DAPI",), site_shape=(8, 8))
    got = ExperimentStore.create(tmp_path / "port", exp).stage_weights("m", params, {"k": 1})
    want = JStore.create(tmp_path / "ref", jexp).stage_weights("m", params, {"k": 1})
    assert got == tmp_path / "port" / "weights" / "m.npz"
    assert got.read_bytes() == want.read_bytes()
    assert nn.weights_digest(str(got)) == jnn.weights_digest(str(want))


# ------------------------------------------------------------------ the net
@pytest.mark.parametrize("shape", [(64, 64), (96, 96), (67, 45)])
def test_unet_head_within_its_tier(shape):
    h, w = shape
    images = dapi(2, max(h, w))[:, :h, :w]
    params, _, _ = jnn.resolve_weights("seed:0")
    j_norm, j_head = j_heads(params, images)
    t_norm, _, _ = t_heads("seed:0", images)
    # the standardization: ulps of the site means (another summation order)
    np.testing.assert_allclose(t_norm, j_norm, rtol=0, atol=4 * np.spacing(np.float32(8.0)))
    # the head on the same standardized input
    net, _ = nn.unet_for("seed:0", torch.device("cpu"))
    head = net(torch.from_numpy(j_norm)[:, None]).numpy()
    assert head.shape == (2, 3, h, w) and head.dtype == np.float32
    rel = np.abs(head - j_head).max() / np.abs(j_head).max()
    print(f"head {shape}: largest |port - reference| / max|head| = {rel:.3g}")
    assert rel <= HEAD_TIER


def test_unet_with_two_input_channels():
    params, _, _ = jnn.resolve_weights("seed:5:in=2:base=4:depth=1")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 30, 22, 2)).astype(np.float32)
    want = np.stack([np.asarray(jnn.unet_apply(params, jnp.asarray(s))) for s in x])
    got = nn.params_from_numpy(params)(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=0,
                               atol=HEAD_TIER * np.abs(want).max())


def test_head_is_batch_invariant():
    images = dapi(11, 64, seed=4)
    _, whole, _ = t_heads("seed:0", images)
    for part in (images[:1], images[5:6], images[3:11]):
        _, head, _ = t_heads("seed:0", part)
        start = next(i for i in range(11) if np.array_equal(images[i], part[0]))
        np.testing.assert_array_equal(head, whole[start:start + len(part)])


def test_sigmoid_near_the_threshold():
    logit = np.float32(np.log(THRESHOLD / (1 - THRESHOLD)))
    z = (logit + np.linspace(-1e-3, 1e-3, 4001)).astype(np.float32)
    want = np.asarray(jax.nn.sigmoid(jnp.asarray(z)))
    got = torch.sigmoid(torch.from_numpy(z)).numpy()
    diff = np.abs(got - want)
    print(f"sigmoid near logit(0.6): {int((diff > 0).sum())} of {z.size} differ, "
          f"largest {diff.max():.3g}")
    assert diff.max() <= 2 * np.spacing(np.float32(THRESHOLD))


def test_unet_costs_match_the_reference():
    for spec in SPECS:
        cfg = nn.resolve_weights(spec)[2]
        jcfg = jnn.resolve_weights(spec)[2]
        for h, w in ((256, 256), (67, 45)):
            assert nn.unet_flops(cfg, h, w) == jnn.unet_flops(jcfg, h, w)
            assert nn.unet_io_bytes(cfg, h, w) == jnn.unet_io_bytes(jcfg, h, w)
    assert nn.unet_flops(nn.UNetConfig(), 256, 256) == 1_069_547_520


# -------------------------------------------------------------- the decoder
def test_follow_flows_on_zero_flow_and_at_the_borders():
    h, w = 9, 7
    zero = np.zeros((1, 2, h, w), np.float32)
    yy, xx = nn.follow_flows(torch.from_numpy(zero))
    np.testing.assert_array_equal(yy[0].numpy(), np.arange(h)[:, None].repeat(w, 1))
    np.testing.assert_array_equal(xx[0].numpy(), np.arange(w)[None, :].repeat(h, 0))
    out = np.stack([np.full((h, w), -1.0), np.full((h, w), 1.0)]).astype(np.float32)[None]
    yy, xx = nn.follow_flows(torch.from_numpy(out), n_steps=24)
    assert (yy == 0).all() and (xx == w - 1).all()
    rng = np.random.default_rng(0)
    flow = rng.normal(size=(3, 2, 40, 33)).astype(np.float32)
    flow[flow > 1.5] = 0.0
    yy, xx = nn.follow_flows(torch.from_numpy(flow), n_steps=13)
    for s in range(3):
        jy, jx = jnn.follow_flows(jnp.asarray(flow[s].transpose(1, 2, 0)), 13)
        np.testing.assert_array_equal(yy[s].numpy(), np.asarray(jy))
        np.testing.assert_array_equal(xx[s].numpy(), np.asarray(jx))


@pytest.fixture(scope="module")
def ref_head():
    """The reference's heads and probabilities of 3 sites of 96x96."""
    params, _, _ = jnn.resolve_weights("seed:0")
    _, head = j_heads(params, dapi(3, 96, seed=2))
    return head, j_prob(head)


@pytest.mark.parametrize("threshold,min_area,connectivity,max_objects", [
    (0.6, 4, 8, 256), (0.5, 0, 8, 256), (0.6, 0, 4, 256), (0.45, 9, 4, 256),
    (0.6, 4, 8, 3),
])
def test_decode_flows_is_bit_exact(ref_head, threshold, min_area, connectivity, max_objects):
    head, prob = ref_head
    kw = dict(prob_threshold=threshold, min_area=min_area, connectivity=connectivity,
              max_objects=max_objects)
    labels, count = nn.decode_flows(torch.from_numpy(head[:, :2]), torch.from_numpy(prob), **kw)
    for s in range(len(head)):
        jl, jc = jnn.decode_flows(jnp.asarray(head[s, :2].transpose(1, 2, 0)),
                                  jnp.asarray(prob[s]), **kw)
        np.testing.assert_array_equal(labels[s].numpy(), np.asarray(jl))
        assert int(count[s]) == int(jc)
    assert labels.dtype == torch.int32
    if max_objects == 3:
        assert (count == 3).all()


@pytest.mark.parametrize("connectivity", [4, 8])
def test_decode_secondary_is_bit_exact_and_its_flood_is_propagate(ref_head, connectivity):
    head, prob = ref_head
    primary, _ = nn.decode_flows(torch.from_numpy(head[:, :2]), torch.from_numpy(prob),
                                 prob_threshold=THRESHOLD, min_area=4)
    for max_objects in (256, 4):
        got, count = nn.decode_secondary(primary, torch.from_numpy(prob), THRESHOLD,
                                         connectivity, max_objects)
        for s in range(len(head)):
            jl, jc = jnn.decode_secondary(jnp.asarray(primary[s].numpy()), jnp.asarray(prob[s]),
                                          THRESHOLD, connectivity, max_objects)
            np.testing.assert_array_equal(got[s].numpy(), np.asarray(jl))
            assert int(count[s]) == int(jc)
    # the flood of one level over a flat intensity is propagate_labels
    mask = (torch.from_numpy(prob) >= THRESHOLD) | (primary > 0)
    flood = kernels.watershed_flood(torch.zeros(mask.shape), primary, mask, n_levels=1,
                                    connectivity=connectivity)
    plain = propagate_labels(primary, mask, connectivity)
    np.testing.assert_array_equal(flood.numpy(), plain.numpy())
    for s in range(len(head)):
        want = j_propagate(jnp.asarray(primary[s].numpy()), jnp.asarray(mask[s].numpy()),
                           connectivity)
        np.testing.assert_array_equal(plain[s].numpy(), np.asarray(want))


# ------------------------------------------------------------ end to end
def _descriptions():
    return {
        "dl": (j_dl_description(), benchmarks.dl_description()),
        "dl_secondary": (JDescription.from_dict(benchmarks.dl_secondary_pipe()),
                         PipelineDescription.from_dict(benchmarks.dl_secondary_pipe())),
    }


@pytest.fixture(scope="module")
def e2e():
    data = {"DAPI": dapi(4, 80, seed=6)}
    out = {}
    for name, (jdesc, tdesc) in _descriptions().items():
        jfn = JPipeline(jdesc, max_objects=32).build_batch_fn(jit=False, qc=True)
        jres, jqc = jfn({"DAPI": jnp.asarray(data["DAPI"])}, {}, jnp.zeros((4, 2), jnp.int32))
        raw, st, sh = from_jax_inputs(data, {}, np.zeros((4, 2)), device="cpu")
        pipe = ImageAnalysisPipeline(tdesc, max_objects=32, device="cpu")
        tres, tqc = pipe.build_batch_fn(qc=True)(raw, st, sh)
        plain = pipe.build_batch_fn()(raw, st, sh)
        out[name] = {"ref": jres, "ref_qc": jqc, "port": site_result_to_numpy(tres),
                     "port_qc": tqc, "plain": site_result_to_numpy(plain)}
    params, _, _ = jnn.resolve_weights("seed:0")
    _, head = j_heads(params, data["DAPI"])
    _, t_head, t_prob = t_heads("seed:0", data["DAPI"])
    out["heads"] = {"want": {"head": head, "prob": j_prob(head)},
                    "got": {"head": t_head, "prob": t_prob}}
    out["data"] = data
    return out


def _decode_all(side, name):
    """The labels each side's head gives through the port's decoder (the
    decoder is bit-exact, so this is either package's)."""
    head, prob = torch.from_numpy(side["head"]), torch.from_numpy(side["prob"])
    nuclei, _ = nn.decode_flows(head[:, :2], prob, prob_threshold=THRESHOLD, min_area=4,
                                max_objects=32)
    if name == "dl":
        return {"cells": nuclei.numpy()}
    cells, _ = nn.decode_secondary(nuclei, prob, THRESHOLD, max_objects=32)
    return {"nuclei": nuclei.numpy(), "cells": cells.numpy()}


@pytest.mark.parametrize("name", ["dl", "dl_secondary"])
def test_dl_pipeline_labels_by_the_boundary_rule(e2e, name):
    run, heads = e2e[name], e2e["heads"]
    flips = dl_flips(heads["want"], heads["got"], THRESHOLD)
    want, got = _decode_all(heads["want"], name), _decode_all(heads["got"], name)
    exact = np.ones(4, bool)
    for obj in want:
        np.testing.assert_array_equal(np.asarray(run["ref"].objects[obj]), want[obj])
        np.testing.assert_array_equal(run["port"].objects[obj], got[obj])
        np.testing.assert_array_equal(run["port"].counts[obj],
                                      got[obj].reshape(4, -1).max(axis=1))
        exact &= (want[obj] == got[obj]).reshape(4, -1).all(axis=1)
    print(f"{name}: {int(exact.sum())} of 4 sites exact; head {flips}")
    for obj, feats in run["ref"].measurements.items():
        counts = np.asarray(run["ref"].counts[obj])
        for feat, arr in feats.items():
            rtol, atol = feature_tier(feat)
            for s in np.flatnonzero(exact):
                np.testing.assert_allclose(run["port"].measurements[obj][feat][s, :counts[s]],
                                           np.asarray(arr)[s, :counts[s]], rtol=rtol,
                                           atol=atol, err_msg=feat)
    assert set(FEATURE_TIERS) >= {"Intensity_sum", "Intensity_mean"}


@pytest.mark.parametrize("name", ["dl", "dl_secondary"])
def test_qc_streams_and_outputs_with_qc_on_and_off(e2e, name):
    run = e2e[name]
    streams = run["port_qc"][MODEL_QC_KEY]
    want = run["ref_qc"][J_MODEL_QC_KEY]
    assert sorted(streams) == sorted(want)
    for k, v in streams.items():
        assert v.shape == (4, 64) and v.dtype == torch.float32
        # the samples of a head within its tier
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=0,
                                   atol=HEAD_TIER * 8 * max(1.0, np.abs(want[k]).max()))
    assert sorted(k for k in run["port_qc"] if k != MODEL_QC_KEY) == ["DAPI"]
    for obj in run["plain"].objects:
        np.testing.assert_array_equal(run["plain"].objects[obj], run["port"].objects[obj])
        for feat, arr in run["plain"].measurements[obj].items():
            np.testing.assert_array_equal(arr, run["port"].measurements[obj][feat])


def test_qc_sample_is_exact():
    rng = np.random.default_rng(8)
    for shape in ((3, 64, 64), (2, 67, 45), (1, 5, 7)):
        values = rng.normal(size=shape).astype(np.float32)
        got = modules._qc_sample(torch.from_numpy(values)).numpy()
        want = np.stack([np.asarray(j_modules._qc_sample(jnp.asarray(v))) for v in values])
        np.testing.assert_array_equal(got, want)
    assert modules.MODULE_QC_PREFIX == j_modules.MODULE_QC_PREFIX
    assert MODEL_QC_KEY == J_MODEL_QC_KEY


def test_weight_digests_join_the_pipeline_identity(tmp_path):
    spec = str(tmp_path / "net.npz")
    nn.save_weights(spec, nn.init_unet_params(1, nn.UNetConfig(base_channels=4, depth=1)))
    desc = benchmarks.dl_description(weights=spec)
    first = pipeline_identity(desc, qc=False)
    assert weight_digests(desc) == (("segment_dl_primary", spec, nn.weights_digest(spec)),)
    assert pipeline_identity(desc, qc=True) != first
    nn.save_weights(spec, nn.init_unet_params(2, nn.UNetConfig(base_channels=4, depth=1)))
    assert pipeline_identity(desc, qc=False) != first
    assert pipeline_identity(benchmarks.cell_painting_description()) == (("qc", False),)


def test_the_nets_stay_resident():
    a, da = nn.unet_for("seed:0", torch.device("cpu"))
    b, db = nn.unet_for("seed:0", torch.device("cpu"))
    assert a is b and da == db == jnn.weights_digest("seed:0")


def test_weights_cli_verbs(tmp_path, capsys):
    assert cli.main(["weights", "digest", "seed:0", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["digest"] == jnn.weights_digest("seed:0")
    assert out["config"] == {"in_channels": 1, "base_channels": 8, "depth": 2}
    assert cli.main(["weights", "list", "--dir", str(tmp_path)]) == 0
    assert "no checkpoints" in capsys.readouterr().out
    nn.save_weights("a", nn.init_unet_params(0, nn.UNetConfig(base_channels=4, depth=1)),
                    directory=tmp_path)
    assert cli.main(["weights", "list", "--dir", str(tmp_path), "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert [r["name"] for r in rows] == ["a"]
    assert rows[0]["digest"] == jnn.list_weights(tmp_path)[0]["digest"]


def test_the_dl_and_qc_modules_import_neither_jax_nor_the_jax_package():
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys, torch\n"
        "from tmlibrary_tpu_torch import nn, qc, benchmarks\n"
        "from tmlibrary_tpu_torch.jterator.pipeline import ImageAnalysisPipeline\n"
        "x = torch.rand(2, 32, 32) * 1000\n"
        "fn = ImageAnalysisPipeline(benchmarks.dl_description(), 16, device='cpu')"
        ".build_batch_fn(qc=True)\n"
        "fn({'DAPI': x}, {}, torch.zeros(2, 2, dtype=torch.int32))\n"
        "qc.QCSession().snapshot()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'tmlibrary_tpu' or m.startswith('tmlibrary_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stdout + out.stderr
