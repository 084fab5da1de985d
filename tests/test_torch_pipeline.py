"""The port's Cell Painting slice end to end, against the JAX package.

The same synthetic sites go through ``build_batch_fn(jit=False)`` of the
JAX package and through the port on ``device="cpu"``: labels and object
counts bit for bit, every feature within the tier that ``FEATURE_TIERS``
(``chip_smoke.py``) names for it (min/max, counts and quantiles exact,
sums and means ``rtol=1e-6``, std ``rtol=1e-3, atol=1e-4``, the
transcendental families their own).  The frozen golden
(``tests/golden/cell_painting.npz``) is held the same way.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import CARD_TIERS, FEATURE_TIERS, feature_tier
from tmlibrary_tpu.benchmarks import cell_painting_description as j_desc
from tmlibrary_tpu.benchmarks import synthetic_cell_painting_batch as j_synth
from tmlibrary_tpu.jterator.pipeline import ImageAnalysisPipeline as JPipeline
from tmlibrary_tpu_torch import benchmarks
from tmlibrary_tpu_torch.errors import DeviceError, NotSupportedError, RegistryError
from tmlibrary_tpu_torch.jterator.description import PipelineDescription
from tmlibrary_tpu_torch.jterator.pipeline import (
    ImageAnalysisPipeline,
    from_jax_inputs,
    site_result_to_numpy,
)

GOLDEN = Path(__file__).parent / "golden" / "cell_painting.npz"

# the suite runs several xdist workers on shared cores: one intra-op
# thread per worker keeps the small parity fixtures from oversubscribing
torch.set_num_threads(1)


def _run_port(data, stats=None, max_objects=32, desc=None):
    n = next(iter(data.values())).shape[0]
    raw, st, sh = from_jax_inputs(data, stats or {}, np.zeros((n, 2)), device="cpu")
    pipe = ImageAnalysisPipeline(desc or benchmarks.cell_painting_description(),
                                 max_objects=max_objects, device="cpu")
    return site_result_to_numpy(pipe.build_batch_fn()(raw, st, sh))


def _run_jax(data, stats=None, max_objects=32, desc=None):
    n = next(iter(data.values())).shape[0]
    fn = JPipeline(desc or j_desc(), max_objects=max_objects).build_batch_fn(jit=False)
    stats = {k: tuple(jnp.asarray(a) for a in v) for k, v in (stats or {}).items()}
    return fn({k: jnp.asarray(v) for k, v in data.items()}, stats,
              jnp.zeros((n, 2), jnp.int32))


def assert_feature(name, got, want):
    rtol, atol = feature_tier(name)
    if rtol == atol == 0.0:
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


def _assert_same(port, ref):
    assert sorted(port.objects) == sorted(ref.objects)
    for name in ref.objects:
        np.testing.assert_array_equal(port.objects[name], np.asarray(ref.objects[name]))
        np.testing.assert_array_equal(port.counts[name], np.asarray(ref.counts[name]))
    for obj, feats in ref.measurements.items():
        counts = np.asarray(ref.counts[obj])
        assert sorted(port.measurements[obj]) == sorted(feats)
        for feat, arr in feats.items():
            got, want = port.measurements[obj][feat], np.asarray(arr)
            assert got.shape == want.shape and got.dtype == np.float32
            for s, n in enumerate(counts):
                assert_feature(feat, got[s, :n], want[s, :n])


@pytest.fixture(scope="module")
def batch():
    data = j_synth(4, size=96, n_cells=6)
    ours = benchmarks.synthetic_cell_painting_batch(4, size=96, n_cells=6)
    for k in data:  # the port's generator draws the same pixels
        np.testing.assert_array_equal(ours[k], data[k])
    return data


def test_slice_matches_jax_batch_fn(batch):
    port = _run_port(batch)
    _assert_same(port, _run_jax(batch))
    assert (port.counts["nuclei"] > 0).all()


def test_slice_matches_golden():
    gold = np.load(GOLDEN)
    port = _run_port({"DAPI": gold["dapi"], "Actin": gold["actin"]}, max_objects=32)
    np.testing.assert_array_equal(port.objects["nuclei"], gold["nuclei_labels"])
    np.testing.assert_array_equal(port.objects["cells"], gold["cells_labels"])
    np.testing.assert_array_equal(port.counts["nuclei"], gold["nuclei_counts"])
    np.testing.assert_array_equal(port.counts["cells"], gold["cells_counts"])
    for s, n in enumerate(gold["nuclei_counts"]):
        np.testing.assert_allclose(
            port.measurements["nuclei"]["Intensity_mean_DAPI"][s, :n],
            gold["nuclei_mean_dapi"][s, :n], rtol=1e-6, atol=0)


def test_slice_deterministic(batch):
    a, b = _run_port(batch), _run_port(batch)
    for name in a.objects:
        np.testing.assert_array_equal(a.objects[name], b.objects[name])
        np.testing.assert_array_equal(a.counts[name], b.counts[name])
    for obj, feats in a.measurements.items():
        for feat, arr in feats.items():
            np.testing.assert_array_equal(arr, b.measurements[obj][feat])


def test_slice_with_illumination_correction(batch):
    """corilla's statistics carried across by ``from_jax_inputs``."""
    rng = np.random.default_rng(2)
    stats = {
        ch: ((2.5 + 0.05 * rng.random((96, 96))).astype(np.float32),
             (0.2 + 0.02 * rng.random((96, 96))).astype(np.float32))
        for ch in ("DAPI", "Actin")
    }
    pipe = {**benchmarks.CELL_PAINTING_PIPE, "input": {"channels": [
        {"name": "DAPI", "correct": True}, {"name": "Actin", "correct": True}]}}
    port = _run_port(batch, stats, desc=PipelineDescription.from_dict(pipe))
    from tmlibrary_tpu.jterator.description import PipelineDescription as JDesc

    ref = _run_jax(batch, stats, desc=JDesc.from_dict(pipe))
    for name in ref.objects:
        np.testing.assert_array_equal(port.counts[name], np.asarray(ref.counts[name]))
        np.testing.assert_array_equal(port.objects[name], np.asarray(ref.objects[name]))


@pytest.mark.parametrize("max_objects", [4, 32])
def test_slice_capacity(batch, max_objects):
    """Rows 1..n do not depend on the capacity; ids past it are dropped."""
    port = _run_port(batch, max_objects=max_objects)
    assert port.measurements["nuclei"]["Intensity_sum_DAPI"].shape == (4, max_objects)
    assert (port.counts["nuclei"] <= max_objects).all()
    if max_objects == 4:
        _assert_same(port, _run_jax(batch, max_objects=4))


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        ImageAnalysisPipeline(benchmarks.cell_painting_description())
    with pytest.raises(DeviceError):
        from_jax_inputs({}, {}, np.zeros((1, 2)))


def test_unported_options_raise(batch):
    """Haralick at a distance other than 1 is the option the port still
    refuses (the reference's pairs beyond 1 land short, ROADMAP C); an
    unknown module raises ``RegistryError``."""
    pipe = {**benchmarks.CELL_PAINTING_PIPE}
    pipe["pipeline"] = [dict(item) for item in pipe["pipeline"]]
    smooth = dict(pipe["pipeline"][0]["handles"])
    i = next(i for i, item in enumerate(pipe["pipeline"])
             if item["handles"]["module"] == "measure_intensity")
    texture = dict(pipe["pipeline"][i]["handles"], module="measure_texture")
    texture["input"] = texture["input"] + [{"name": "distance", "type": "Numeric", "value": 2}]
    pipe["pipeline"][i] = {"handles": texture}
    with pytest.raises(NotSupportedError):
        _run_port(batch, desc=PipelineDescription.from_dict(pipe))
    bad = {**benchmarks.CELL_PAINTING_PIPE,
           "pipeline": [{"handles": {**smooth, "module": "no_such_module"}}],
           "output": {}}
    with pytest.raises(RegistryError):
        _run_port(batch, desc=PipelineDescription.from_dict(bad))


def test_port_imports_neither_jax_nor_the_jax_package():
    root = Path(__file__).resolve().parents[1] / "tmlibrary_tpu_torch"
    mods = sorted(
        "tmlibrary_tpu_torch." + ".".join(p.relative_to(root).with_suffix("").parts)
        for p in root.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        # the modules import their ops inside the call: run each module
        # added with the blob path, and smooth's median and bilateral
        "import torch\n"
        "from tmlibrary_tpu_torch.jterator.modules import get_module as g\n"
        "from tmlibrary_tpu_torch.ops.measure import haralick_features\n"
        "img = torch.rand(2, 16, 16) * 1000; lab = (img > 500).to(torch.int32)\n"
        "z = torch.rand(2, 3, 16, 16)\n"
        "for name, kw in [('smooth', dict(intensity_image=img, method='median')),\n"
        "    ('smooth', dict(intensity_image=img, method='bilateral')),\n"
        "    ('filter', dict(label_image=lab, feature='form_factor', lower_threshold=0.1)),\n"
        "    ('register_objects', dict(label_image=lab)), ('invert', dict(image=img)),\n"
        "    ('rescale', dict(intensity_image=img)), ('mask', dict(image=img, mask=lab)),\n"
        "    ('combine_masks', dict(mask_1=lab, mask_2=lab)),\n"
        "    ('measure_point_pattern', dict(objects_image=lab, points_image=lab)),\n"
        "    ('project', dict(zstack=z, method='mean')), ('morphology', dict(mask=lab)),\n"
        "    ('filter_edges', dict(intensity_image=img, method='log')),\n"
        "    ('expand_or_shrink', dict(label_image=lab, n=-1)),\n"
        "    ('clip', dict(intensity_image=img)),\n"
        "    ('combine_channels', dict(image_1=img, image_2=img)),\n"
        "    ('expand', dict(label_image=lab)), ('shrink', dict(label_image=lab)),\n"
        "    ('mip', dict(zstack=z)), ('detect_blobs', dict(intensity_image=img))]:\n"
        "    g(name)(**kw)\n"
        "haralick_features(lab, img, 4, levels=8, quantization='global')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'tmlibrary_tpu' or m.startswith('tmlibrary_tpu.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=root.parent)
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(mods) >= 20
    assert {"tmlibrary_tpu_torch.ops.fused_measure", "tmlibrary_tpu_torch.ops.measure",
            "tmlibrary_tpu_torch.jterator.modules", "tmlibrary_tpu_torch.benchmarks",
            "tmlibrary_tpu_torch.ops.blobs"} <= set(mods)


def test_feature_tiers_cover_names_and_match_chip_smoke():
    """Every feature name has exactly one tier, an unknown name fails, and
    the card-vs-CPU table of chip_smoke.py is the reference table but for
    Zernike, which both sides compute in the same float32 formulation and
    so is held tighter there."""
    assert feature_tier("Intensity_std_DAPI") == (1e-3, 1e-4)
    assert feature_tier("Intensity_median_Actin") == (0.0, 0.0)
    assert feature_tier("Texture_sum_variance_Actin") == FEATURE_TIERS["Texture_*"]
    assert feature_tier("Zernike_6_2") == FEATURE_TIERS["Zernike_*"]
    assert feature_tier("Morphology_orientation") == (1e-5, 1e-6)
    assert {k: v for k, v in CARD_TIERS.items() if k != "Zernike_*"} == {
        k: v for k, v in FEATURE_TIERS.items() if k != "Zernike_*"}
    card, ref = feature_tier("Zernike_6_2", CARD_TIERS), FEATURE_TIERS["Zernike_*"]
    assert card[0] < ref[0] and card[1] < ref[1]
    assert feature_tier("Morphology_solidity") == (0.0, 0.0)  # ported: exact
    for name in ("Intensity_mode_DAPI", "Morphology_convexity", "sum"):
        for tiers in (FEATURE_TIERS, CARD_TIERS):
            with pytest.raises(KeyError):
                feature_tier(name, tiers)


def test_quantile_option_matches_jax(batch):
    """``measure_intensity(quantiles=True)``: p25/median/p75 bit for bit."""
    pipe = {**benchmarks.CELL_PAINTING_PIPE}
    pipe["pipeline"] = [
        {"handles": {**item["handles"], "input": item["handles"]["input"] + [
            {"name": "quantiles", "type": "Boolean", "value": True}]}}
        if item["handles"]["module"] == "measure_intensity" else item
        for item in pipe["pipeline"]
    ]
    from tmlibrary_tpu.jterator.description import PipelineDescription as JDesc

    port = _run_port(batch, desc=PipelineDescription.from_dict(pipe))
    _assert_same(port, _run_jax(batch, desc=JDesc.from_dict(pipe)))
    for obj, ch in (("nuclei", "DAPI"), ("cells", "Actin")):
        assert {f"Intensity_{q}_{ch}" for q in ("p25", "median", "p75")} <= set(
            port.measurements[obj])
