"""The port's jterator project (``tmlibrary_tpu_torch/jterator/project.py``)
and the ``project`` verbs, against the JAX package's.

Handle templates of all 36 modules equal the reference's; a project
written by either package (its ``.pipe.yaml`` and ``handles/`` files, the
same bytes) loads in the other to equal descriptions; the verbs and
``project check`` print what the reference prints; config 3 built as a
project runs through the port's pipeline on the CPU to the reference's
labels (bit for bit) and features (``FEATURE_TIERS``).
"""

from __future__ import annotations

import ast
import contextlib
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from chip_smoke import PROJECT_MODULES, build_project, feature_tier
from tmlibrary_tpu import cli as jcli
from tmlibrary_tpu.benchmarks import CELL_PAINTING_PIPE as J_PIPE
from tmlibrary_tpu.benchmarks import synthetic_cell_painting_batch as j_synth
from tmlibrary_tpu.jterator.description import PipelineDescription as JDescription
from tmlibrary_tpu.jterator.handles import HandleCollection as JHandles
from tmlibrary_tpu.jterator.modules import list_modules as j_list_modules
from tmlibrary_tpu.jterator.pipeline import ImageAnalysisPipeline as JPipeline
from tmlibrary_tpu.jterator.project import Project as JProject
from tmlibrary_tpu.jterator.project import _OUTPUT_SPECS as J_OUTPUT_SPECS
from tmlibrary_tpu.jterator.project import handles_template as j_template
from tmlibrary_tpu_torch import benchmarks, cli
from tmlibrary_tpu_torch.errors import PipelineDescriptionError
from tmlibrary_tpu_torch.jterator.description import PipelineDescription
from tmlibrary_tpu_torch.jterator.handles import HandleCollection
from tmlibrary_tpu_torch.jterator.modules import list_modules
from tmlibrary_tpu_torch.jterator.pipeline import (
    ImageAnalysisPipeline,
    from_jax_inputs,
    site_result_to_numpy,
)
from tmlibrary_tpu_torch.jterator.project import (
    _OUTPUT_SPECS,
    HANDLES_DIR,
    HANDLES_SUFFIX,
    PIPE_FILENAME,
    Project,
    handles_template,
)

torch.set_num_threads(1)


def run(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def describe(desc, versions: bool = True) -> dict:
    """A description of either package as plain data."""
    return {"description": desc.description,
            "channels": [(c.name, c.correct, c.align, c.zstack) for c in desc.channels],
            "objects_in": [o.name for o in desc.objects_in],
            "modules": [{k: v for k, v in m.to_dict().items() if versions or k != "version"}
                        for m in desc.modules],
            "objects_out": [(o.name, o.as_polygons) for o in desc.objects_out]}


def test_constants_equal_the_reference():
    from tmlibrary_tpu.jterator import project as jproject

    assert (PIPE_FILENAME, HANDLES_DIR, HANDLES_SUFFIX) == (
        jproject.PIPE_FILENAME, jproject.HANDLES_DIR, jproject.HANDLES_SUFFIX)
    assert _OUTPUT_SPECS == J_OUTPUT_SPECS
    assert list_modules() == j_list_modules()


@pytest.mark.parametrize("module", list_modules())
def test_handles_template_equals_the_reference(module):
    assert handles_template(module).to_dict() == j_template(module).to_dict()


def _build(project_cls, directory):
    proj = project_cls.create(directory, description="segment + measure")
    proj.add_channel("DAPI", correct=False)
    proj.add_channel("Actin", align=True, zstack=False)
    proj.add_module("smooth", sigma=1.5)
    proj.add_module("segment_primary", instance="nuclei_seg", min_area=20,
                    intensity_image="smoothed_image")
    proj.add_module("measure_intensity", instance="m", position=1)
    proj.add_output_objects("nuclei", as_polygons=False)
    proj.set_active("m", False)
    return proj


def test_projects_are_byte_identical_and_load_in_either_package(tmp_path):
    port = _build(Project, tmp_path / "port")
    ref = _build(JProject, tmp_path / "ref")
    files = sorted(p.relative_to(port.directory) for p in port.directory.rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(ref.directory) for p in ref.directory.rglob("*")
                           if p.is_file())
    for f in files:
        assert (port.directory / f).read_bytes() == (ref.directory / f).read_bytes(), f
    assert port.module_names() == ref.module_names() == ["smooth", "m", "nuclei_seg"]
    # each package reads the other's project
    for a, b in ((port, ref), (ref, port)):
        assert describe(PipelineDescription.load(a.pipe_path)) == \
            describe(JDescription.load(b.pipe_path))
        assert Project(b.directory).get_handles("nuclei_seg").to_dict() == \
            JProject(a.directory).get_handles("nuclei_seg").to_dict()


def test_project_edits_follow_the_reference(tmp_path):
    for cls, name in ((Project, "port"), (JProject, "ref")):
        proj = _build(cls, tmp_path / name)
        proj.remove_module("smooth")
        hc = proj.get_handles("nuclei_seg")
        proj.update_handles("nuclei_seg", hc)
    port, ref = tmp_path / "port", tmp_path / "ref"
    for f in (PIPE_FILENAME, f"{HANDLES_DIR}/nuclei_seg{HANDLES_SUFFIX}"):
        assert (port / f).read_bytes() == (ref / f).read_bytes()
    assert not (port / HANDLES_DIR / f"smooth{HANDLES_SUFFIX}").exists()
    proj = Project(port)
    for call, match in ((lambda: Project.create(port), "already exists"),
                        (lambda: proj.add_channel("DAPI"), "already declared"),
                        (lambda: proj.add_module("smooth", instance="m"), "already in project"),
                        (lambda: proj.add_module("smooth", nope=1), "unknown constants"),
                        (lambda: proj.remove_module("gone"), "not in pipeline"),
                        (lambda: proj.set_active("gone", True), "not in pipeline"),
                        (lambda: proj.update_handles("gone", proj.get_handles("m")),
                         "not in project"),
                        (lambda: Project(tmp_path / "none").module_names(), "no project")):
        with pytest.raises(PipelineDescriptionError, match=match):
            call()
    proj.remove()
    assert not port.exists()


VERBS = [
    ["project", "create", "--dir", "{d}", "--description", "demo"],
    ["project", "add-channel", "--dir", "{d}", "--name", "DAPI", "--no-correct"],
    ["project", "add-channel", "--dir", "{d}", "--name", "Actin", "--align"],
    ["project", "add-module", "--dir", "{d}", "--module", "smooth"],
    ["project", "add-module", "--dir", "{d}", "--module", "segment_primary",
     "--instance", "seg"],
    ["project", "show", "--dir", "{d}"],
    ["project", "modules"],
    ["project", "check", "--pipe", "{d}/pipeline.pipe.yaml"],
    ["project", "remove-module", "--dir", "{d}", "--instance", "smooth"],
    ["project", "check", "--pipe", "{d}/pipeline.pipe.yaml"],
    ["project", "show", "--dir", "{d}"],
]


def test_the_verbs_print_what_the_reference_prints(tmp_path):
    for i, argv in enumerate(VERBS):
        outs = []
        for main, name in ((cli.main, "port"), (jcli.main, "ref")):
            d = str(tmp_path / name)
            rc, out = run(main, [a.format(d=d) for a in argv])
            outs.append((rc, out.replace(d, "<dir>")))
        assert outs[0] == outs[1], (argv, outs)
    port, ref = tmp_path / "port", tmp_path / "ref"
    for f in sorted(p.relative_to(port) for p in port.rglob("*") if p.is_file()):
        assert (port / f).read_bytes() == (ref / f).read_bytes()


@pytest.mark.parametrize("case", ["dataflow", "parameter", "module", "handle", "yaml"])
def test_check_fails_as_the_reference_fails(case, tmp_path):
    for main, name in ((cli.main, "port"), (jcli.main, "ref")):
        d = tmp_path / name
        assert run(main, ["project", "create", "--dir", str(d)])[0] == 0
        run(main, ["project", "add-channel", "--dir", str(d), "--name", "DAPI"])
        run(main, ["project", "add-module", "--dir", str(d), "--module", "smooth"])
        handles = d / "handles" / "smooth.handles.yaml"
        doc = yaml.safe_load(handles.read_text())
        if case == "dataflow":
            doc["input"][0]["key"] = "nowhere"
        elif case == "parameter":
            doc["input"].append({"name": "bogus", "type": "Numeric", "value": 1})
        elif case == "module":
            doc["module"] = "no_such_module"
        elif case == "handle":
            doc["input"][0]["type"] = "NoSuchType"
        handles.write_text(yaml.safe_dump(doc, sort_keys=False) if case != "yaml"
                           else "module: smooth\ninput: &a []\noutput: *a\n")
    outs = [run(main, ["project", "check", "--pipe", str(tmp_path / n / PIPE_FILENAME)])
            for main, n in ((cli.main, "port"), (jcli.main, "ref"))]
    if case == "yaml":  # the port refuses the anchor by name; PyYAML reads it
        assert outs[0][0] == 1 and outs[1][0] == 0
        assert outs[0][1].startswith("FAIL: cannot load pipeline: ")
        assert "anchors ('&') are outside the subset" in outs[0][1]
        return
    assert outs[0][0] == outs[1][0] == 1
    assert outs[0][1].startswith("FAIL: ")
    # the registry's listing is a dict in registration order, which differs
    got, want = (re.sub(r"\(registered: (\{.*\})\)",
                        lambda m: repr(sorted(ast.literal_eval(m.group(1)).items())),
                        out.replace(str(tmp_path / name), "<dir>"))
                 for (_, out), name in zip(outs, ("port", "ref")))
    assert got == want


def test_upstream_style_pipe_loads_as_in_the_reference(tmp_path):
    """``source: python/jtmodules/<name>.py`` items beside handles files
    that carry no module name (the reference's ``test_project.py:195``)."""
    (tmp_path / "handles").mkdir()
    (tmp_path / "handles" / "smooth.handles.yaml").write_text(yaml.safe_dump({
        "version": "0.0.1",
        "input": [{"name": "intensity_image", "type": "IntensityImage", "key": "DAPI"},
                  {"name": "sigma", "type": "Numeric", "value": 1.5}],
        "output": [{"name": "smoothed_image", "type": "IntensityImage", "key": "sm"}]}))
    (tmp_path / "handles" / "threshold_otsu.handles.yaml").write_text(yaml.safe_dump({
        "version": "0.0.1",
        "input": [{"name": "intensity_image", "type": "IntensityImage", "key": "sm"}],
        "output": [{"name": "mask", "type": "BinaryImage", "key": "mask"}]}))
    (tmp_path / "demo.pipe.yaml").write_text(yaml.safe_dump({
        "description": "upstream-format pipe",
        "input": {"channels": [{"name": "DAPI", "correct": False}]},
        "pipeline": [
            {"source": "python/jtmodules/smooth.py", "handles": "handles/smooth.handles.yaml",
             "active": True},
            {"source": "python/jtmodules/threshold_otsu.py",
             "handles": "handles/threshold_otsu.handles.yaml", "active": True}],
        "output": {"objects": []}}))
    desc = PipelineDescription.load(tmp_path / "demo.pipe.yaml")
    assert describe(desc) == describe(JDescription.load(tmp_path / "demo.pipe.yaml"))
    desc.validate()
    out = ImageAnalysisPipeline(desc, max_objects=8, device="cpu").build_batch_fn()(
        {"DAPI": torch.zeros((1, 32, 32))}, {}, torch.zeros((1, 2), dtype=torch.int32))
    assert site_result_to_numpy(out).objects == {}


def test_handle_collections_load_in_either_package(tmp_path):
    hc = handles_template("segment_secondary")
    hc.save(tmp_path / "port.handles.yaml")
    j_template("segment_secondary").save(tmp_path / "ref.handles.yaml")
    assert (tmp_path / "port.handles.yaml").read_bytes() == \
        (tmp_path / "ref.handles.yaml").read_bytes()
    assert HandleCollection.load(tmp_path / "ref.handles.yaml") == hc
    assert JHandles.load(tmp_path / "port.handles.yaml").to_dict() == hc.to_dict()


# ------------------------------------------------- config 3 as a project
def test_config3_as_a_project_runs_to_the_reference(tmp_path):
    pipe_path = build_project(cli, tmp_path / "cp")
    desc = PipelineDescription.load(pipe_path)
    assert describe(desc, False) == describe(benchmarks.cell_painting_description(), False)
    assert describe(JDescription.load(pipe_path), False) == \
        describe(JDescription.from_dict(J_PIPE), False)
    assert [m for m, _ in PROJECT_MODULES] == [m.module for m in desc.modules]
    data = j_synth(3, size=96, seed=5)
    raw, st, sh = from_jax_inputs(data, {}, np.zeros((3, 2)), device="cpu")
    port = site_result_to_numpy(ImageAnalysisPipeline(desc, max_objects=32, device="cpu")
                                .build_batch_fn()(raw, st, sh))
    ref = JPipeline(JDescription.load(pipe_path), max_objects=32).build_batch_fn(jit=False)(
        {k: jnp.asarray(v) for k, v in data.items()}, {}, jnp.zeros((3, 2), jnp.int32))
    assert sorted(port.objects) == sorted(ref.objects) == ["cells", "nuclei"]
    for name in ref.objects:
        np.testing.assert_array_equal(port.objects[name], np.asarray(ref.objects[name]))
        np.testing.assert_array_equal(port.counts[name], np.asarray(ref.counts[name]))
    assert int(np.asarray(ref.counts["nuclei"]).sum()) > 0
    for obj, feats in ref.measurements.items():
        counts = np.asarray(ref.counts[obj])
        assert sorted(port.measurements[obj]) == sorted(feats)
        for feat, arr in feats.items():
            rtol, atol = feature_tier(feat)
            for s, n in enumerate(counts):
                np.testing.assert_allclose(port.measurements[obj][feat][s, :n],
                                           np.asarray(arr)[s, :n], rtol=rtol, atol=atol,
                                           err_msg=feat)
