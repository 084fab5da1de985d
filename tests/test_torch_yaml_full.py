"""The whole YAML language through the port's ``yamlio`` against PyYAML 6
(``yaml.safe_load``, ``yaml.safe_dump(doc, sort_keys=False)``), which
only this test process imports.

Reading: hypothesis draws documents with ``%YAML``/``%TAG`` directives,
anchors and aliases (recursive ones too), ``<<`` merges of mappings,
aliases and sequences of them, every safe tag and some unsafe or local
ones, literal and folded block scalars (each chomping indicator x
indentation indicator x trailing blank lines), flow collections with
single-pair mappings, explicit ``?`` keys, CRLF/NEL/LS/PS line breaks,
and single-character mutations of all of these.  The port reads each to
what PyYAML reads -- values, types and the alias graph -- or raises
:class:`YAMLSubsetError` (naming the line) exactly where PyYAML raises.

Writing: hypothesis documents with shared and recursive lists, dicts and
tuples, sets, bytes, dates and datetimes (with time zones) are written to
PyYAML's text, and read back as PyYAML reads them.

End to end: config 3 as a project whose files are rewritten in full YAML
(``chip_smoke.hand_yaml``: directives, merges, block scalars, tags, an
explicit key, aliases) loads to equal descriptions through both
packages' ``PipelineDescription.load``, passes both CLIs' ``project
check`` in process, and runs through both packages' jterator pipeline
at 64x64 on the CPU to exact labels and counts and features within
``FEATURE_TIERS``.
"""

from __future__ import annotations

import datetime
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from test_torch_project import describe, run
from test_torch_yaml import assert_reads_as_pyyaml, same

import chip_smoke
from tmlibrary_tpu import cli as jcli
from tmlibrary_tpu.benchmarks import synthetic_cell_painting_batch as j_synth
from tmlibrary_tpu.jterator.description import PipelineDescription as JDescription
from tmlibrary_tpu.jterator.pipeline import ImageAnalysisPipeline as JPipeline
from tmlibrary_tpu_torch import benchmarks, cli, yamlio
from tmlibrary_tpu_torch.jterator.description import PipelineDescription
from tmlibrary_tpu_torch.jterator.pipeline import (
    ImageAnalysisPipeline,
    from_jax_inputs,
    site_result_to_numpy,
)

torch.set_num_threads(1)

SETTINGS = settings(max_examples=400, deadline=None, derandomize=True,
                    suppress_health_check=[HealthCheck.too_slow,
                                           HealthCheck.filter_too_much])


# ------------------------------------------------------------- documents
_WORDS = ["a", "b c", "yes", "No", "~", "null", "1", "-7", "0x1F", "0o7", "017", "1_000",
          "1:30", "1.5", "1e3", "1.0e+3", ".inf", "-.Inf", ".NaN", "2001-12-14",
          "2001-12-14 21:59:43.10 -5", "2001-12-14t21:59:43Z", "x#y", "a:b", "=", "<<",
          "on", "-", "é", "word with  spaces"]
_QUOTED = ["'it''s'", '"tab\\there"', '"\\x41\\u00e9"', "''", '""', "'multi\n  line'",
           '"esc\\\n  aped"', "' lead'", '"\\N\\_\\L\\P"']
_TAGS = ["!!str", "!!int", "!!float", "!!bool", "!!null", "!!timestamp", "!!binary", "!!seq",
         "!!map", "!!set", "!!omap", "!!pairs", "!", "!local", "!e!str", "!e!int",
         "!<tag:yaml.org,2002:str>", "!!python/tuple", "!!merge", "!!value"]
_TAGGED = {"!!int": ["3", "-0b101", "1:20", "abc", "0x_1"], "!!float": ["1", "1:30.5", ".5", "x"],
           "!!bool": ["yes", "OFF", "maybe"], "!!null": ["", "anything"],
           "!!binary": ["aGVsbG8=", "aGVs\n  bG8=", "!!!"],
           "!!timestamp": ["2001-12-14", "2001-12-14 1:02:03.5+01:30", "nope"],
           "!!str": ["12", "yes", ""], "!e!str": ["12"], "!e!int": ["12"]}
_BREAK_STYLES = ["\n", "\n", "\n", "\r\n", "\r", "\x85", "\u2028", "\u2029"]
_MUTATIONS = " \t\n:-?#&*!|>[]{},'\"%@`\x85\u2028"
_NAMES = itertools.count()  # anchor names, unique across a run


@st.composite
def block_scalar(draw, indent: int) -> str:
    """A ``|`` or ``>`` scalar after a key at column ``indent``: every
    chomping x indentation indicator order, more-indented and blank
    lines, trailing blank lines."""
    style = draw(st.sampled_from("|>"))
    chomp = draw(st.sampled_from(["", "-", "+"]))
    step = draw(st.sampled_from(["", "1", "2", "3", "4"]))
    header = style + (chomp + step if draw(st.booleans()) else step + chomp)
    if draw(st.booleans()):
        header += " # comment"
    base = indent + (int(step) if step else draw(st.integers(1, 3)))
    lines = []
    for _ in range(draw(st.integers(0, 5))):
        kind = draw(st.sampled_from(["text", "text", "text", "more", "blank", "spaces",
                                     "less"]))
        word = draw(st.sampled_from(["one two", "x", "a: b", "- item", "# not a comment",
                                     "tab\there"]))
        lines.append({"text": " " * base + word, "more": " " * (base + 2) + word,
                      "blank": "", "spaces": " " * draw(st.integers(1, base + 3)),
                      "less": " " * max(base - 1, 0) + word}[kind])
    lines += [""] * draw(st.integers(0, 3))
    return header + "\n" + "".join(line + "\n" for line in lines)


@st.composite
def flow_node(draw, anchors: list, depth: int) -> str:
    choice = draw(st.integers(0, 9 if depth < 2 else 4))
    if choice <= 1:
        return draw(st.sampled_from(_WORDS[:22] + _QUOTED[:5]))
    if choice == 2 and anchors:
        return "*" + draw(st.sampled_from(anchors))
    if choice == 3:
        tag = draw(st.sampled_from(sorted(_TAGGED)))
        value = draw(st.sampled_from(_TAGGED[tag])).split("\n")[0]
        return f"{tag} {value or repr('')}"
    if choice == 4:
        return "[]" if draw(st.booleans()) else "{}"
    props = ""
    if draw(st.booleans()):
        name = f"f{next(_NAMES)}"
        anchors.append(name)
        props = f"&{name} "
    items = [draw(flow_node(anchors, depth + 1)) for _ in range(draw(st.integers(1, 3)))]
    if choice <= 6:  # a flow sequence, some entries single-pair mappings
        out = [f"{item}: {draw(flow_node(anchors, depth + 1))}" if draw(st.booleans())
               and not item.startswith(("[", "{", "!", "'", '"')) else item for item in items]
        return props + "[" + ", ".join(out) + ("," if draw(st.booleans()) else "") + "]"
    pairs = []
    for item in items:
        if draw(st.integers(0, 3)):  # mostly scalar keys: a collection key is unhashable
            item = draw(st.sampled_from(_WORDS[:22] + _QUOTED[:5]))
        if draw(st.booleans()):
            pairs.append(item)  # a key with no value
        elif draw(st.booleans()):
            pairs.append(f"? {item} : {draw(flow_node(anchors, depth + 1))}")
        else:
            pairs.append(f"{item}: {draw(flow_node(anchors, depth + 1))}")
    return props + "{" + ", ".join(pairs) + "}"


@st.composite
def block_value(draw, indent: int, anchors: list, depth: int, in_mapping: bool) -> str:
    """The text after a ``key:`` or ``- `` at column ``indent``: from the
    space after the indicator to the end of its last line."""
    choice = draw(st.integers(0, 11 if depth < 3 else 5))
    if choice == 3 and anchors:
        return " *" + draw(st.sampled_from(anchors)) + "\n"
    props = ""
    if draw(st.integers(0, 3)) == 0:
        # a fresh name, now and then one already taken (PyYAML refuses it)
        name = draw(st.sampled_from(anchors)) if anchors and draw(st.integers(0, 39)) == 0 \
            else f"x{next(_NAMES)}"
        anchors.append(name)
        props += f" &{name}"
    if draw(st.integers(0, 5)) == 0:
        fitting = (["!!str", "!"] if choice <= 5 else ["!!seq", "!!omap", "!!pairs"]
                   if choice <= 7 else ["!!map", "!!set"])
        props += " " + draw(st.sampled_from(fitting * 3 + _TAGS))
    if choice <= 2:
        node = draw(flow_node(anchors, depth))
        if node.startswith(("&", "*", "!")):
            if "&" in props:
                anchors.remove(props.split("&")[1].split()[0])
            props = ""  # one anchor and one tag a node, none on an alias
        return props + " " + node + "\n"
    if choice == 4:
        return props + " " + draw(block_scalar(indent))
    if choice == 5:
        return props + "\n"  # an empty value
    inner = indent + draw(st.sampled_from([2, 2, 2, 1, 3, 4]))
    if choice <= 7:
        if in_mapping and draw(st.booleans()):
            inner = indent  # a sequence flush under its key
        return props + "\n" + draw(block_sequence(inner, anchors, depth + 1))
    return props + "\n" + draw(block_mapping(inner, anchors, depth + 1))


@st.composite
def block_sequence(draw, indent: int, anchors: list, depth: int) -> str:
    pad = " " * indent
    return "".join(pad + "-" + draw(block_value(indent, anchors, depth, False))
                   for _ in range(draw(st.integers(1, 3))))


@st.composite
def block_mapping(draw, indent: int, anchors: list, depth: int) -> str:
    pad = " " * indent
    out = []
    for i in range(draw(st.integers(1, 4))):
        kind = draw(st.integers(0, 9))
        if kind == 0 and anchors:  # a merge of an alias, a mapping or a list of them
            alias = f"*{draw(st.sampled_from(anchors))}"
            merged = draw(st.sampled_from(
                [alias, alias, "{m: 1, k0: merged}", f"[{alias}, {{n: 2}}]",
                 f"[{{n: 2}}, {alias}]", "1", "[1]"]))
            key = draw(st.sampled_from(["<<", "!!merge <<", "!!merge m"]))
            out.append(f"{pad}{key}: {merged}\n")
            continue
        if kind == 1:  # an explicit key, maybe a collection
            key = draw(st.sampled_from(["k", "long key", "!!str 3", "'q'", "[a, b]"]
                                       + [f"*{a}" for a in anchors[:2]]))
            out.append(f"{pad}? {key}\n")
            if draw(st.integers(0, 4)):
                out.append(f"{pad}:" + draw(block_value(indent, anchors, depth, True)))
            continue
        key = draw(st.sampled_from([f"k{i}", f"k{i}", "'q k'", '"d\\tk"', "=", "1", "~",
                                    "2001-12-14", f"k{i}"]))
        out.append(f"{pad}{key}:" + draw(block_value(indent, anchors, depth, True)))
    return "".join(out)


@st.composite
def documents(draw) -> str:
    anchors: list[str] = []
    head = ""
    directives = draw(st.sampled_from(
        ["", "%YAML 1.1\n", "%TAG !e! tag:yaml.org,2002:\n",
         "%YAML 1.1\n%TAG !e! tag:yaml.org,2002:\n", "%YAML 1.2\n", "%FOO bar baz\n"] * 4
        + ["%YAML 2.0\n", "%YAML 1.1\n%YAML 1.1\n", "%TAG !e! a\n%TAG !e! b\n"]))
    body = draw(st.sampled_from(["map", "map", "seq", "flow", "scalar"]))
    if directives or draw(st.booleans()):
        # a block collection may not start on the '---' line
        head = directives + "---" + draw(st.sampled_from(
            ["\n", " # start\n"] + ([" "] if body in ("flow", "scalar") else [])))
    if body == "map":
        text = draw(block_mapping(0, anchors, 0))
    elif body == "seq":
        text = draw(block_sequence(0, anchors, 0))
    elif body == "flow":
        text = draw(flow_node(anchors, 0)) + "\n"
    else:
        text = draw(block_value(0, anchors, 0, False)).lstrip(" ")
    if "%TAG" not in directives and draw(st.integers(0, 4)):
        text = text.replace("!e!", "!!")  # mostly no undeclared handle
    tail = draw(st.sampled_from(["", "...\n", "...\n...\n", "# end\n"] * 4
                                + ["---\nsecond\n"]))
    doc = head + text + tail
    if draw(st.integers(0, 3)) == 0:
        doc = doc.replace("\n", draw(st.sampled_from(_BREAK_STYLES)))
    for _ in range(draw(st.integers(1, 2)) if draw(st.integers(0, 4)) == 0 else 0):
        at = draw(st.integers(0, len(doc)))
        if draw(st.booleans()) and at < len(doc):
            doc = doc[:at] + doc[at + 1:]
        else:
            doc = doc[:at] + draw(st.sampled_from(_MUTATIONS)) + doc[at:]
    return doc


@SETTINGS
@given(documents())
def test_documents_read_as_pyyaml(text):
    assert_reads_as_pyyaml(text)


@pytest.mark.parametrize("text", [
    "a: &x [1]\nb: *x\n", "&a [*a]\n", "&a {self: *a}\n", "- &a [*a, *a]\n- *a\n",
    "base: &b {x: 1, y: 2}\nd:\n  <<: *b\n  y: 3\n",
    "a: &a {x: 1}\nb: &b {x: 2, z: 3}\nc:\n  <<: [*a, *b]\n  w: 0\n",
    "a: &a {x: 1, <<: {y: 2}}\nb: {<<: *a}\n", "? [a, b]\n", "? a\n? b\n: c\n",
    "%TAG !e! tag:yaml.org,2002:\n--- !e!int 12\n", "!!set {a, b, ? c}\n",
    "!!omap [a: 1, b: 2]\n", "!!pairs\n- a: 1\n- a: 2\n", "!!binary |\n  aGVsbG8=\n",
    "a: |+\n  x\n\n\nb: 1\n", "a: >\n  x\n  y\n\n  z\n   more\n  w\n\n\n",
    "- >-\n  folded\n  lines\n- |\n  literal\n  lines\n", "a: >2-\n   more\n  text\n\n", "a: |1\n  lead\n",
    "[a: 1, b, : c, d:]\n", "{a, ? b, c: }\n", "a:\x85  b\u2028c: d\u2029", "a: 1\r\nb: 2\r",
    "--- |\n  root\n...\n", "!!str\n", "&a\n", "a: !!null x\n", "!!str {=: x}\n",
    "!<tag:yaml.org,2002:int> 7\n", "\ufeffa: 1\n", "- !!float 1:30.5\n- !!int 0b1_0\n",
], ids=lambda t: repr(t)[:40])
def test_listed_documents_read_as_pyyaml(text):
    assert_reads_as_pyyaml(text)


def test_an_alias_is_its_anchors_object():
    doc = yamlio.safe_load("a: &x [1]\nb: *x\nc: &r [*r]\nd: &m {self: *m}\n")
    assert doc["a"] is doc["b"] and doc["c"][0] is doc["c"] and doc["d"]["self"] is doc["d"]
    merged = yamlio.safe_load("a: &a {x: 1, y: 2}\nb:\n  <<: *a\n  y: 3\n")
    assert merged["b"] == {"x": 1, "y": 3} and list(merged["b"]) == ["x", "y"]


# ----------------------------------------------------------------- writing
_DUMP_SCALARS = (st.none() | st.booleans() | st.integers(-2**70, 2**70) | st.floats()
                 | st.text(max_size=12) | st.sampled_from(["yes", "1:30", "~", "", "a\nb",
                                                           "k" * 130, "- x", "#",
                                                           " ".join(["word"] * 30),
                                                           "line one\nline two\n"])
                 | st.binary(max_size=120) | st.dates()
                 | st.datetimes(timezones=st.none() | st.timezones()))
_KEY_SCALARS = (st.none() | st.booleans() | st.integers(-100, 100) | st.text(max_size=12)
                | st.sampled_from(["k" * 127, "k" * 130, "", "a\nb", "? x"]) | st.binary(max_size=8)
                | st.dates())


@st.composite
def shared_documents(draw):
    """Documents whose lists, dicts, tuples and dates may occur more than
    once or hold themselves."""
    pool: list = []

    def build(depth: int):
        if pool and draw(st.integers(0, 4)) == 0:
            return draw(st.sampled_from(pool))
        kind = draw(st.sampled_from(["scalar", "scalar", "list", "dict", "tuple", "set"]
                                    if depth < 3 else ["scalar"]))
        if kind == "scalar":
            value = draw(_DUMP_SCALARS)
            if isinstance(value, datetime.date):
                pool.append(value)
            return value
        if kind == "set":
            return set(draw(st.lists(_KEY_SCALARS | st.tuples(_KEY_SCALARS), max_size=3)))
        if kind == "tuple":
            value = tuple(build(depth + 1) for _ in range(draw(st.integers(0, 3))))
            pool.append(value)
            return value
        if kind == "list":
            value: list = []
            pool.append(value)
            value.extend(build(depth + 1) for _ in range(draw(st.integers(0, 3))))
            if draw(st.integers(0, 5)) == 0:
                value.append(value)
            return value
        mapping: dict = {}
        pool.append(mapping)
        for _ in range(draw(st.integers(0, 3))):
            key = draw(_KEY_SCALARS | st.tuples(_KEY_SCALARS, _KEY_SCALARS))
            mapping[key] = build(depth + 1)
        if draw(st.integers(0, 5)) == 0:
            mapping["self"] = mapping
        return mapping

    return build(0)


@SETTINGS
@given(shared_documents())
def test_shared_documents_write_as_pyyaml(doc):
    text = yamlio.safe_dump(doc)
    assert text == yaml.safe_dump(doc, sort_keys=False)
    assert_reads_as_pyyaml(text)


#: PyYAML's own writer styles: canonical YAML (directives, explicit tags
#: and ``? `` keys everywhere), literal, folded and quoted scalars, flow
#: collections, CRLF, wide indents, explicit document markers
DUMP_STYLES = [{"canonical": True}, {"default_style": "|"}, {"default_style": ">"},
               {"default_style": ">", "width": 24},
               {"default_style": "'"}, {"default_style": '"'}, {"default_flow_style": True},
               {"default_flow_style": None, "width": 20}, {"indent": 5, "line_break": "\r\n"},
               {"explicit_start": True, "explicit_end": True, "version": (1, 1),
                "tags": {"!e!": "tag:yaml.org,2002:"}}, {"allow_unicode": True}]


@SETTINGS
@given(shared_documents(), st.sampled_from(DUMP_STYLES))
def test_pyyaml_styles_read_as_pyyaml(doc, style):
    text = yaml.safe_dump(doc, sort_keys=False, **style)
    assert_reads_as_pyyaml(text)


def test_shared_and_recursive_containers_write_once():
    shared, day = [1, 2], datetime.date(2001, 12, 14)
    loop: dict = {"name": "loop"}
    loop["self"] = loop
    doc = {"a": shared, "b": (shared, shared), "c": {day: day}, "d": loop, "e": {1, 2},
           "f": b"\x00\xff" * 40, (1, 2): "tuple key", "": "empty", "k" * 130: "long"}
    text = yamlio.safe_dump(doc)
    assert text == yaml.safe_dump(doc, sort_keys=False)
    assert "!!binary |" in text and "!!set" in text and "? " in text and "&id001" in text
    with pytest.raises(yamlio.YAMLSubsetError, match="cannot represent"):
        yamlio.safe_dump({"z": 1j})


# ------------------------------------------------------------ config 3
def test_config3_in_full_yaml_runs_in_both_packages(tmp_path):
    pipe_path = chip_smoke.build_project(cli, tmp_path / "cp")
    files = [pipe_path] + sorted((pipe_path.parent / "handles").glob("*.yaml"))
    before = {p: yaml.safe_load(p.read_text()) for p in files}
    texts = chip_smoke.rewrite_full_yaml(files)
    for path, text in texts.items():
        assert text.startswith("%YAML 1.1\n---\n") and "\n? " in text
        assert same(yaml.safe_load(text), before[path]) and same(yamlio.load(path),
                                                                 before[path])
    joined = "".join(texts.values())
    for feature in ("<<: *defaults", ">-", "|-", "!!int", "!!float", "&defaults"):
        assert feature in joined, feature
    desc, jdesc = PipelineDescription.load(pipe_path), JDescription.load(pipe_path)
    assert describe(desc, False) == describe(jdesc, False) == \
        describe(benchmarks.cell_painting_description(), False)
    outs = [run(main, ["project", "check", "--pipe", str(pipe_path)])
            for main in (cli.main, jcli.main)]
    assert outs[0][0] == outs[1][0] == 0 and outs[0][1] == outs[1][1]
    assert outs[0][1].startswith("OK")
    data = j_synth(3, size=64, seed=5)
    raw, st_, sh = from_jax_inputs(data, {}, np.zeros((3, 2)), device="cpu")
    port = site_result_to_numpy(ImageAnalysisPipeline(desc, max_objects=32, device="cpu")
                                .build_batch_fn()(raw, st_, sh))
    ref = JPipeline(jdesc, max_objects=32).build_batch_fn(jit=False)(
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
            rtol, atol = chip_smoke.feature_tier(feat)
            for s, n in enumerate(counts):
                np.testing.assert_allclose(port.measurements[obj][feat][s, :n],
                                           np.asarray(arr)[s, :n], rtol=rtol, atol=atol,
                                           err_msg=feat)


def test_a_full_yaml_workflow_description_reads_as_written(tmp_path):
    from tmlibrary_tpu.workflow.engine import WorkflowDescription as JWorkflow
    from tmlibrary_tpu_torch.workflow.engine import WorkflowDescription

    desc = WorkflowDescription.for_type("canonical")
    for stage in desc.stages:
        for step in stage.steps:
            if step.name == "jterator":
                step.args = {"pipe": "p.pipe.yaml", "batch_size": 8, "max_objects": 64}
    path = tmp_path / "workflow.yaml"
    desc.save(path)
    text = chip_smoke.rewrite_full_yaml([path])[path]
    assert "&no_args {}" in text and "*no_args" in text
    assert "args: &args\n" in text and "<<: *args\n" in text and "max_objects: ~\n" in text
    assert WorkflowDescription.load(path).to_dict() == desc.to_dict() == \
        JWorkflow.load(path).to_dict()
