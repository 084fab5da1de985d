"""The port's stdlib YAML reader and writer (``tmlibrary_tpu_torch/yamlio.py``)
held against PyYAML 6 (``yaml.safe_load``, ``yaml.safe_dump(...,
sort_keys=False)``), which only this test process imports.

The documents: every literal YAML document the JAX package's tests and
scripts write or read (harvested from their source), the JSON documents
the port writes (pipelines and workflow descriptions), the handles templates of all 36
modules, the workflow templates, hypothesis documents of plain block
YAML, the YAML 1.1 resolver's traps, constructs outside plain block
YAML (anchors, aliases, tags, block scalars, merges, explicit keys,
flow pairs, directives; shared containers, tuples, long, empty and
multi-line keys on the writer side), which read and write as PyYAML
does, and malformed input, which raises :class:`YAMLSubsetError` where
PyYAML raises.  ``tests/test_torch_yaml_full.py`` draws documents of the
whole language.
"""

from __future__ import annotations

import ast
import datetime
import json
import math
from pathlib import Path

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tmlibrary_tpu.jterator.project import handles_template as j_handles_template
from tmlibrary_tpu.workflow.engine import WorkflowDescription as JDescription
from tmlibrary_tpu_torch import benchmarks, yamlio
from tmlibrary_tpu_torch.errors import PipelineDescriptionError
from tmlibrary_tpu_torch.jterator.handles import HandleCollection, InputHandle, OutputHandle
from tmlibrary_tpu_torch.jterator.modules import list_modules
from tmlibrary_tpu_torch.jterator.project import handles_template
from tmlibrary_tpu_torch.workflow.engine import WorkflowDescription

ROOT = Path(__file__).resolve().parents[1]


#: objects whose identity the alias graph compares (immutable scalars may
#: be shared by the interpreter alone)
_GRAPH_TYPES = (list, dict, set, datetime.date)


def same(a, b, memo: "dict | None" = None) -> bool:
    """Equal documents: values and types (NaN equal to NaN), and the same
    alias graph -- a list, dict, set, date or datetime met again in one
    is met again at the same places in the other, so cycles end."""
    memo = {} if memo is None else memo
    if type(a) is not type(b):
        return False
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, _GRAPH_TYPES):
        ka, kb = ("a", id(a)), ("b", id(b))
        if ka in memo or kb in memo:
            return memo.get(ka) == id(b) and memo.get(kb) == id(a)
        memo[ka], memo[kb] = id(b), id(a)
    if isinstance(a, dict):
        return len(a) == len(b) and all(same(ka, kb, memo) and same(a[ka], b[kb], memo)
                                        for ka, kb in zip(a, b))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y, memo) for x, y in zip(a, b))
    if isinstance(a, set):
        return a == b and sorted(map(repr, a)) == sorted(map(repr, b))
    return a == b


# ----------------------------------------------------- harvested documents
def _harvest() -> tuple[list, list]:
    """(dicts, texts): the literal documents the JAX package's tests and
    scripts dump with ``yaml.safe_dump`` or assign to a ``*YAML*``,
    ``*PIPE*``, ``*HANDLES*`` or ``*WORKFLOW*`` name, and the YAML texts
    they embed."""
    docs, texts = [], []
    files = sorted(p for p in (ROOT / "tests").glob("test_*.py")
                   if not p.name.startswith("test_torch_"))
    files += sorted((ROOT / "scripts").glob("*.py"))
    for path in files:
        source = path.read_text()
        if "yaml" not in source.lower():
            continue
        for node in ast.walk(ast.parse(source)):
            candidates = []
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("safe_dump", "dump") and node.args):
                candidates.append(node.args[0])
            if isinstance(node, ast.Assign) and any(
                    word in ast.unparse(t).upper() for t in node.targets
                    for word in ("YAML", "PIPE", "HANDLES", "WORKFLOW")):
                candidates.append(node.value)
            for value in candidates:
                try:
                    doc = ast.literal_eval(value)
                except (ValueError, SyntaxError, TypeError):
                    continue
                if isinstance(doc, str) and ":" in doc:
                    texts.append(pytest.param(doc, id=f"{path.stem}:{node.lineno}"))
                elif isinstance(doc, (dict, list)):
                    docs.append(pytest.param(doc, id=f"{path.stem}:{node.lineno}"))
    return docs, texts


HARVESTED_DOCS, HARVESTED_TEXTS = _harvest()


def test_the_harvest_found_the_reference_documents():
    ids = {p.id.split(":")[0] for p in HARVESTED_DOCS + HARVESTED_TEXTS}
    assert {"test_project", "test_workflow", "test_full_stack", "test_nn", "demo",
            "chaos_run"} <= ids, ids
    assert len(HARVESTED_DOCS) >= 15 and len(HARVESTED_TEXTS) >= 2


@pytest.mark.parametrize("doc", HARVESTED_DOCS)
def test_reference_documents_read_and_write_as_pyyaml(doc):
    for text in (yaml.safe_dump(doc), yaml.safe_dump(doc, sort_keys=False),
                 yaml.safe_dump(doc, default_flow_style=True), json.dumps(doc, indent=2)):
        assert same(yamlio.safe_load(text), yaml.safe_load(text)), text
    assert yamlio.safe_dump(doc) == yaml.safe_dump(doc, sort_keys=False)


@pytest.mark.parametrize("text", HARVESTED_TEXTS)
def test_reference_yaml_texts_read_as_pyyaml(text):
    assert same(yamlio.safe_load(text), yaml.safe_load(text))


def test_the_description_docstring_example_reads():
    from tmlibrary_tpu.jterator import description

    text = description.__doc__.split("::", 1)[1]
    text = "\n".join(line[4:] for line in text.splitlines())
    assert same(yamlio.safe_load(text), yaml.safe_load(text))


# ------------------------------------------------ JSON the port writes
JSON_DOCS = [
    pytest.param(benchmarks.CELL_PAINTING_PIPE, id="config3"),
    pytest.param(benchmarks.full_feature_pipe(texture_levels=8, zernike_degree=6,
                                              correct=True, align=True), id="config4"),
    pytest.param(benchmarks.SMOOTH_THRESHOLD_PIPE, id="config2"),
    pytest.param(WorkflowDescription.canonical(
        {"corilla": {}, "align": {"ref_cycle": 0, "batch_size": 64},
         "jterator": {"pipe": "c4.pipe.json", "cycle": 1, "max_objects": 256}}).to_dict(),
        id="workflow"),
]


@pytest.mark.parametrize("doc", JSON_DOCS)
@pytest.mark.parametrize("indent", [None, 2])
def test_json_documents_read_as_json(doc, indent):
    text = json.dumps(doc, indent=indent)
    assert same(yamlio.safe_load(text), json.loads(text))
    assert yamlio.safe_dump(doc) == yaml.safe_dump(doc, sort_keys=False)


# --------------------------------------------------- the port's documents
@pytest.mark.parametrize("module", list_modules())
def test_handles_templates_are_written_as_pyyaml(module):
    doc = handles_template(module).to_dict()
    assert doc == j_handles_template(module).to_dict()
    text = yamlio.safe_dump(doc)
    assert text == yaml.safe_dump(doc, sort_keys=False)
    assert same(yamlio.safe_load(text), doc)


@pytest.mark.parametrize("wtype", ["canonical", "multiplexing"])
def test_workflow_templates_are_written_as_pyyaml(wtype, tmp_path):
    desc = WorkflowDescription.for_type(wtype)
    assert yamlio.safe_dump(desc.to_dict()) == yaml.safe_dump(desc.to_dict(), sort_keys=False)
    desc.save(tmp_path / "port.yaml")
    JDescription.for_type(wtype).save(tmp_path / "ref.yaml")
    assert (tmp_path / "port.yaml").read_bytes() == (tmp_path / "ref.yaml").read_bytes()
    assert WorkflowDescription.load(tmp_path / "ref.yaml").to_dict() == desc.to_dict()


# --------------------------------------------------------------- hypothesis
_TEXT = st.text(st.characters(blacklist_categories=("Cs",)), max_size=24)
_WORDS = st.lists(st.sampled_from(
    ["a", "yes", "No", "null", "~", "1", "0x1F", "1:30", "1e3", "1.5", ".inf", "-", "#", ":",
     "'", '"', "x: y", "a #b", "[", "]", "{", "}", ",", "&a", "*a", "!t", "%", "@", "`", "|",
     ">", "?", "é", "\t", "\n", " ", "  ", "2001-12-14", "=", "<<", "word"]),
    max_size=30).map(" ".join)
_SCALARS = (st.none() | st.booleans() | st.integers(-2**70, 2**70)
            | st.floats(allow_nan=False) | _TEXT | _WORDS)
_KEYS = (st.text(st.characters(blacklist_categories=("Cs", "Zl", "Zp"),
                               blacklist_characters="\n\r\x85"), min_size=1, max_size=20)
         | _WORDS.filter(lambda w: w and "\n" not in w and len(w) < 120)
         | st.integers(-100, 100) | st.booleans())
_DOCS = st.recursive(_SCALARS, lambda kids: st.lists(kids, max_size=4)
                     | st.dictionaries(_KEYS, kids, max_size=4), max_leaves=20)


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_DOCS)
def test_subset_documents_round_trip_both_ways(doc):
    ours = yamlio.safe_dump(doc)
    assert ours == yaml.safe_dump(doc, sort_keys=False)
    assert same(yamlio.safe_load(ours), doc)
    assert same(yaml.safe_load(ours), doc)
    for theirs in (yaml.safe_dump(doc, sort_keys=False),
                   yaml.safe_dump(doc, sort_keys=False, default_flow_style=True),
                   yaml.safe_dump(doc, sort_keys=False, width=20, indent=4)):
        assert same(yamlio.safe_load(theirs), yaml.safe_load(theirs)), theirs


_NAMES = st.text("abcdefghij_", min_size=1, max_size=12)
_CONSTANTS = st.sampled_from(["Numeric", "Character", "Boolean", "Sequence"]).flatmap(
    lambda t: st.tuples(st.just(t), {
        "Numeric": st.integers(-1000, 1000) | st.floats(allow_nan=False, allow_infinity=False),
        "Character": _WORDS | _TEXT, "Boolean": st.booleans(),
        "Sequence": st.lists(st.integers(0, 9) | _WORDS, max_size=4)}[t]))


@settings(max_examples=100, deadline=None)
@given(st.lists(st.tuples(_NAMES, _CONSTANTS), max_size=5), _NAMES, _NAMES)
def test_random_handles_are_written_as_pyyaml(constants, key, module):
    hc = HandleCollection(
        module=module, version="0.1.0",
        input=[InputHandle(name="image", type="IntensityImage", key=key)]
        + [InputHandle(name=n, type=t, value=v) for n, (t, v) in constants if v is not None],
        output=[OutputHandle(name="objects", type="SegmentedObjects", key=key, objects=key)])
    doc = hc.to_dict()
    assert yamlio.safe_dump(doc) == yaml.safe_dump(doc, sort_keys=False)
    assert same(yamlio.safe_load(yamlio.safe_dump(doc)), doc)


def test_handles_save_and_load(tmp_path):
    hc = handles_template("segment_secondary")
    hc.save(tmp_path / "h.handles.yaml")
    assert (tmp_path / "h.handles.yaml").read_text() == yaml.safe_dump(hc.to_dict(),
                                                                       sort_keys=False)
    assert HandleCollection.load(tmp_path / "h.handles.yaml") == hc


# ------------------------------------------------------------ resolver traps
TRAPS = [
    ("yes", True), ("Yes", True), ("YES", True), ("no", False), ("NO", False),
    ("on", True), ("On", True), ("off", False), ("OFF", False), ("True", True),
    ("FALSE", False), ("y", "y"), ("n", "n"), ("yEs", "yEs"),
    ("~", None), ("null", None), ("Null", None), ("NULL", None), ("", None), ("nULL", "nULL"),
    ("0x1F", 31), ("-0x1f", -31), ("0b101", 5), ("017", 15), ("-017", -15), ("1_000", 1000),
    ("1:30", 90), ("-1:30", -90), ("0", 0), ("+7", 7), ("08", "08"),
    ("1e3", "1e3"), ("1.0e+3", 1000.0), ("1.5", 1.5), ("1.", 1.0), (".5", 0.5),
    ("1_0.5", 10.5), ("1:30.5", 90.5), (".inf", math.inf), ("-.Inf", -math.inf),
    ("+.INF", math.inf), (".nan", math.nan), (".NaN", math.nan), ("1e-05", "1e-05"),
    ("2001-12-14", datetime.date(2001, 12, 14)),
    ("2001-12-14t21:59:43.10-05:00", datetime.datetime(
        2001, 12, 14, 21, 59, 43, 100000,
        tzinfo=datetime.timezone(-datetime.timedelta(hours=5)))),
    ("2001-12-14 21:59:43.10", datetime.datetime(2001, 12, 14, 21, 59, 43, 100000)),
    ("2001-12-14T21:59:43Z", datetime.datetime(2001, 12, 14, 21, 59, 43,
                                               tzinfo=datetime.timezone.utc)),
    ("2001-1-14", "2001-1-14"), ("'yes'", "yes"), ('"1.5"', "1.5"), ("'~'", "~"),
]


@pytest.mark.parametrize("text,want", TRAPS, ids=[t or "empty" for t, _ in TRAPS])
def test_resolver_traps(text, want):
    got = yamlio.safe_load(f"k: {text}\n")["k"]
    ref = yaml.safe_load(f"k: {text}\n")["k"]
    assert same(got, ref) and same(got, want)
    if isinstance(want, (bool, int, float)) or want is None:
        # the writer quotes a string that would read back as this type
        assert yamlio.safe_dump({"k": text}) == yaml.safe_dump({"k": text}, sort_keys=False)


# ------------------------------------------------- what was outside the subset
#: constructs outside plain block YAML: each reads as PyYAML reads it, or
#: raises where PyYAML raises (an undefined alias, a second document, the
#: ``=`` value)
OUTSIDE = [
    ("a: &x 1\nb: *x\n", "anchors"), ("a: 1\nb: *x\n", "aliases"), ("a: !!str 1\n", "tags"),
    ("a: |\n  text\n", "block scalars"), ("a: >\n  text\n", "block scalars"),
    ("a: 1\n---\nb: 2\n", "single document"), ("<<: {a: 1}\nb: 2\n", "merge"),
    ("? a\n: b\n", "explicit keys"), ("[a: b]\n", "single-pair"),
    ("%YAML 1.1\n---\na: 1\n", "directives"), ("a: =\n", "'value'"),
]


def pyyaml_outcome(text: str):
    """``(True, document)`` of ``yaml.safe_load``, or ``(False, error)``."""
    try:
        return True, yaml.safe_load(text)
    except Exception as exc:  # PyYAML lets ValueError, KeyError, ... through
        return False, exc


def assert_reads_as_pyyaml(text: str) -> None:
    """``yamlio.safe_load(text)`` is ``yaml.safe_load(text)``, or both
    raise."""
    ok, want = pyyaml_outcome(text)
    if ok:
        assert same(yamlio.safe_load(text), want), (text, want)
    else:
        with pytest.raises(yamlio.YAMLSubsetError):
            yamlio.safe_load(text)


@pytest.mark.parametrize("text,what", OUTSIDE, ids=[w for _, w in OUTSIDE])
def test_outside_the_subset_raises_by_name(text, what, tmp_path):
    """As ``yaml.safe_load``: the same document, or
    :class:`YAMLSubsetError` naming the file and the line where PyYAML
    raises.  (The name is the one the test had when the port read a
    subset of YAML and refused these; it holds parity now.)"""
    path = tmp_path / "p.pipe.yaml"
    path.write_text(text)
    ok, want = pyyaml_outcome(text)
    if ok:
        assert same(yamlio.load(path), want), (what, want)
        return
    with pytest.raises(yamlio.YAMLSubsetError) as info:
        yamlio.load(path)
    assert isinstance(info.value, PipelineDescriptionError)
    assert str(path) in str(info.value) and "line " in str(info.value)


def test_the_constructs_outside_plain_yaml_read_to_these_documents():
    shared = yamlio.safe_load(OUTSIDE[0][0])
    assert shared == {"a": 1, "b": 1}
    assert [pyyaml_outcome(t)[0] for t, _ in OUTSIDE] == [
        True, False, True, True, True, False, True, True, True, True, False]
    assert yamlio.safe_load("[a: b]\n") == [{"a": "b"}]
    assert yamlio.safe_load("<<: {a: 1}\nb: 2\n") == {"a": 1, "b": 2}


#: malformed YAML, and what PyYAML raises on it: YAMLError, or the plain
#: ValueError of ``int('abc')`` that ``construct_yaml_int`` lets through
MALFORMED = [
    ("a: b: c\n", yaml.YAMLError), ("a:\n\t- b\n", yaml.YAMLError),
    ("[1, 2\n", yaml.YAMLError), ("a: 'open\n", yaml.YAMLError),
    ("- a\nb: 1\n", yaml.YAMLError), ("{a: 1\n", yaml.YAMLError),
    ("a: |0\n  x\n", yaml.YAMLError), ("a: |\n\tx\n", yaml.YAMLError),
    ("a: |\n  x\n\ty\n", yaml.YAMLError), ("<<: 1\n", yaml.YAMLError),
    ("!!int abc\n", ValueError), ("!foo x\n", yaml.YAMLError),
    ("? [a]\n: 1\n", yaml.YAMLError),
]


@pytest.mark.parametrize("text,raises", MALFORMED, ids=[repr(t) for t, _ in MALFORMED])
def test_malformed_yaml_raises_where_pyyaml_raises(text, raises):
    with pytest.raises(raises):
        yaml.safe_load(text)
    with pytest.raises(yamlio.YAMLSubsetError, match="line "):
        yamlio.safe_load(text)


@pytest.mark.parametrize("doc", [{"a": (1, 2)}, {"a": 1j}, {"k" * 128: 1}, {"": 1},
                                 {"a\nb": 1}, {(1, 2): 3}])
def test_the_writer_refuses_what_it_cannot_write_as_pyyaml(doc):
    """The text of ``yaml.safe_dump(doc, sort_keys=False)`` -- a tuple
    as a sequence, ``? `` before a long, empty, multi-line or tuple key --
    and a refusal only where PyYAML's representer refuses (a complex
    number).  (The name is kept from the subset writer, which refused
    all of these.)"""
    try:
        want = yaml.safe_dump(doc, sort_keys=False)
    except yaml.representer.RepresenterError:
        with pytest.raises(yamlio.YAMLSubsetError, match="cannot represent"):
            yamlio.safe_dump(doc)
        return
    text = yamlio.safe_dump(doc)
    assert text == want
    assert_reads_as_pyyaml(text)  # a tuple key reads back as a list: unhashable in both


def test_a_container_twice_in_one_document_raises():
    """A container met twice is written once with an anchor and then as
    its alias, as PyYAML writes it, and reads back as one object.  (The
    name is kept from the subset writer, which raised here.)"""
    shared = [1, 2]
    doc = {"a": shared, "b": shared, "c": {"d": shared}}
    text = yamlio.safe_dump(doc)
    assert text == yaml.safe_dump(doc, sort_keys=False)
    assert "&id001" in text and text.count("*id001") == 2
    back = yamlio.safe_load(text)
    assert back["a"] is back["b"] is back["c"]["d"] and same(back, doc)
