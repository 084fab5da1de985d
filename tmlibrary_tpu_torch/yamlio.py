"""A YAML reader and writer on the standard library alone.

The reference reads and writes its pipeline projects, handles files and
workflow descriptions with PyYAML (``yaml.safe_load``,
``yaml.safe_dump(doc, sort_keys=False)``).  The card's machine has no
``yaml``, so the port keeps this module: a reader and a writer for the
subset of YAML those documents use.

**Reading** (:func:`safe_load`, :func:`load`): block mappings and
sequences (also a sequence written flush under its mapping key), flow
sequences and mappings (so every JSON document reads too), plain,
single-quoted and double-quoted scalars (also over several lines),
comments, ``---`` and ``...`` markers and empty values.  Plain scalars
resolve as PyYAML's ``SafeLoader`` resolves them (YAML 1.1): ``yes``,
``no``, ``on``, ``off``, ``true`` and ``false`` in three casings are
booleans; ``~``, ``null`` and the empty value are None; ``0x``, ``0b``,
leading-zero octal, ``_`` separators and sexagesimal ``1:30`` are ints;
a float needs a dot (``1e3`` is a string, ``1.0e+3`` a float),
``.inf``/``.nan`` are floats; ``2001-12-14`` is a :class:`datetime.date`
and a full timestamp a :class:`datetime.datetime`.  Quoted scalars are
strings.

Everything outside the subset raises :class:`YAMLSubsetError` naming the
file (when there is one) and the line: anchors and aliases, ``<<``
merges, tags, ``%`` directives, block scalars (``|``, ``>``), explicit
``?`` keys, single-pair mappings inside a flow sequence and streams of
more than one document.  Malformed YAML raises the same error.

**Writing** (:func:`safe_dump`, :func:`dump`): the bytes of
``yaml.safe_dump(doc, sort_keys=False)`` (width 80, indent 2,
``allow_unicode=False``) for documents of dicts, lists, strings, ints,
floats, bools and None: block style, sequences flush under their key,
``[]``/``{}`` for empty collections, strings quoted where they would
read back as another type or hold indicators, long scalars folded at
the width, floats from ``repr`` with ``.0`` put before a bare exponent.
A container that occurs twice in one document (PyYAML writes an anchor)
and any other type raise :class:`YAMLSubsetError`.
"""

from __future__ import annotations

import datetime
import math
import re
from pathlib import Path
from typing import Any

from tmlibrary_tpu_torch.errors import PipelineDescriptionError


class YAMLSubsetError(PipelineDescriptionError):
    """A YAML document outside the subset the port reads or writes, or
    malformed YAML; the message names the file and the line."""


# ------------------------------------------------------------ resolution
_BOOL = re.compile(r'''^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$''', re.X)
_FLOAT = re.compile(r'''^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$''', re.X)
_INT = re.compile(r'''^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$''', re.X)
_MERGE = re.compile(r'^(?:<<)$')
_NULL = re.compile(r'''^(?: ~
                    |null|Null|NULL
                    | )$''', re.X)
_TIMESTAMP = re.compile(r'''^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$''', re.X)
_VALUE = re.compile(r'^(?:=)$')

#: (tag, pattern, first characters) in the order PyYAML registers them
_RESOLVERS = (
    ("bool", _BOOL, "yYnNtTfFoO"), ("float", _FLOAT, "-+0123456789."),
    ("int", _INT, "-+0123456789"), ("merge", _MERGE, "<"),
    ("null", _NULL, "~nN"), ("timestamp", _TIMESTAMP, "0123456789"),
    ("value", _VALUE, "="),
)


def resolve(value: str) -> str:
    """The tag a plain scalar resolves to: ``bool``, ``float``, ``int``,
    ``merge``, ``null``, ``timestamp``, ``value`` or ``str``."""
    if value == "":
        return "null"
    first = value[0]
    for tag, pattern, firsts in _RESOLVERS:
        if first in firsts and pattern.match(value):
            return tag
    return "str"


_TIMESTAMP_PARTS = re.compile(
    r'''^(?P<year>[0-9][0-9][0-9][0-9])
        -(?P<month>[0-9][0-9]?)
        -(?P<day>[0-9][0-9]?)
        (?:(?:[Tt]|[ \t]+)
        (?P<hour>[0-9][0-9]?)
        :(?P<minute>[0-9][0-9])
        :(?P<second>[0-9][0-9])
        (?:\.(?P<fraction>[0-9]*))?
        (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
        (?::(?P<tz_minute>[0-9][0-9]))?))?)?$''', re.X)


def _sexagesimal(text: str, cast):
    total = cast(0)
    base = 1
    for part in reversed(text.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def _construct_int(text: str) -> int:
    value = text.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _construct_float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def _construct_timestamp(text: str):
    v = _TIMESTAMP_PARTS.match(text).groupdict()
    year, month, day = int(v["year"]), int(v["month"]), int(v["day"])
    if not v["hour"]:
        return datetime.date(year, month, day)
    fraction = 0
    if v["fraction"]:
        fraction = int(v["fraction"][:6].ljust(6, "0"))
    tzinfo = None
    if v["tz_sign"]:
        delta = datetime.timedelta(hours=int(v["tz_hour"]), minutes=int(v["tz_minute"] or 0))
        tzinfo = datetime.timezone(-delta if v["tz_sign"] == "-" else delta)
    elif v["tz"]:
        tzinfo = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(v["hour"]), int(v["minute"]),
                             int(v["second"]), fraction, tzinfo=tzinfo)


_BOOL_VALUES = {"yes": True, "no": False, "true": True, "false": False, "on": True,
                "off": False}


# ---------------------------------------------------------------- scanner
_WS = "\0 \t\n"  # PyYAML's break-or-space set after normalising line breaks
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\x09", "\t": "\x09", "n": "\x0A",
            "v": "\x0B", "f": "\x0C", "r": "\x0D", "e": "\x1B", " ": "\x20", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xA0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_NON_PRINTABLE = re.compile("[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF\uE000-\uFFFD"
                            "\U00010000-\U0010ffff]")

# token kinds
STREAM_END, DOC_START, DOC_END = "stream end", "'---'", "'...'"
BLOCK_SEQ, BLOCK_MAP, BLOCK_END, ENTRY = ("block sequence", "block mapping", "block end",
                                          "'-'")
FLOW_SEQ, FLOW_SEQ_END, FLOW_MAP, FLOW_MAP_END, FLOW_ENTRY = "'['", "']'", "'{'", "'}'", "','"
KEY, VALUE, SCALAR = "key", "':'", "scalar"


class _Token:
    __slots__ = ("kind", "line", "value", "plain")

    def __init__(self, kind: str, line: int, value: str = "", plain: bool = False):
        self.kind, self.line, self.value, self.plain = kind, line, value, plain


class _SimpleKey:
    __slots__ = ("token_number", "required", "index", "line", "column")

    def __init__(self, token_number, required, index, line, column):
        self.token_number, self.required = token_number, required
        self.index, self.line, self.column = index, line, column


class _Scanner:
    """PyYAML's scanner (``yaml/scanner.py``) cut to the subset: the
    whole text is tokenised up front, and simple keys are inserted at the
    position they were saved at once their ``:`` is found."""

    def __init__(self, text: str, name: str):
        self.name = name
        if text.startswith("\ufeff"):
            text = text[1:]
        bad = _NON_PRINTABLE.search(text)
        if bad:
            self.text, self.index = text, bad.start()
            self.line = text.count("\n", 0, bad.start())
            self.fail(f"unacceptable character #x{ord(bad.group()):04x}")
        if any(ch in text for ch in "\x85\u2028\u2029"):
            self.text, self.index = text, 0
            self.line = next(text.count("\n", 0, text.index(ch))
                             for ch in "\x85\u2028\u2029" if ch in text)
            self.fail("NEL/LS/PS line breaks are outside the subset")
        self.text = text.replace("\r\n", "\n").replace("\r", "\n") + "\0"
        self.index = self.line = self.column = 0
        self.flow_level = 0
        self.indent = -1
        self.indents: list[int] = []
        self.allow_simple_key = True
        self.simple_keys: dict[int, _SimpleKey] = {}
        self.tokens: list[_Token] = []
        self.done = False

    # -------------------------------------------------------- primitives
    def fail(self, message: str):
        where = f"{self.name}, " if self.name else ""
        raise YAMLSubsetError(f"{where}line {self.line + 1}: {message}")

    def peek(self, k: int = 0) -> str:
        i = self.index + k
        return self.text[i] if i < len(self.text) else "\0"

    def prefix(self, n: int) -> str:
        return self.text[self.index:self.index + n]

    def forward(self, n: int = 1) -> None:
        for _ in range(n):
            ch = self.text[self.index]
            self.index += 1
            if ch == "\n":
                self.line += 1
                self.column = 0
            else:
                self.column += 1

    def scan_line_break(self) -> str:
        if self.peek() == "\n":
            self.forward()
            return "\n"
        return ""

    # ------------------------------------------------------------ tokenise
    def scan(self) -> list[_Token]:
        while not self.done:
            self.fetch()
        return self.tokens

    def fetch(self) -> None:
        self.scan_to_next_token()
        self.stale_simple_keys()
        self.unwind_indent(self.column)
        ch = self.peek()
        nxt = self.peek(1)
        if ch == "\0":
            self.unwind_indent(-1)
            self.remove_simple_key()
            self.allow_simple_key = False
            self.tokens.append(_Token(STREAM_END, self.line))
            self.done = True
        elif ch == "%" and self.column == 0:
            self.fail("directives ('%') are outside the subset")
        elif self.column == 0 and self.prefix(3) in ("---", "...") and self.peek(3) in _WS:
            self.unwind_indent(-1)
            self.remove_simple_key()
            self.allow_simple_key = False
            kind = DOC_START if ch == "-" else DOC_END
            line = self.line
            self.forward(3)
            self.tokens.append(_Token(kind, line))
        elif ch in "[{":
            self.save_simple_key()
            self.flow_level += 1
            self.allow_simple_key = True
            self.tokens.append(_Token(FLOW_SEQ if ch == "[" else FLOW_MAP, self.line))
            self.forward()
        elif ch in "]}":
            self.remove_simple_key()
            self.flow_level -= 1
            self.allow_simple_key = False
            self.tokens.append(_Token(FLOW_SEQ_END if ch == "]" else FLOW_MAP_END, self.line))
            self.forward()
        elif ch == ",":
            self.allow_simple_key = True
            self.remove_simple_key()
            self.tokens.append(_Token(FLOW_ENTRY, self.line))
            self.forward()
        elif ch == "-" and nxt in _WS:
            if self.flow_level:
                self.fail("block sequence entries are not allowed in a flow collection")
            if not self.allow_simple_key:
                self.fail("sequence entries are not allowed here")
            if self.add_indent(self.column):
                self.tokens.append(_Token(BLOCK_SEQ, self.line))
            self.allow_simple_key = True
            self.remove_simple_key()
            self.tokens.append(_Token(ENTRY, self.line))
            self.forward()
        elif ch == "?" and (self.flow_level or nxt in _WS):
            self.fail("explicit keys ('?') are outside the subset")
        elif ch == ":" and (self.flow_level or nxt in _WS):
            self.fetch_value()
        elif ch == "*":
            self.fail("aliases ('*') are outside the subset")
        elif ch == "&":
            self.fail("anchors ('&') are outside the subset")
        elif ch == "!":
            self.fail("tags ('!') are outside the subset")
        elif ch in "|>" and not self.flow_level:
            self.fail(f"block scalars ('{ch}') are outside the subset")
        elif ch in "'\"":
            self.save_simple_key()
            self.allow_simple_key = False
            self.tokens.append(self.scan_flow_scalar(ch == '"'))
        elif (ch not in "\0 \t\n-?:,[]{}#&*!|>'\"%@`"
              or (nxt not in _WS and (ch == "-" or (not self.flow_level and ch in "?:")))):
            self.save_simple_key()
            self.allow_simple_key = False
            self.tokens.append(self.scan_plain())
        else:
            self.fail(f"found character {ch!r} that cannot start any token")

    def scan_to_next_token(self) -> None:
        while True:
            while self.peek() == " ":
                self.forward()
            if self.peek() == "#":
                while self.peek() not in "\0\n":
                    self.forward()
            if self.scan_line_break():
                if not self.flow_level:
                    self.allow_simple_key = True
            else:
                return

    # -------------------------------------------------------- simple keys
    def stale_simple_keys(self) -> None:
        for level in list(self.simple_keys):
            key = self.simple_keys[level]
            if key.line != self.line or self.index - key.index > 1024:
                if key.required:
                    self.fail("could not find expected ':'")
                del self.simple_keys[level]

    def save_simple_key(self) -> None:
        required = not self.flow_level and self.indent == self.column
        if self.allow_simple_key:
            self.remove_simple_key()
            self.simple_keys[self.flow_level] = _SimpleKey(
                len(self.tokens), required, self.index, self.line, self.column)

    def remove_simple_key(self) -> None:
        key = self.simple_keys.pop(self.flow_level, None)
        if key is not None and key.required:
            self.fail("could not find expected ':'")

    def fetch_value(self) -> None:
        key = self.simple_keys.pop(self.flow_level, None)
        if key is not None:
            self.tokens.insert(key.token_number, _Token(KEY, key.line))
            if not self.flow_level and self.add_indent(key.column):
                self.tokens.insert(key.token_number, _Token(BLOCK_MAP, key.line))
            self.allow_simple_key = False
        else:
            if not self.flow_level:
                if not self.allow_simple_key:
                    self.fail("mapping values are not allowed here")
                if self.add_indent(self.column):
                    self.tokens.append(_Token(BLOCK_MAP, self.line))
            self.allow_simple_key = not self.flow_level
            self.remove_simple_key()
        self.tokens.append(_Token(VALUE, self.line))
        self.forward()

    # ------------------------------------------------------- indentation
    def unwind_indent(self, column: int) -> None:
        if self.flow_level:
            return
        while self.indent > column:
            self.indent = self.indents.pop()
            self.tokens.append(_Token(BLOCK_END, self.line))

    def add_indent(self, column: int) -> bool:
        if self.indent < column:
            self.indents.append(self.indent)
            self.indent = column
            return True
        return False

    # ------------------------------------------------------------ scalars
    def scan_plain(self) -> _Token:
        line = self.line
        chunks: list[str] = []
        indent = self.indent + 1
        spaces: list[str] = []
        while self.peek() != "#":
            length = 0
            while True:
                ch = self.peek(length)
                if (ch in _WS
                        or (ch == ":" and self.peek(length + 1)
                            in _WS + (",[]{}" if self.flow_level else ""))
                        or (self.flow_level and ch in ",?[]{}")):
                    break
                length += 1
            if length == 0:
                break
            self.allow_simple_key = False
            chunks.extend(spaces)
            chunks.append(self.prefix(length))
            self.forward(length)
            spaces = self.scan_plain_spaces()
            if (not spaces or self.peek() == "#"
                    or (not self.flow_level and self.column < indent)):
                break
        return _Token(SCALAR, line, "".join(chunks), plain=True)

    def _at_document_marker(self) -> bool:
        return self.prefix(3) in ("---", "...") and self.peek(3) in _WS

    def scan_plain_spaces(self) -> list[str]:
        chunks: list[str] = []
        length = 0
        while self.peek(length) == " ":
            length += 1
        whitespaces = self.prefix(length)
        self.forward(length)
        if self.peek() == "\n":
            self.scan_line_break()
            self.allow_simple_key = True
            if self._at_document_marker():
                return []
            breaks = []
            while self.peek() in " \n":
                if self.peek() == " ":
                    self.forward()
                else:
                    breaks.append(self.scan_line_break())
                    if self._at_document_marker():
                        return []
            if not breaks:
                chunks.append(" ")
            chunks.extend(breaks)
        elif whitespaces:
            chunks.append(whitespaces)
        return chunks

    def scan_flow_scalar(self, double: bool) -> _Token:
        line = self.line
        quote = self.peek()
        self.forward()
        chunks = self.scan_flow_non_spaces(double)
        while self.peek() != quote:
            chunks.extend(self.scan_flow_spaces())
            chunks.extend(self.scan_flow_non_spaces(double))
        self.forward()
        return _Token(SCALAR, line, "".join(chunks))

    def scan_flow_non_spaces(self, double: bool) -> list[str]:
        chunks: list[str] = []
        while True:
            length = 0
            while self.peek(length) not in "'\"\\" + _WS:
                length += 1
            if length:
                chunks.append(self.prefix(length))
                self.forward(length)
            ch = self.peek()
            if not double and ch == "'" and self.peek(1) == "'":
                chunks.append("'")
                self.forward(2)
            elif (double and ch == "'") or (not double and ch in '"\\'):
                chunks.append(ch)
                self.forward()
            elif double and ch == "\\":
                self.forward()
                ch = self.peek()
                if ch in _ESCAPES:
                    chunks.append(_ESCAPES[ch])
                    self.forward()
                elif ch in _ESCAPE_CODES:
                    n = _ESCAPE_CODES[ch]
                    self.forward()
                    digits = self.prefix(n)
                    if len(digits) != n or any(c not in "0123456789ABCDEFabcdef"
                                               for c in digits):
                        self.fail(f"expected escape sequence of {n} hexadecimal digits")
                    chunks.append(chr(int(digits, 16)))
                    self.forward(n)
                elif ch == "\n":
                    self.scan_line_break()
                    chunks.extend(self.scan_flow_breaks())
                else:
                    self.fail(f"found unknown escape character {ch!r}")
            else:
                return chunks

    def scan_flow_spaces(self) -> list[str]:
        length = 0
        while self.peek(length) in " \t":
            length += 1
        whitespaces = self.prefix(length)
        self.forward(length)
        ch = self.peek()
        if ch == "\0" and self.index >= len(self.text) - 1:
            self.fail("found unexpected end of stream in a quoted scalar")
        if ch == "\n":
            self.scan_line_break()
            breaks = self.scan_flow_breaks()
            return breaks if breaks else [" "]
        return [whitespaces]

    def scan_flow_breaks(self) -> list[str]:
        chunks = []
        while True:
            if self._at_document_marker():
                self.fail("found unexpected document separator in a quoted scalar")
            while self.peek() in " \t":
                self.forward()
            if self.peek() == "\n":
                chunks.append(self.scan_line_break())
            else:
                return chunks


# ----------------------------------------------------------------- parser
class _Parser:
    """PyYAML's parser and safe constructor in one pass over the tokens:
    it builds the Python objects directly."""

    def __init__(self, tokens: list[_Token], scanner: _Scanner):
        self.tokens = tokens
        self.pos = 0
        self.scanner = scanner

    def fail(self, message: str, token: _Token):
        self.scanner.line = token.line
        self.scanner.fail(message)

    def peek(self) -> _Token:
        return self.tokens[self.pos]

    def check(self, *kinds: str) -> bool:
        return self.tokens[self.pos].kind in kinds

    def get(self) -> _Token:
        tok = self.tokens[self.pos]
        self.pos += 1
        return tok

    def document(self) -> Any:
        """The stream's single document (None for an empty stream)."""
        while self.check(DOC_END):
            self.get()
        if self.check(STREAM_END):
            return None
        if self.check(DOC_START):
            self.get()
            if self.check(DOC_START, DOC_END, STREAM_END):
                value = None
            else:
                value = self.node(block=True)
        else:
            value = self.node(block=True)
        while self.check(DOC_END):
            self.get()
        if not self.check(STREAM_END):
            self.fail("expected a single document in the stream (multi-document streams "
                      "are outside the subset)", self.peek())
        return value

    def node(self, block: bool, indentless: bool = False) -> Any:
        tok = self.peek()
        if indentless and tok.kind == ENTRY:
            return self.indentless_sequence()
        if tok.kind == SCALAR:
            self.get()
            return self.scalar(tok)
        if tok.kind == FLOW_SEQ:
            return self.flow_sequence()
        if tok.kind == FLOW_MAP:
            return self.flow_mapping()
        if block and tok.kind == BLOCK_SEQ:
            return self.block_sequence()
        if block and tok.kind == BLOCK_MAP:
            return self.block_mapping()
        self.fail(f"expected the node content, but found {tok.kind}", tok)

    def scalar(self, tok: _Token) -> Any:
        if not tok.plain:
            return tok.value
        tag = resolve(tok.value)
        try:
            if tag == "str":
                return tok.value
            if tag == "null":
                return None
            if tag == "bool":
                return _BOOL_VALUES[tok.value.lower()]
            if tag == "int":
                return _construct_int(tok.value)
            if tag == "float":
                return _construct_float(tok.value)
            if tag == "timestamp":
                return _construct_timestamp(tok.value)
        except ValueError as e:
            self.fail(f"bad {tag} {tok.value!r}: {e}", tok)
        what = {"merge": "merge keys ('<<')"}.get(tag, f"the {tag!r} tag")
        self.fail(f"{what} are outside the subset" if tag == "merge"
                  else f"{tok.value!r} resolves to {what}, outside the subset", tok)

    def _key(self, key: Any, tok: _Token) -> Any:
        try:
            hash(key)
        except TypeError:
            self.fail("found an unhashable key", tok)
        return key

    def block_sequence(self) -> list:
        self.get()
        out = []
        while self.check(ENTRY):
            self.get()
            out.append(None if self.check(ENTRY, BLOCK_END) else self.node(block=True))
        if not self.check(BLOCK_END):
            self.fail(f"expected block end, but found {self.peek().kind}", self.peek())
        self.get()
        return out

    def indentless_sequence(self) -> list:
        out = []
        while self.check(ENTRY):
            self.get()
            out.append(None if self.check(ENTRY, KEY, VALUE, BLOCK_END)
                       else self.node(block=True))
        return out

    def block_mapping(self) -> dict:
        self.get()
        out: dict = {}
        while True:
            if self.check(KEY):
                tok = self.get()
                key = (None if self.check(KEY, VALUE, BLOCK_END)
                       else self.node(block=True, indentless=True))
                value = None
                if self.check(VALUE):
                    self.get()
                    if not self.check(KEY, VALUE, BLOCK_END):
                        value = self.node(block=True, indentless=True)
                out[self._key(key, tok)] = value
                continue
            if not self.check(BLOCK_END):
                self.fail(f"expected block end, but found {self.peek().kind}", self.peek())
            self.get()
            return out

    def flow_sequence(self) -> list:
        self.get()
        out = []
        first = True
        while not self.check(FLOW_SEQ_END):
            if not first:
                if not self.check(FLOW_ENTRY):
                    self.fail(f"expected ',' or ']', but got {self.peek().kind}", self.peek())
                self.get()
            first = False
            if self.check(KEY):
                self.fail("single-pair mappings in a flow sequence are outside the subset",
                          self.peek())
            if not self.check(FLOW_SEQ_END):
                out.append(self.node(block=False))
        self.get()
        return out

    def flow_mapping(self) -> dict:
        self.get()
        out: dict = {}
        first = True
        while not self.check(FLOW_MAP_END):
            if not first:
                if not self.check(FLOW_ENTRY):
                    self.fail(f"expected ',' or '}}', but got {self.peek().kind}", self.peek())
                self.get()
            first = False
            if self.check(KEY):
                tok = self.get()
                key = None if self.check(VALUE, FLOW_ENTRY, FLOW_MAP_END) else self.node(False)
                value = None
                if self.check(VALUE):
                    self.get()
                    if not self.check(FLOW_ENTRY, FLOW_MAP_END):
                        value = self.node(block=False)
                out[self._key(key, tok)] = value
            elif not self.check(FLOW_MAP_END):
                tok = self.peek()
                out[self._key(self.node(block=False), tok)] = None
        self.get()
        return out


def safe_load(text: str, name: str = "") -> Any:
    """The single document of ``text`` as ``yaml.safe_load`` builds it
    (``name`` is put in error messages)."""
    scanner = _Scanner(text, name)
    return _Parser(scanner.scan(), scanner).document()


def load(path) -> Any:
    """:func:`safe_load` of a file."""
    path = Path(path)
    return safe_load(path.read_text(), name=str(path))


# ----------------------------------------------------------------- writer
def _represent(value: Any) -> tuple[str, bool]:
    """``(text, plain_ok)`` of a scalar: its text and whether it may be
    written plain (it reads back as the same type)."""
    if value is None:
        return "null", True
    if value is True or value is False:
        return ("true" if value else "false"), True
    if type(value) is int:
        return str(value), True
    if type(value) is float:
        if value != value:
            text = ".nan"
        elif value == math.inf:
            text = ".inf"
        elif value == -math.inf:
            text = "-.inf"
        else:
            text = repr(value).lower()
            if "." not in text and "e" in text:
                text = text.replace("e", ".0e", 1)
        return text, True
    if type(value) is str:
        return value, resolve(value) == "str"
    raise YAMLSubsetError(f"cannot write a {type(value).__name__} ({value!r}) as YAML: "
                          "the writer takes dicts, lists, str, int, float, bool and None")


class _Analysis:
    __slots__ = ("empty", "multiline", "block_plain", "single_quoted")

    def __init__(self, empty, multiline, block_plain, single_quoted):
        self.empty, self.multiline = empty, multiline
        self.block_plain, self.single_quoted = block_plain, single_quoted


_BREAKS = "\n\x85\u2028\u2029"
_SPACE_BREAK = "\0 \t\r\n\x85\u2028\u2029"


def _analyze(scalar: str) -> _Analysis:
    """PyYAML's ``Emitter.analyze_scalar`` with ``allow_unicode=False``,
    reduced to what block-style output needs."""
    if not scalar:
        return _Analysis(True, False, True, True)
    block_indicators = line_breaks = special = False
    leading_space = leading_break = trailing_space = trailing_break = False
    break_space = space_break = False
    if scalar.startswith("---") or scalar.startswith("..."):
        block_indicators = True
    preceded_by_ws = True
    followed_by_ws = len(scalar) == 1 or scalar[1] in _SPACE_BREAK
    previous_space = previous_break = False
    n = len(scalar)
    for index, ch in enumerate(scalar):
        if index == 0:
            if ch in "#,[]{}&*!|>'\"%@`":
                block_indicators = True
            if ch in "?:" and followed_by_ws:
                block_indicators = True
            if ch == "-" and followed_by_ws:
                block_indicators = True
        else:
            if ch == ":" and followed_by_ws:
                block_indicators = True
            if ch == "#" and preceded_by_ws:
                block_indicators = True
        if ch in _BREAKS:
            line_breaks = True
        if not (ch == "\n" or "\x20" <= ch <= "\x7E"):
            special = True
        if ch == " ":
            if index == 0:
                leading_space = True
            if index == n - 1:
                trailing_space = True
            if previous_break:
                break_space = True
            previous_space, previous_break = True, False
        elif ch in _BREAKS:
            if index == 0:
                leading_break = True
            if index == n - 1:
                trailing_break = True
            if previous_space:
                space_break = True
            previous_space, previous_break = False, True
        else:
            previous_space = previous_break = False
        preceded_by_ws = ch in _SPACE_BREAK
        followed_by_ws = index + 2 >= n or scalar[index + 2] in _SPACE_BREAK
    block_plain = single_quoted = True
    if leading_space or leading_break or trailing_space or trailing_break:
        block_plain = False
    if break_space:
        block_plain = single_quoted = False
    if space_break or special:
        block_plain = single_quoted = False
    if line_breaks:
        block_plain = False
    if block_indicators:
        block_plain = False
    return _Analysis(False, line_breaks, block_plain, single_quoted)


_DOUBLE_ESCAPES = {"\0": "0", "\x07": "a", "\x08": "b", "\x09": "t", "\x0A": "n",
                   "\x0B": "v", "\x0C": "f", "\x0D": "r", "\x1B": "e", '"': '"', "\\": "\\",
                   "\x85": "N", "\xA0": "_", "\u2028": "L", "\u2029": "P"}


class _Emitter:
    """PyYAML's ``Emitter`` for block-style documents with default
    settings, as recursion over the document instead of an event queue:
    the same column, indent and whitespace bookkeeping, so the same
    bytes."""

    best_width = 80
    best_indent = 2

    def __init__(self):
        self.out: list[str] = []
        self.column = 0
        self.whitespace = self.indention = True
        self.open_ended = False
        self.indent: "int | None" = None
        self.indents: list = []
        self.flow_level = 0
        self.root = self.mapping_context = self.simple_key = False
        self.seen: set[int] = set()

    # --------------------------------------------------------- writing
    def write(self, data: str) -> None:
        self.column += len(data)
        self.out.append(data)

    def write_indicator(self, indicator: str, need_whitespace: bool, whitespace: bool = False,
                        indention: bool = False) -> None:
        data = indicator if self.whitespace or not need_whitespace else " " + indicator
        self.whitespace = whitespace
        self.indention = self.indention and indention
        self.open_ended = False
        self.write(data)

    def write_indent(self) -> None:
        indent = self.indent or 0
        if (not self.indention or self.column > indent
                or (self.column == indent and not self.whitespace)):
            self.write_line_break()
        if self.column < indent:
            self.whitespace = True
            self.write(" " * (indent - self.column))

    def write_line_break(self, data: str = "\n") -> None:
        self.whitespace = self.indention = True
        self.column = 0
        self.out.append(data)

    def increase_indent(self, flow: bool = False, indentless: bool = False) -> None:
        self.indents.append(self.indent)
        if self.indent is None:
            self.indent = self.best_indent if flow else 0
        elif not indentless:
            self.indent += self.best_indent

    # ----------------------------------------------------------- nodes
    def document(self, doc: Any) -> str:
        self.node(doc, root=True)
        self.write_indent()
        if self.open_ended:
            self.write_indicator("...", True)
            self.write_indent()
        return "".join(self.out)

    def node(self, value: Any, root: bool = False, mapping: bool = False,
             simple_key: bool = False) -> None:
        self.root, self.mapping_context, self.simple_key = root, mapping, simple_key
        if isinstance(value, (dict, list)):
            if id(value) in self.seen:
                raise YAMLSubsetError("a container occurs twice in the document (PyYAML "
                                      "writes an anchor and an alias): outside the subset")
            self.seen.add(id(value))
            if type(value) not in (dict, list):
                raise YAMLSubsetError(f"cannot write a {type(value).__name__} as YAML")
            if self.flow_level or not value:
                self.flow_collection("[]" if isinstance(value, list) else "{}")
            elif isinstance(value, list):
                self.block_sequence(value)
            else:
                self.block_mapping(value)
            return
        text, plain_ok = _represent(value)
        self.increase_indent(flow=True)
        self.scalar(text, plain_ok)
        self.indent = self.indents.pop()

    def flow_collection(self, brackets: str) -> None:
        self.write_indicator(brackets[0], True, whitespace=True)
        self.flow_level += 1
        self.increase_indent(flow=True)
        self.indent = self.indents.pop()
        self.flow_level -= 1
        self.write_indicator(brackets[1], False)

    def block_sequence(self, items: list) -> None:
        self.increase_indent(flow=False, indentless=self.mapping_context and not self.indention)
        for item in items:
            self.write_indent()
            self.write_indicator("-", True, indention=True)
            self.node(item)
        self.indent = self.indents.pop()

    def block_mapping(self, mapping: dict) -> None:
        self.increase_indent(flow=False)
        for key, value in mapping.items():
            self.write_indent()
            if isinstance(key, (dict, list)):
                raise YAMLSubsetError("collection keys are outside the subset")
            text, _ = _represent(key)
            analysis = _analyze(text)
            if len(text) >= 128 or analysis.empty or analysis.multiline:
                raise YAMLSubsetError(f"key {key!r} needs an explicit '?' key: outside the "
                                      "subset")
            self.node(key, mapping=True, simple_key=True)
            self.write_indicator(":", False)
            self.node(value, mapping=True)
        self.indent = self.indents.pop()

    # --------------------------------------------------------- scalars
    def scalar(self, text: str, plain_ok: bool) -> None:
        analysis = _analyze(text)
        split = not self.simple_key
        if (plain_ok and not (self.simple_key and (analysis.empty or analysis.multiline))
                and not self.flow_level and analysis.block_plain):
            self.write_plain(text, split)
        elif analysis.single_quoted and not (self.simple_key and analysis.multiline):
            self.write_single_quoted(text, split)
        else:
            self.write_double_quoted(text, split)

    def write_plain(self, text: str, split: bool) -> None:
        if self.root:
            self.open_ended = True
        if not text:
            return
        if not self.whitespace:
            self.write(" ")
        self.whitespace = self.indention = False
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if start + 1 == end and self.column > self.best_width and split:
                        self.write_indent()
                        self.whitespace = self.indention = False
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAKS:
                    if text[start] == "\n":
                        self.write_line_break()
                    for br in text[start:end]:
                        self.write_line_break(br)
                    self.write_indent()
                    self.whitespace = self.indention = False
                    start = end
            else:
                if ch is None or ch in " " + _BREAKS:
                    self.write(text[start:end])
                    start = end
            if ch is not None:
                spaces = ch == " "
                breaks = ch in _BREAKS
            end += 1

    def write_single_quoted(self, text: str, split: bool) -> None:
        self.write_indicator("'", True)
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch is None or ch != " ":
                    if (start + 1 == end and self.column > self.best_width and split
                            and start != 0 and end != len(text)):
                        self.write_indent()
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAKS:
                    if text[start] == "\n":
                        self.write_line_break()
                    for br in text[start:end]:
                        self.write_line_break(br)
                    self.write_indent()
                    start = end
            else:
                if ch is None or ch in " " + _BREAKS or ch == "'":
                    if start < end:
                        self.write(text[start:end])
                        start = end
            if ch == "'":
                self.write("''")
                start = end + 1
            if ch is not None:
                spaces = ch == " "
                breaks = ch in _BREAKS
            end += 1
        self.write_indicator("'", False)

    def write_double_quoted(self, text: str, split: bool) -> None:
        self.write_indicator('"', True)
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if ch is None or ch in '"\\\x85\u2028\u2029\ufeff' or not "\x20" <= ch <= "\x7E":
                if start < end:
                    self.write(text[start:end])
                    start = end
                if ch is not None:
                    if ch in _DOUBLE_ESCAPES:
                        data = "\\" + _DOUBLE_ESCAPES[ch]
                    elif ch <= "\xFF":
                        data = "\\x%02X" % ord(ch)
                    elif ch <= "\uFFFF":
                        data = "\\u%04X" % ord(ch)
                    else:
                        data = "\\U%08X" % ord(ch)
                    self.write(data)
                    start = end + 1
            if (0 < end < len(text) - 1 and (ch == " " or start >= end)
                    and self.column + (end - start) > self.best_width and split):
                data = text[start:end] + "\\"
                if start < end:
                    start = end
                self.write(data)
                self.write_indent()
                self.whitespace = self.indention = False
                if text[start] == " ":
                    self.write("\\")
            end += 1
        self.write_indicator('"', False)


def safe_dump(doc: Any) -> str:
    """``yaml.safe_dump(doc, sort_keys=False)`` of a document of dicts,
    lists and scalars."""
    return _Emitter().document(doc)


def dump(doc: Any, path) -> None:
    """Write :func:`safe_dump` of ``doc`` to ``path``."""
    Path(path).write_text(safe_dump(doc))
