"""YAML as PyYAML's ``yaml.safe_load`` and ``yaml.safe_dump`` read and
write it, on the standard library alone.

The reference reads and writes its pipeline projects, handles files and
workflow descriptions with PyYAML (``yaml.safe_load``,
``yaml.safe_dump(doc, sort_keys=False)``).  The card's machine has no
``yaml``, so the port keeps this module: PyYAML 6's pure-Python path,
stage for stage (reader checks, scanner, parser, composer, resolver and
safe constructor; safe representer, serializer and emitter).

**Reading** (:func:`safe_load`, :func:`load`): every token of YAML 1.1
-- ``%YAML`` and ``%TAG`` directives, ``---`` and ``...``, block and flow
collections, ``?`` explicit keys, ``&anchors`` and ``*aliases``, tags
(``!``, ``!local``, ``!!x``, ``!h!x`` through ``%TAG``, verbatim
``!<...>``), plain, single- and double-quoted scalars, literal ``|`` and
folded ``>`` scalars with their chomping (``-``/``+``) and indentation
(1-9) indicators, and CR, LF, CRLF, NEL, LS and PS line breaks.  An alias
is the node of its anchor, so the same Python object (``&a [*a]`` is a
list that holds itself).  Plain scalars resolve as ``SafeLoader``
resolves them (YAML 1.1: ``yes``/``no``/``on``/``off`` booleans,
``~``/``null``, ``0x``/``0b``/octal/sexagesimal ints, floats that need a
dot, ``.inf``/``.nan``, dates and timestamps).  ``<<`` merges a
mapping, an alias, or a sequence of them (earlier entries and the
mapping's own keys win).  The tags ``!!str``, ``!!int``, ``!!float``,
``!!bool``, ``!!null``, ``!!timestamp``, ``!!binary`` (bytes),
``!!set`` (set), ``!!omap`` and ``!!pairs`` (lists of tuples), ``!!seq``
and ``!!map`` construct as in ``SafeConstructor``.

**Writing** (:func:`safe_dump`, :func:`dump`): the text of
``yaml.safe_dump(doc, sort_keys=False)`` (width 80, indent 2,
``allow_unicode=False``, block style) for dicts, lists, tuples (as
sequences), sets (``!!set``), str, bytes (``!!binary |``), bool, int,
float, None, dates and datetimes.  A container, date or datetime that
occurs twice, or holds itself, is written once with an ``&idNNN`` anchor
and then as ``*idNNN``, numbered as PyYAML's serializer numbers them; a
key that is a collection, spans lines or is 128 characters or longer is
written after ``? ``.

Wherever ``safe_load`` or ``safe_dump`` raises -- malformed YAML, more
than one document, an undefined or duplicate anchor, a local or unknown
tag, the ``=`` value, an unhashable key, a tag that does not fit its node
(also the plain ``ValueError`` or ``KeyError`` PyYAML lets through for
``!!int abc`` or ``!!bool x``), a type the safe representer has no rule
for -- this module raises :class:`YAMLSubsetError` naming the file (when
there is one) and the line, and nowhere else.
"""

from __future__ import annotations

import base64
import binascii
import collections.abc
import datetime
import re
from pathlib import Path
from typing import Any

from tmlibrary_tpu_torch.errors import PipelineDescriptionError


class YAMLSubsetError(PipelineDescriptionError):
    """YAML that ``yaml.safe_load`` or ``yaml.safe_dump`` refuses; the
    message names the file and the line."""


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
_TAG = "tag:yaml.org,2002:"


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


def _resolve_scalar(value: str, implicit: tuple) -> str:
    """``Resolver.resolve`` for a scalar: the full tag."""
    return _TAG + resolve(value) if implicit[0] else _TAG + "str"


# ---------------------------------------------------------------- scanner
_BREAKS = "\r\n\x85\u2028\u2029"
_EOL = "\0" + _BREAKS
_WS = "\0 \t" + _BREAKS  # PyYAML's blank-or-break-or-end set
_NON_PRINTABLE = re.compile("[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF\uE000-\uFFFD"
                            "\U00010000-\U0010ffff]")
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\x09", "\t": "\x09", "n": "\x0A",
            "v": "\x0B", "f": "\x0C", "r": "\x0D", "e": "\x1B", " ": "\x20", '"': '"',
            "\\": "\\", "/": "/", "N": "\x85", "_": "\xA0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_HEX = "0123456789ABCDEFabcdef"
_URI_CHARS = "-;/?:@&=+$,_.!~*'()[]%"

# token kinds
(STREAM_END, DIRECTIVE, DOC_START, DOC_END, BLOCK_SEQ, BLOCK_MAP, BLOCK_END, ENTRY, FLOW_SEQ,
 FLOW_SEQ_END, FLOW_MAP, FLOW_MAP_END, FLOW_ENTRY, KEY, VALUE, ALIAS, ANCHOR, TAG, SCALAR) = (
    "<stream end>", "<directive>", "<document start>", "<document end>",
    "<block sequence start>", "<block mapping start>", "<block end>", "-", "[", "]", "{", "}",
    ",", "?", ":", "<alias>", "<anchor>", "<tag>", "<scalar>")


def _word(ch: str) -> bool:
    """``0-9``, ``A-Z``, ``a-z``, ``-`` or ``_``: the characters of
    anchors, directive names and tag handles."""
    return ("0" <= ch <= "9" or "A" <= ch <= "Z" or "a" <= ch <= "z") or ch in "-_"


class _Token:
    __slots__ = ("kind", "line", "value", "plain", "style")

    def __init__(self, kind: str, line: int, value: Any = None, plain: bool = False,
                 style: "str | None" = None):
        self.kind, self.line, self.value, self.plain, self.style = kind, line, value, plain, style


class _SimpleKey:
    __slots__ = ("token_number", "required", "index", "line", "column")

    def __init__(self, token_number, required, index, line, column):
        self.token_number, self.required = token_number, required
        self.index, self.line, self.column = index, line, column


class _Scanner:
    """PyYAML's reader checks and scanner (``yaml/reader.py``,
    ``yaml/scanner.py``).  The whole text is tokenised up front; a simple
    key's ``KEY`` (and ``BLOCK_MAP``) token is inserted where the key was
    saved once its ``:`` is found, as PyYAML inserts it before handing
    the tokens on."""

    def __init__(self, text: str, name: str):
        self.name = name
        self.text = text + "\0"
        self.index = self.line = self.column = 0
        bad = _NON_PRINTABLE.search(text)
        if bad:
            self.line = len(re.findall("\r\n|[\r\n\x85\u2028\u2029]", text[:bad.start()]))
            self.fail(f"unacceptable character #x{ord(bad.group()):04x}: special characters "
                      "are not allowed")
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
        text = self.text
        for _ in range(n):
            ch = text[self.index]
            self.index += 1
            if ch in "\n\x85\u2028\u2029" or (ch == "\r" and text[self.index] != "\n"):
                self.line += 1
                self.column = 0
            elif ch != "\ufeff":
                self.column += 1

    def scan_line_break(self) -> str:
        ch = self.peek()
        if ch in "\r\n\x85":
            self.forward(2 if self.prefix(2) == "\r\n" else 1)
            return "\n"
        if ch in "\u2028\u2029":
            self.forward()
            return ch
        return ""

    def at_document_marker(self) -> bool:
        return self.prefix(3) in ("---", "...") and self.peek(3) in _WS

    # ------------------------------------------------------------ tokenise
    def scan(self) -> list[_Token]:
        while not self.done:
            self.fetch()
        return self.tokens

    def add(self, kind: str, value: Any = None) -> None:
        self.tokens.append(_Token(kind, self.line, value))

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
            self.simple_keys = {}
            self.add(STREAM_END)
            self.done = True
        elif ch == "%" and self.column == 0:
            self.unwind_indent(-1)
            self.remove_simple_key()
            self.allow_simple_key = False
            self.tokens.append(self.scan_directive())
        elif ch in "-." and self.column == 0 and self.at_document_marker():
            self.unwind_indent(-1)
            self.remove_simple_key()
            self.allow_simple_key = False
            self.add(DOC_START if ch == "-" else DOC_END)
            self.forward(3)
        elif ch in "[{":
            self.save_simple_key()
            self.flow_level += 1
            self.allow_simple_key = True
            self.add(FLOW_SEQ if ch == "[" else FLOW_MAP)
            self.forward()
        elif ch in "]}":
            self.remove_simple_key()
            self.flow_level -= 1
            self.allow_simple_key = False
            self.add(FLOW_SEQ_END if ch == "]" else FLOW_MAP_END)
            self.forward()
        elif ch == ",":
            self.allow_simple_key = True
            self.remove_simple_key()
            self.add(FLOW_ENTRY)
            self.forward()
        elif ch == "-" and nxt in _WS:
            if not self.flow_level:
                if not self.allow_simple_key:
                    self.fail("sequence entries are not allowed here")
                if self.add_indent(self.column):
                    self.add(BLOCK_SEQ)
            self.allow_simple_key = True
            self.remove_simple_key()
            self.add(ENTRY)
            self.forward()
        elif ch == "?" and (self.flow_level or nxt in _WS):
            if not self.flow_level:
                if not self.allow_simple_key:
                    self.fail("mapping keys are not allowed here")
                if self.add_indent(self.column):
                    self.add(BLOCK_MAP)
            self.allow_simple_key = not self.flow_level
            self.remove_simple_key()
            self.add(KEY)
            self.forward()
        elif ch == ":" and (self.flow_level or nxt in _WS):
            self.fetch_value()
        elif ch in "*&":
            self.save_simple_key()
            self.allow_simple_key = False
            self.tokens.append(self.scan_anchor(ALIAS if ch == "*" else ANCHOR))
        elif ch == "!":
            self.save_simple_key()
            self.allow_simple_key = False
            self.tokens.append(self.scan_tag())
        elif ch in "|>" and not self.flow_level:
            self.allow_simple_key = True
            self.remove_simple_key()
            self.tokens.append(self.scan_block_scalar(ch == ">"))
        elif ch in "'\"":
            self.save_simple_key()
            self.allow_simple_key = False
            self.tokens.append(self.scan_flow_scalar(ch == '"'))
        elif (ch not in "\0 \t\r\n\x85\u2028\u2029-?:,[]{}#&*!|>'\"%@`"
              or (nxt not in _WS and (ch == "-" or (not self.flow_level and ch in "?:")))):
            self.save_simple_key()
            self.allow_simple_key = False
            self.tokens.append(self.scan_plain())
        else:
            self.fail(f"found character {ch!r} that cannot start any token")

    def scan_to_next_token(self) -> None:
        if self.index == 0 and self.peek() == "\ufeff":
            self.forward()
        while True:
            while self.peek() == " ":
                self.forward()
            if self.peek() == "#":
                while self.peek() not in _EOL:
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
                    self.fail("could not find expected ':' after a simple key")
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
            self.fail("could not find expected ':' after a simple key")

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
                    self.add(BLOCK_MAP)
            self.allow_simple_key = not self.flow_level
            self.remove_simple_key()
        self.add(VALUE)
        self.forward()

    # ------------------------------------------------------- indentation
    def unwind_indent(self, column: int) -> None:
        if self.flow_level:
            return
        while self.indent > column:
            self.indent = self.indents.pop()
            self.add(BLOCK_END)

    def add_indent(self, column: int) -> bool:
        if self.indent < column:
            self.indents.append(self.indent)
            self.indent = column
            return True
        return False

    # --------------------------------------------------------- directives
    def scan_directive(self) -> _Token:
        line = self.line
        self.forward()
        length = 0
        while _word(self.peek(length)):
            length += 1
        if not length or self.peek(length) not in "\0 " + _BREAKS:
            self.forward(length)
            self.fail(f"while scanning a directive: expected alphabetic or numeric "
                      f"character, but found {self.peek()!r}")
        name = self.prefix(length)
        self.forward(length)
        value = None
        if name == "YAML":
            while self.peek() == " ":
                self.forward()
            major = self.scan_directive_number()
            if self.peek() != ".":
                self.fail(f"while scanning a directive: expected a digit or '.', but found "
                          f"{self.peek()!r}")
            self.forward()
            minor = self.scan_directive_number()
            if self.peek() not in "\0 " + _BREAKS:
                self.fail(f"while scanning a directive: expected a digit or ' ', but found "
                          f"{self.peek()!r}")
            value = (major, minor)
        elif name == "TAG":
            while self.peek() == " ":
                self.forward()
            handle = self.scan_tag_handle("directive")
            if self.peek() != " ":
                self.fail(f"while scanning a directive: expected ' ', but found "
                          f"{self.peek()!r}")
            while self.peek() == " ":
                self.forward()
            prefix = self.scan_tag_uri("directive")
            if self.peek() not in "\0 " + _BREAKS:
                self.fail(f"while scanning a directive: expected ' ', but found "
                          f"{self.peek()!r}")
            value = (handle, prefix)
        else:
            while self.peek() not in _EOL:
                self.forward()
        while self.peek() == " ":
            self.forward()
        if self.peek() == "#":
            while self.peek() not in _EOL:
                self.forward()
        if self.peek() not in _EOL:
            self.fail(f"while scanning a directive: expected a comment or a line break, but "
                      f"found {self.peek()!r}")
        self.scan_line_break()
        return _Token(DIRECTIVE, line, (name, value))

    def scan_directive_number(self) -> int:
        if not "0" <= self.peek() <= "9":
            self.fail(f"while scanning a directive: expected a digit, but found "
                      f"{self.peek()!r}")
        length = 0
        while "0" <= self.peek(length) <= "9":
            length += 1
        value = int(self.prefix(length))
        self.forward(length)
        return value

    # ---------------------------------------------------- anchors and tags
    def scan_anchor(self, kind: str) -> _Token:
        line = self.line
        what = "an alias" if kind == ALIAS else "an anchor"
        self.forward()
        length = 0
        while _word(self.peek(length)):
            length += 1
        if not length:
            self.fail(f"while scanning {what}: expected alphabetic or numeric character, but "
                      f"found {self.peek()!r}")
        value = self.prefix(length)
        self.forward(length)
        if self.peek() not in "\0 \t\r\n\x85\u2028\u2029?:,]}%@`":
            self.fail(f"while scanning {what}: expected alphabetic or numeric character, but "
                      f"found {self.peek()!r}")
        return _Token(kind, line, value)

    def scan_tag(self) -> _Token:
        line = self.line
        ch = self.peek(1)
        if ch == "<":
            handle = None
            self.forward(2)
            suffix = self.scan_tag_uri("tag")
            if self.peek() != ">":
                self.fail(f"while parsing a tag: expected '>', but found {self.peek()!r}")
            self.forward()
        elif ch in _WS:
            handle, suffix = None, "!"
            self.forward()
        else:
            length, use_handle = 1, False
            while ch not in "\0 " + _BREAKS:
                if ch == "!":
                    use_handle = True
                    break
                length += 1
                ch = self.peek(length)
            if use_handle:
                handle = self.scan_tag_handle("tag")
            else:
                handle = "!"
                self.forward()
            suffix = self.scan_tag_uri("tag")
        if self.peek() not in "\0 " + _BREAKS:
            self.fail(f"while scanning a tag: expected ' ', but found {self.peek()!r}")
        return _Token(TAG, line, (handle, suffix))

    def scan_tag_handle(self, name: str) -> str:
        if self.peek() != "!":
            self.fail(f"while scanning a {name}: expected '!', but found {self.peek()!r}")
        length = 1
        ch = self.peek(length)
        if ch != " ":
            while _word(ch):
                length += 1
                ch = self.peek(length)
            if ch != "!":
                self.forward(length)
                self.fail(f"while scanning a {name}: expected '!', but found {ch!r}")
            length += 1
        value = self.prefix(length)
        self.forward(length)
        return value

    def scan_tag_uri(self, name: str) -> str:
        chunks = []
        length = 0
        ch = self.peek(length)
        while ("0" <= ch <= "9" or "A" <= ch <= "Z" or "a" <= ch <= "z") or ch in _URI_CHARS:
            if ch == "%":
                chunks.append(self.prefix(length))
                self.forward(length)
                length = 0
                chunks.append(self.scan_uri_escapes(name))
            else:
                length += 1
            ch = self.peek(length)
        if length:
            chunks.append(self.prefix(length))
            self.forward(length)
        if not chunks:
            self.fail(f"while parsing a {name}: expected URI, but found {ch!r}")
        return "".join(chunks)

    def scan_uri_escapes(self, name: str) -> str:
        codes = []
        while self.peek() == "%":
            self.forward()
            for k in range(2):
                if self.peek(k) not in _HEX:
                    self.fail(f"while scanning a {name}: expected URI escape sequence of 2 "
                              f"hexadecimal numbers, but found {self.peek(k)!r}")
            codes.append(int(self.prefix(2), 16))
            self.forward(2)
        try:
            return bytes(codes).decode("utf-8")
        except UnicodeDecodeError as exc:
            self.fail(f"while scanning a {name}: {exc}")

    # ------------------------------------------------------ block scalars
    def scan_block_scalar(self, folded: bool) -> _Token:
        line = self.line
        style = ">" if folded else "|"
        chunks: list[str] = []
        self.forward()
        chomping, increment = self.scan_block_scalar_indicators()
        while self.peek() == " ":
            self.forward()
        if self.peek() == "#":
            while self.peek() not in _EOL:
                self.forward()
        if self.peek() not in _EOL:
            self.fail(f"while scanning a block scalar: expected a comment or a line break, "
                      f"but found {self.peek()!r}")
        self.scan_line_break()
        min_indent = max(self.indent + 1, 1)
        if increment is None:
            breaks, max_indent = self.scan_block_scalar_indentation()
            indent = max(min_indent, max_indent)
        else:
            indent = min_indent + increment - 1
            breaks = self.scan_block_scalar_breaks(indent)
        line_break = ""
        while self.column == indent and self.peek() != "\0":
            chunks.extend(breaks)
            leading_non_space = self.peek() not in " \t"
            length = 0
            while self.peek(length) not in _EOL:
                length += 1
            chunks.append(self.prefix(length))
            self.forward(length)
            line_break = self.scan_line_break()
            breaks = self.scan_block_scalar_breaks(indent)
            if self.column == indent and self.peek() != "\0":
                if (folded and line_break == "\n" and leading_non_space
                        and self.peek() not in " \t"):
                    if not breaks:
                        chunks.append(" ")
                else:
                    chunks.append(line_break)
            else:
                break
        if chomping is not False:
            chunks.append(line_break)
        if chomping is True:
            chunks.extend(breaks)
        return _Token(SCALAR, line, "".join(chunks), style=style)

    def scan_block_scalar_indicators(self) -> tuple:
        chomping = increment = None
        ch = self.peek()
        if ch in "+-":
            chomping = ch == "+"
            self.forward()
            ch = self.peek()
            if ch in "0123456789":
                increment = self.indentation_indicator(ch)
        elif ch in "0123456789":
            increment = self.indentation_indicator(ch)
            ch = self.peek()
            if ch in "+-":
                chomping = ch == "+"
                self.forward()
        if self.peek() not in "\0 " + _BREAKS:
            self.fail(f"while scanning a block scalar: expected chomping or indentation "
                      f"indicators, but found {self.peek()!r}")
        return chomping, increment

    def indentation_indicator(self, ch: str) -> int:
        if ch == "0":
            self.fail("while scanning a block scalar: expected indentation indicator in the "
                      "range 1-9, but found 0")
        self.forward()
        return int(ch)

    def scan_block_scalar_indentation(self) -> tuple:
        chunks, max_indent = [], 0
        while self.peek() in " " + _BREAKS:
            if self.peek() != " ":
                chunks.append(self.scan_line_break())
            else:
                self.forward()
                max_indent = max(max_indent, self.column)
        return chunks, max_indent

    def scan_block_scalar_breaks(self, indent: int) -> list:
        chunks = []
        while self.column < indent and self.peek() == " ":
            self.forward()
        while self.peek() in _BREAKS:
            chunks.append(self.scan_line_break())
            while self.column < indent and self.peek() == " ":
                self.forward()
        return chunks

    # ------------------------------------------------------- flow scalars
    def scan_flow_scalar(self, double: bool) -> _Token:
        line = self.line
        quote = self.peek()
        self.forward()
        chunks = self.scan_flow_non_spaces(double)
        while self.peek() != quote:
            chunks.extend(self.scan_flow_spaces())
            chunks.extend(self.scan_flow_non_spaces(double))
        self.forward()
        return _Token(SCALAR, line, "".join(chunks), style='"' if double else "'")

    def scan_flow_non_spaces(self, double: bool) -> list[str]:
        chunks: list[str] = []
        while True:
            length = 0
            while self.peek(length) not in "'\"\\\0 \t" + _BREAKS:
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
                    for k in range(n):
                        if self.peek(k) not in _HEX:
                            self.fail(f"while scanning a double-quoted scalar: expected escape "
                                      f"sequence of {n} hexadecimal numbers, but found "
                                      f"{self.peek(k)!r}")
                    chunks.append(chr(int(self.prefix(n), 16)))
                    self.forward(n)
                elif ch in _BREAKS:
                    self.scan_line_break()
                    chunks.extend(self.scan_flow_breaks())
                else:
                    self.fail(f"while scanning a double-quoted scalar: found unknown escape "
                              f"character {ch!r}")
            else:
                return chunks

    def scan_flow_spaces(self) -> list[str]:
        length = 0
        while self.peek(length) in " \t":
            length += 1
        whitespaces = self.prefix(length)
        self.forward(length)
        ch = self.peek()
        if ch == "\0":
            self.fail("while scanning a quoted scalar: found unexpected end of stream")
        if ch in _BREAKS:
            line_break = self.scan_line_break()
            breaks = self.scan_flow_breaks()
            chunks = []
            if line_break != "\n":
                chunks.append(line_break)
            elif not breaks:
                chunks.append(" ")
            return chunks + breaks
        return [whitespaces]

    def scan_flow_breaks(self) -> list[str]:
        chunks = []
        while True:
            if self.at_document_marker():
                self.fail("while scanning a quoted scalar: found unexpected document separator")
            while self.peek() in " \t":
                self.forward()
            if self.peek() in _BREAKS:
                chunks.append(self.scan_line_break())
            else:
                return chunks

    # ------------------------------------------------------ plain scalars
    def scan_plain(self) -> _Token:
        line = self.line
        chunks: list[str] = []
        indent = self.indent + 1
        spaces: "list[str] | None" = []
        flow_enders = _WS + (",[]{}" if self.flow_level else "")
        while True:
            length = 0
            if self.peek() == "#":
                break
            while True:
                ch = self.peek(length)
                if (ch in _WS or (ch == ":" and self.peek(length + 1) in flow_enders)
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

    def scan_plain_spaces(self) -> "list[str] | None":
        chunks: list[str] = []
        length = 0
        while self.peek(length) == " ":
            length += 1
        whitespaces = self.prefix(length)
        self.forward(length)
        if self.peek() in _BREAKS:
            line_break = self.scan_line_break()
            self.allow_simple_key = True
            if self.at_document_marker():
                return None
            breaks = []
            while self.peek() in " " + _BREAKS:
                if self.peek() == " ":
                    self.forward()
                else:
                    breaks.append(self.scan_line_break())
                    if self.at_document_marker():
                        return None
            if line_break != "\n":
                chunks.append(line_break)
            elif not breaks:
                chunks.append(" ")
            chunks.extend(breaks)
        elif whitespaces:
            chunks.append(whitespaces)
        return chunks


# ------------------------------------------------------ parser and composer
class _Node:
    """A node of the representation graph: ``kind`` is ``scalar``,
    ``sequence`` or ``mapping``; a mapping's ``value`` is a list of
    (key node, value node) pairs."""

    __slots__ = ("kind", "tag", "value", "style", "flow", "line")

    def __init__(self, kind: str, tag: str, value: Any, style: "str | None" = None,
                 flow: "bool | None" = None, line: int = 0):
        self.kind, self.tag, self.value = kind, tag, value
        self.style, self.flow, self.line = style, flow, line


_DEFAULT_TAGS = {"!": "!", "!!": _TAG}


class _Parser:
    """PyYAML's parser state machine and composer as one recursive
    descent over the tokens: it builds the nodes, resolving tags and
    aliases as it goes."""

    def __init__(self, tokens: list[_Token], scanner: _Scanner):
        self.tokens = tokens
        self.pos = 0
        self.scanner = scanner
        self.tag_handles = dict(_DEFAULT_TAGS)
        self.anchors: dict[str, _Node] = {}

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

    def empty(self) -> _Node:
        return _Node("scalar", _TAG + "null", "", line=self.peek().line)

    # ---------------------------------------------------------- documents
    def document(self) -> "_Node | None":
        """The root node of the stream's single document (None for an
        empty stream)."""
        if not self.check(DIRECTIVE, DOC_START, STREAM_END):
            node = self.node(block=True)  # an implicit document
        else:
            while self.check(DOC_END):
                self.get()
            if self.check(STREAM_END):
                return None
            self.directives()
            if not self.check(DOC_START):
                self.fail(f"expected '<document start>', but found {self.peek().kind!r}",
                          self.peek())
            self.get()
            if self.check(DIRECTIVE, DOC_START, DOC_END, STREAM_END):
                node = self.empty()
            else:
                node = self.node(block=True)
        if self.check(DOC_END):
            self.get()
        while self.check(DOC_END):
            self.get()
        if not self.check(STREAM_END):
            self.fail("expected a single document in the stream, but found another document",
                      self.peek())
        return node

    def directives(self) -> None:
        version = None
        handles: dict[str, str] = {}
        while self.check(DIRECTIVE):
            tok = self.get()
            name, value = tok.value
            if name == "YAML":
                if version is not None:
                    self.fail("found duplicate YAML directive", tok)
                if value[0] != 1:
                    self.fail("found incompatible YAML document (version 1.* is required)", tok)
                version = value
            elif name == "TAG":
                handle, prefix = value
                if handle in handles:
                    self.fail(f"duplicate tag handle {handle!r}", tok)
                handles[handle] = prefix
        self.tag_handles = {**_DEFAULT_TAGS, **handles}

    # -------------------------------------------------------------- nodes
    def node(self, block: bool = False, indentless: bool = False) -> _Node:
        tok = self.peek()
        if tok.kind == ALIAS:
            self.get()
            if tok.value not in self.anchors:
                self.fail(f"found undefined alias {tok.value!r}", tok)
            return self.anchors[tok.value]
        anchor = tag = None
        if tok.kind == ANCHOR:
            anchor = self.get().value
            if self.check(TAG):
                tag = self.get().value
        elif tok.kind == TAG:
            tag = self.get().value
            if self.check(ANCHOR):
                anchor = self.get().value
        if tag is not None:
            handle, suffix = tag
            if handle is not None:
                if handle not in self.tag_handles:
                    self.fail(f"found undefined tag handle {handle!r}", tok)
                tag = self.tag_handles[handle] + suffix
            else:
                tag = suffix
        if anchor is not None and anchor in self.anchors:
            self.fail(f"found duplicate anchor {anchor!r}", tok)
        implicit = tag is None or tag == "!"
        nxt = self.peek()
        line = nxt.line
        if indentless and nxt.kind == ENTRY:
            return self.indentless_sequence(anchor, tag if not implicit else _TAG + "seq", line)
        if nxt.kind == SCALAR:
            self.get()
            if implicit:
                flags = (True, False) if (nxt.plain or tag == "!") else (False, True)
                tag = _resolve_scalar(nxt.value, flags)
            node = _Node("scalar", tag, nxt.value, style=nxt.style, line=line)
            self.register(anchor, node)
            return node
        if nxt.kind == FLOW_SEQ:
            return self.flow_sequence(anchor, tag if not implicit else _TAG + "seq", line)
        if nxt.kind == FLOW_MAP:
            return self.flow_mapping(anchor, tag if not implicit else _TAG + "map", line)
        if block and nxt.kind == BLOCK_SEQ:
            return self.block_sequence(anchor, tag if not implicit else _TAG + "seq", line)
        if block and nxt.kind == BLOCK_MAP:
            return self.block_mapping(anchor, tag if not implicit else _TAG + "map", line)
        if anchor is not None or tag is not None:
            # an empty scalar after an anchor or a tag
            node = _Node("scalar", _resolve_scalar("", (implicit, False)) if implicit else tag,
                         "", line=line)
            self.register(anchor, node)
            return node
        self.fail(f"while parsing a {'block' if block else 'flow'} node: expected the node "
                  f"content, but found {nxt.kind!r}", nxt)

    def register(self, anchor: "str | None", node: _Node) -> None:
        if anchor is not None:
            self.anchors[anchor] = node

    def block_sequence(self, anchor, tag, line) -> _Node:
        self.get()
        node = _Node("sequence", tag, [], flow=False, line=line)
        self.register(anchor, node)
        while self.check(ENTRY):
            self.get()
            node.value.append(self.empty() if self.check(ENTRY, BLOCK_END)
                              else self.node(block=True))
        if not self.check(BLOCK_END):
            self.fail(f"while parsing a block collection: expected <block end>, but found "
                      f"{self.peek().kind!r}", self.peek())
        self.get()
        return node

    def indentless_sequence(self, anchor, tag, line) -> _Node:
        node = _Node("sequence", tag, [], flow=False, line=line)
        self.register(anchor, node)
        while self.check(ENTRY):
            self.get()
            node.value.append(self.empty() if self.check(ENTRY, KEY, VALUE, BLOCK_END)
                              else self.node(block=True))
        return node

    def block_mapping(self, anchor, tag, line) -> _Node:
        self.get()
        node = _Node("mapping", tag, [], flow=False, line=line)
        self.register(anchor, node)
        while self.check(KEY):
            self.get()
            key = (self.empty() if self.check(KEY, VALUE, BLOCK_END)
                   else self.node(block=True, indentless=True))
            if self.check(VALUE):
                self.get()
                value = (self.empty() if self.check(KEY, VALUE, BLOCK_END)
                         else self.node(block=True, indentless=True))
            else:
                value = self.empty()
            node.value.append((key, value))
        if not self.check(BLOCK_END):
            self.fail(f"while parsing a block mapping: expected <block end>, but found "
                      f"{self.peek().kind!r}", self.peek())
        self.get()
        return node

    def flow_sequence(self, anchor, tag, line) -> _Node:
        self.get()
        node = _Node("sequence", tag, [], flow=True, line=line)
        self.register(anchor, node)
        first = True
        while not self.check(FLOW_SEQ_END):
            if not first:
                if not self.check(FLOW_ENTRY):
                    self.fail(f"while parsing a flow sequence: expected ',' or ']', but got "
                              f"{self.peek().kind!r}", self.peek())
                self.get()
            first = False
            if self.check(KEY):  # a single-pair mapping
                pair_line = self.get().line
                key = (self.empty() if self.check(VALUE, FLOW_ENTRY, FLOW_SEQ_END)
                       else self.node())
                if self.check(VALUE):
                    self.get()
                    value = (self.empty() if self.check(FLOW_ENTRY, FLOW_SEQ_END)
                             else self.node())
                else:
                    value = self.empty()
                node.value.append(_Node("mapping", _TAG + "map", [(key, value)], flow=True,
                                        line=pair_line))
            elif not self.check(FLOW_SEQ_END):
                node.value.append(self.node())
        self.get()
        return node

    def flow_mapping(self, anchor, tag, line) -> _Node:
        self.get()
        node = _Node("mapping", tag, [], flow=True, line=line)
        self.register(anchor, node)
        first = True
        while not self.check(FLOW_MAP_END):
            if not first:
                if not self.check(FLOW_ENTRY):
                    self.fail(f"while parsing a flow mapping: expected ',' or '}}', but got "
                              f"{self.peek().kind!r}", self.peek())
                self.get()
            first = False
            if self.check(KEY):
                self.get()
                key = (self.empty() if self.check(VALUE, FLOW_ENTRY, FLOW_MAP_END)
                       else self.node())
                if self.check(VALUE):
                    self.get()
                    value = (self.empty() if self.check(FLOW_ENTRY, FLOW_MAP_END)
                             else self.node())
                else:
                    value = self.empty()
                node.value.append((key, value))
            elif not self.check(FLOW_MAP_END):
                key = self.node()
                node.value.append((key, self.empty()))
        self.get()
        return node


# ------------------------------------------------------------ constructor
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

_INF = 1e300
while _INF != _INF * _INF:
    _INF *= _INF
_NAN = -_INF / _INF
_BOOL_VALUES = {"yes": True, "no": False, "true": True, "false": False, "on": True,
                "off": False}


class _ConstructorError(Exception):
    """PyYAML's ``ConstructorError``, with the node it names."""

    def __init__(self, message: str, node: _Node):
        super().__init__(message)
        self.node = node


class _Constructor:
    """PyYAML's ``SafeConstructor``: collections are built in two steps
    (the empty container first, filled later or at once when the
    construction is deep), so aliases that close a cycle get the
    container itself."""

    def __init__(self):
        self.constructed: dict = {}
        self.recursive: set = set()
        self.generators: list = []
        self.deep = False
        self.current: "_Node | None" = None

    def document(self, node: _Node) -> Any:
        data = self.object(node)
        while self.generators:
            generators, self.generators = self.generators, []
            for gen in generators:
                for _ in gen:
                    pass
        return data

    def object(self, node: _Node, deep: bool = False) -> Any:
        if node in self.constructed:
            return self.constructed[node]
        if deep:
            old_deep, self.deep = self.deep, True
        if node in self.recursive:
            raise _ConstructorError("found unconstructable recursive node", node)
        self.recursive.add(node)
        self.current = node
        build = _CONSTRUCTORS.get(node.tag, _Constructor.undefined)
        data = build(self, node)
        if isinstance(data, collections.abc.Generator):
            gen = data
            data = next(gen)
            if self.deep:
                for _ in gen:
                    pass
            else:
                self.generators.append(gen)
        self.constructed[node] = data
        self.recursive.discard(node)
        if deep:
            self.deep = old_deep
        return data

    # ---------------------------------------------------------- scalars
    def scalar(self, node: _Node) -> str:
        if node.kind == "mapping":
            for key_node, value_node in node.value:
                if key_node.tag == _TAG + "value":
                    return self.scalar(value_node)
        if node.kind != "scalar":
            raise _ConstructorError(f"expected a scalar node, but found {node.kind}", node)
        return node.value

    def yaml_null(self, node: _Node) -> None:
        self.scalar(node)

    def yaml_bool(self, node: _Node) -> bool:
        return _BOOL_VALUES[self.scalar(node).lower()]

    def yaml_int(self, node: _Node) -> int:
        value = self.scalar(node).replace("_", "")
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
            total, base = 0, 1
            for digit in reversed([int(part) for part in value.split(":")]):
                total += digit * base
                base *= 60
            return sign * total
        return sign * int(value)

    def yaml_float(self, node: _Node) -> float:
        value = self.scalar(node).replace("_", "").lower()
        sign = -1 if value[0] == "-" else 1
        if value[0] in "+-":
            value = value[1:]
        if value == ".inf":
            return sign * _INF
        if value == ".nan":
            return _NAN
        if ":" in value:
            total, base = 0.0, 1
            for digit in reversed([float(part) for part in value.split(":")]):
                total += digit * base
                base *= 60
            return sign * total
        return sign * float(value)

    def yaml_binary(self, node: _Node) -> bytes:
        try:
            value = self.scalar(node).encode("ascii")
        except UnicodeEncodeError as exc:
            raise _ConstructorError(f"failed to convert base64 data into ascii: {exc}", node)
        try:
            return base64.decodebytes(value)
        except binascii.Error as exc:
            raise _ConstructorError(f"failed to decode base64 data: {exc}", node)

    def yaml_timestamp(self, node: _Node):
        self.scalar(node)
        v = _TIMESTAMP_PARTS.match(node.value).groupdict()
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

    def yaml_str(self, node: _Node) -> str:
        return self.scalar(node)

    def undefined(self, node: _Node):
        raise _ConstructorError(f"could not determine a constructor for the tag {node.tag!r}",
                                node)

    # ------------------------------------------------------ collections
    def sequence(self, node: _Node) -> list:
        if node.kind != "sequence":
            raise _ConstructorError(f"expected a sequence node, but found {node.kind}", node)
        return [self.object(child) for child in node.value]

    def flatten(self, node: _Node) -> None:
        """``SafeConstructor.flatten_mapping``: ``<<`` keys replaced by
        the pairs they merge, in place (an aliased mapping is flattened
        once for all its uses)."""
        merge = []
        index = 0
        while index < len(node.value):
            key_node, value_node = node.value[index]
            if key_node.tag == _TAG + "merge":
                del node.value[index]
                if value_node.kind == "mapping":
                    self.flatten(value_node)
                    merge.extend(value_node.value)
                elif value_node.kind == "sequence":
                    submerge = []
                    for sub in value_node.value:
                        if sub.kind != "mapping":
                            raise _ConstructorError(f"while constructing a mapping: expected "
                                                    f"a mapping for merging, but found "
                                                    f"{sub.kind}", sub)
                        self.flatten(sub)
                        submerge.append(sub.value)
                    for value in reversed(submerge):
                        merge.extend(value)
                else:
                    raise _ConstructorError(f"while constructing a mapping: expected a mapping "
                                            f"or list of mappings for merging, but found "
                                            f"{value_node.kind}", value_node)
            else:
                if key_node.tag == _TAG + "value":
                    key_node.tag = _TAG + "str"
                index += 1
        if merge:
            node.value = merge + node.value

    def mapping(self, node: _Node) -> dict:
        if node.kind == "mapping":
            self.flatten(node)
        if node.kind != "mapping":
            raise _ConstructorError(f"expected a mapping node, but found {node.kind}", node)
        out = {}
        for key_node, value_node in node.value:
            key = self.object(key_node)
            if not isinstance(key, collections.abc.Hashable):
                raise _ConstructorError("while constructing a mapping: found unhashable key",
                                        key_node)
            out[key] = self.object(value_node)
        return out

    def yaml_seq(self, node: _Node):
        data: list = []
        yield data
        data.extend(self.sequence(node))

    def yaml_map(self, node: _Node):
        data: dict = {}
        yield data
        data.update(self.mapping(node))

    def yaml_set(self, node: _Node):
        data: set = set()
        yield data
        data.update(self.mapping(node))

    def yaml_pairs(self, node: _Node, what: str = "pairs"):
        """``!!pairs`` and ``!!omap``: a list of (key, value) tuples."""
        data: list = []
        yield data
        if node.kind != "sequence":
            raise _ConstructorError(f"while constructing {what}: expected a sequence, but "
                                    f"found {node.kind}", node)
        for sub in node.value:
            if sub.kind != "mapping":
                raise _ConstructorError(f"while constructing {what}: expected a mapping of "
                                        f"length 1, but found {sub.kind}", sub)
            if len(sub.value) != 1:
                raise _ConstructorError(f"while constructing {what}: expected a single mapping "
                                        f"item, but found {len(sub.value)} items", sub)
            key_node, value_node = sub.value[0]
            data.append((self.object(key_node), self.object(value_node)))

    def yaml_omap(self, node: _Node):
        return self.yaml_pairs(node, "an ordered map")


_CONSTRUCTORS = {_TAG + name: getattr(_Constructor, "yaml_" + name)
                 for name in ("null", "bool", "int", "float", "binary", "timestamp", "omap",
                              "pairs", "set", "str", "seq", "map")}

#: what PyYAML's constructors let through unwrapped (``!!int abc`` is a
#: ValueError, ``!!bool x`` a KeyError, ``!!timestamp x`` an
#: AttributeError), and a document nested past Python's recursion limit
_CONSTRUCTION_ERRORS = (ValueError, KeyError, AttributeError, TypeError, IndexError,
                        OverflowError, RecursionError)


def safe_load(text: str, name: str = "") -> Any:
    """The single document of ``text`` as ``yaml.safe_load`` builds it
    (``name`` is put in error messages)."""
    scanner = _Scanner(text, name)
    try:
        root = _Parser(scanner.scan(), scanner).document()
    except RecursionError:
        scanner.fail("the document nests too deeply")
    if root is None:
        return None
    constructor = _Constructor()
    try:
        return constructor.document(root)
    except _ConstructorError as exc:
        scanner.line = exc.node.line
        scanner.fail(str(exc))
    except _CONSTRUCTION_ERRORS as exc:
        scanner.line = constructor.current.line if constructor.current else 0
        scanner.fail(f"{type(exc).__name__}: {exc}")


def load(path) -> Any:
    """:func:`safe_load` of a file."""
    path = Path(path)
    return safe_load(path.read_text(), name=str(path))


# ------------------------------------------------------------ representer
def _ignore_aliases(data: Any) -> bool:
    """``SafeRepresenter.ignore_aliases``: values never anchored."""
    return (data is None or (isinstance(data, tuple) and data == ())
            or isinstance(data, (str, bytes, bool, int, float)))


def _float_text(value: float) -> str:
    if value != value:
        return ".nan"
    if value == _INF:
        return ".inf"
    if value == -_INF:
        return "-.inf"
    text = repr(value).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


class _Representer:
    """PyYAML's ``SafeRepresenter`` with ``default_flow_style=False`` and
    ``sort_keys=False``: data to nodes, one node for each object that is
    not a str, bytes, bool, int, float, None or ``()``."""

    def __init__(self):
        self.represented: dict[int, _Node] = {}
        self.keeper: list = []  # holds every object whose id keys a node

    def node(self, data: Any) -> _Node:
        alias_key = None if _ignore_aliases(data) else id(data)
        if alias_key is not None:
            if alias_key in self.represented:
                return self.represented[alias_key]
            self.keeper.append(data)
        kind = type(data)
        if kind is type(None):
            return self.scalar("null", "null", alias_key)
        if kind is str:
            return self.scalar("str", data, alias_key)
        if kind is bytes:
            return self.scalar("binary", base64.encodebytes(data).decode("ascii"), alias_key,
                               style="|")
        if kind is bool:
            return self.scalar("bool", "true" if data else "false", alias_key)
        if kind is int:
            return self.scalar("int", str(data), alias_key)
        if kind is float:
            return self.scalar("float", _float_text(data), alias_key)
        if kind is datetime.date:
            return self.scalar("timestamp", data.isoformat(), alias_key)
        if kind is datetime.datetime:
            return self.scalar("timestamp", data.isoformat(" "), alias_key)
        if kind in (list, tuple):
            node = self.register(_Node("sequence", _TAG + "seq", [], flow=False), alias_key)
            node.value.extend(self.node(item) for item in data)
            return node
        if kind in (dict, set):
            tag = _TAG + ("map" if kind is dict else "set")
            node = self.register(_Node("mapping", tag, [], flow=False), alias_key)
            items = data.items() if kind is dict else ((key, None) for key in data)
            for key, value in items:
                node.value.append((self.node(key), self.node(value)))
            return node
        raise YAMLSubsetError(f"cannot represent an object: {data!r} (a {kind.__name__}; "
                              "the safe representer takes dicts, lists, tuples, sets, str, "
                              "bytes, bool, int, float, None, dates and datetimes)")

    def register(self, node: _Node, alias_key: "int | None") -> _Node:
        if alias_key is not None:
            self.represented[alias_key] = node
        return node

    def scalar(self, tag: str, value: str, alias_key, style=None) -> _Node:
        return self.register(_Node("scalar", _TAG + tag, value, style=style), alias_key)


# ------------------------------------------------------------- serializer
class _Event:
    """An emitter event: ``kind`` is ``scalar``, ``alias``,
    ``sequence``/``mapping`` (starts), ``end``, ``document_end`` or
    ``stream_end``."""

    __slots__ = ("kind", "anchor", "tag", "implicit", "value", "style", "flow")

    def __init__(self, kind, anchor=None, tag=None, implicit=None, value=None, style=None,
                 flow=None):
        self.kind, self.anchor, self.tag, self.implicit = kind, anchor, tag, implicit
        self.value, self.style, self.flow = value, style, flow


def _serialize(root: _Node) -> list[_Event]:
    """PyYAML's ``Serializer``: nodes met twice get anchors ``id001``,
    ``id002``, ... in the order of their second meeting."""
    anchors: dict[_Node, "str | None"] = {}
    count = [0]

    def anchor(node: _Node) -> None:
        if node in anchors:
            if anchors[node] is None:
                count[0] += 1
                anchors[node] = f"id{count[0]:03d}"
            return
        anchors[node] = None
        if node.kind == "sequence":
            for item in node.value:
                anchor(item)
        elif node.kind == "mapping":
            for key, value in node.value:
                anchor(key)
                anchor(value)

    anchor(root)
    events: list[_Event] = []
    done: set = set()

    def serialize(node: _Node) -> None:
        alias = anchors[node]
        if node in done:
            events.append(_Event("alias", alias))
            return
        done.add(node)
        if node.kind == "scalar":
            implicit = (node.tag == _resolve_scalar(node.value, (True, False)),
                        node.tag == _TAG + "str")
            events.append(_Event("scalar", alias, node.tag, implicit, node.value, node.style))
        elif node.kind == "sequence":
            events.append(_Event("sequence", alias, node.tag, node.tag == _TAG + "seq",
                                 flow=node.flow))
            for item in node.value:
                serialize(item)
            events.append(_Event("end"))
        else:
            events.append(_Event("mapping", alias, node.tag, node.tag == _TAG + "map",
                                 flow=node.flow))
            for key, value in node.value:
                serialize(key)
                serialize(value)
            events.append(_Event("end"))

    serialize(root)
    return events + [_Event("document_end"), _Event("stream_end")]


# ---------------------------------------------------------------- emitter
class _Analysis:
    __slots__ = ("scalar", "empty", "multiline", "flow_plain", "block_plain", "single_quoted",
                 "block")

    def __init__(self, scalar, empty, multiline, flow_plain, block_plain, single_quoted, block):
        self.scalar, self.empty, self.multiline = scalar, empty, multiline
        self.flow_plain, self.block_plain = flow_plain, block_plain
        self.single_quoted, self.block = single_quoted, block


_LINE_BREAKS = "\n\x85\u2028\u2029"
_SPACE_BREAK = "\0 \t\r\n\x85\u2028\u2029"


def _analyze(scalar: str) -> _Analysis:
    """PyYAML's ``Emitter.analyze_scalar`` with ``allow_unicode=False``."""
    if not scalar:
        return _Analysis(scalar, True, False, False, True, True, False)
    block_indicators = flow_indicators = line_breaks = special = False
    leading_space = leading_break = trailing_space = trailing_break = False
    break_space = space_break = False
    if scalar.startswith("---") or scalar.startswith("..."):
        block_indicators = flow_indicators = True
    preceded_by_ws = True
    followed_by_ws = len(scalar) == 1 or scalar[1] in _SPACE_BREAK
    previous_space = previous_break = False
    n = len(scalar)
    for index, ch in enumerate(scalar):
        if index == 0:
            if ch in "#,[]{}&*!|>'\"%@`":
                flow_indicators = block_indicators = True
            if ch in "?:":
                flow_indicators = True
                if followed_by_ws:
                    block_indicators = True
            if ch == "-" and followed_by_ws:
                flow_indicators = block_indicators = True
        else:
            if ch in ",?[]{}":
                flow_indicators = True
            if ch == ":":
                flow_indicators = True
                if followed_by_ws:
                    block_indicators = True
            if ch == "#" and preceded_by_ws:
                flow_indicators = block_indicators = True
        if ch in _LINE_BREAKS:
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
        elif ch in _LINE_BREAKS:
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
    flow_plain = block_plain = single_quoted = block = True
    if leading_space or leading_break or trailing_space or trailing_break:
        flow_plain = block_plain = False
    if trailing_space:
        block = False
    if break_space:
        flow_plain = block_plain = single_quoted = False
    if space_break or special:
        flow_plain = block_plain = single_quoted = block = False
    if line_breaks:
        flow_plain = block_plain = False
    if flow_indicators:
        flow_plain = False
    if block_indicators:
        block_plain = False
    return _Analysis(scalar, False, line_breaks, flow_plain, block_plain, single_quoted, block)


_DOUBLE_ESCAPES = {"\0": "0", "\x07": "a", "\x08": "b", "\x09": "t", "\x0A": "n",
                   "\x0B": "v", "\x0C": "f", "\x0D": "r", "\x1B": "e", '"': '"', "\\": "\\",
                   "\x85": "N", "\xA0": "_", "\u2028": "L", "\u2029": "P"}


def _prepare_tag(tag: str) -> str:
    """``Emitter.prepare_tag`` with PyYAML's default tag prefixes."""
    if tag == "!":
        return tag
    handle, suffix = None, tag
    for prefix, name in (("!", "!"), (_TAG, "!!")):
        if tag.startswith(prefix) and (prefix == "!" or len(prefix) < len(tag)):
            handle, suffix = name, tag[len(prefix):]
    chunks = []
    for ch in suffix:
        if (("0" <= ch <= "9" or "A" <= ch <= "Z" or "a" <= ch <= "z")
                or ch in "-;/?:@&=+$,_.~*'()[]" or (ch == "!" and handle != "!")):
            chunks.append(ch)
        else:
            chunks.extend("%%%02X" % b for b in ch.encode("utf-8"))
    text = "".join(chunks)
    return f"{handle}{text}" if handle else f"!<{text}>"


class _Emitter:
    """PyYAML's ``Emitter`` with default settings: the same state
    machine over the serializer's events, so the same text."""

    best_width = 80
    best_indent = 2

    def __init__(self, events: list[_Event]):
        self.events = events
        self.at = 0
        self.event: "_Event | None" = None
        self.out: list[str] = []
        self.states: list = []
        self.state = self.expect_document_root
        self.indents: list = []
        self.indent: "int | None" = None
        self.flow_level = 0
        self.root = self.mapping_context = self.simple_key = False
        self.column = 0
        self.whitespace = self.indention = True
        self.open_ended = False
        self.analysis: "_Analysis | None" = None
        self.style: "str | None" = None

    def run(self) -> str:
        while self.at < len(self.events):
            self.event = self.events[self.at]
            self.at += 1
            self.state()
        return "".join(self.out)

    def next_kind(self) -> "str | None":
        return self.events[self.at].kind if self.at < len(self.events) else None

    # ------------------------------------------------------- documents
    def expect_document_root(self) -> None:
        self.states.append(self.expect_document_end)
        self.expect_node(root=True)

    def expect_document_end(self) -> None:
        self.write_indent()
        self.state = self.expect_stream_end

    def expect_stream_end(self) -> None:
        if self.open_ended:
            self.write_indicator("...", True)
            self.write_indent()
        self.state = None

    # ----------------------------------------------------------- nodes
    def expect_node(self, root=False, mapping=False, simple_key=False) -> None:
        self.root, self.mapping_context, self.simple_key = root, mapping, simple_key
        ev = self.event
        if ev.kind == "alias":
            self.write_indicator("*" + ev.anchor, True)
            self.state = self.states.pop()
            return
        if ev.anchor is not None:
            self.write_indicator("&" + ev.anchor, True)
        self.process_tag()
        if ev.kind == "scalar":
            self.increase_indent(flow=True)
            self.process_scalar()
            self.indent = self.indents.pop()
            self.state = self.states.pop()
        elif ev.kind == "sequence":
            if self.flow_level or ev.flow or self.next_kind() == "end":
                self.write_indicator("[", True, whitespace=True)
                self.flow_level += 1
                self.increase_indent(flow=True)
                self.state = self.expect_first_flow_sequence_item
            else:
                self.increase_indent(flow=False,
                                     indentless=self.mapping_context and not self.indention)
                self.state = self.expect_first_block_sequence_item
        else:
            if self.flow_level or ev.flow or self.next_kind() == "end":
                self.write_indicator("{", True, whitespace=True)
                self.flow_level += 1
                self.increase_indent(flow=True)
                self.state = self.expect_first_flow_mapping_key
            else:
                self.increase_indent(flow=False)
                self.state = self.expect_first_block_mapping_key

    def increase_indent(self, flow: bool = False, indentless: bool = False) -> None:
        self.indents.append(self.indent)
        if self.indent is None:
            self.indent = self.best_indent if flow else 0
        elif not indentless:
            self.indent += self.best_indent

    # ------------------------------------------------ flow collections
    def flow_end(self, indicator: str) -> None:
        self.indent = self.indents.pop()
        self.flow_level -= 1
        self.write_indicator(indicator, False)
        self.state = self.states.pop()

    def expect_first_flow_sequence_item(self) -> None:
        self.expect_flow_sequence_item(first=True)

    def expect_flow_sequence_item(self, first: bool = False) -> None:
        if self.event.kind == "end":
            self.flow_end("]")
            return
        if not first:
            self.write_indicator(",", False)
        if self.column > self.best_width:
            self.write_indent()
        self.states.append(self.expect_flow_sequence_item)
        self.expect_node()

    def expect_first_flow_mapping_key(self) -> None:
        self.expect_flow_mapping_key(first=True)

    def expect_flow_mapping_key(self, first: bool = False) -> None:
        if self.event.kind == "end":
            self.flow_end("}")
            return
        if not first:
            self.write_indicator(",", False)
        if self.column > self.best_width:
            self.write_indent()
        if self.check_simple_key():
            self.states.append(self.expect_flow_mapping_simple_value)
            self.expect_node(mapping=True, simple_key=True)
        else:
            self.write_indicator("?", True)
            self.states.append(self.expect_flow_mapping_value)
            self.expect_node(mapping=True)

    def expect_flow_mapping_simple_value(self) -> None:
        self.write_indicator(":", False)
        self.states.append(self.expect_flow_mapping_key)
        self.expect_node(mapping=True)

    def expect_flow_mapping_value(self) -> None:
        if self.column > self.best_width:
            self.write_indent()
        self.write_indicator(":", True)
        self.states.append(self.expect_flow_mapping_key)
        self.expect_node(mapping=True)

    # ----------------------------------------------- block collections
    def expect_first_block_sequence_item(self) -> None:
        self.expect_block_sequence_item(first=True)

    def expect_block_sequence_item(self, first: bool = False) -> None:
        if not first and self.event.kind == "end":
            self.indent = self.indents.pop()
            self.state = self.states.pop()
            return
        self.write_indent()
        self.write_indicator("-", True, indention=True)
        self.states.append(self.expect_block_sequence_item)
        self.expect_node()

    def expect_first_block_mapping_key(self) -> None:
        self.expect_block_mapping_key(first=True)

    def expect_block_mapping_key(self, first: bool = False) -> None:
        if not first and self.event.kind == "end":
            self.indent = self.indents.pop()
            self.state = self.states.pop()
            return
        self.write_indent()
        if self.check_simple_key():
            self.states.append(self.expect_block_mapping_simple_value)
            self.expect_node(mapping=True, simple_key=True)
        else:
            self.write_indicator("?", True, indention=True)
            self.states.append(self.expect_block_mapping_value)
            self.expect_node(mapping=True)

    def expect_block_mapping_simple_value(self) -> None:
        self.write_indicator(":", False)
        self.states.append(self.expect_block_mapping_key)
        self.expect_node(mapping=True)

    def expect_block_mapping_value(self) -> None:
        self.write_indent()
        self.write_indicator(":", True, indention=True)
        self.states.append(self.expect_block_mapping_key)
        self.expect_node(mapping=True)

    def check_simple_key(self) -> bool:
        ev = self.event
        length = len(ev.anchor) if ev.anchor is not None else 0
        if ev.kind in ("scalar", "sequence", "mapping") and ev.tag is not None:
            length += len(_prepare_tag(ev.tag))
        if ev.kind == "scalar":
            if self.analysis is None:
                self.analysis = _analyze(ev.value)
            length += len(self.analysis.scalar)
        return length < 128 and (
            ev.kind == "alias"
            or (ev.kind == "scalar" and not self.analysis.empty and not self.analysis.multiline)
            or (ev.kind in ("sequence", "mapping") and self.next_kind() == "end"))

    # ----------------------------------------------------------- tags
    def process_tag(self) -> None:
        ev = self.event
        tag = ev.tag
        if ev.kind == "scalar":
            if self.style is None:
                self.style = self.choose_scalar_style()
            if (self.style == "" and ev.implicit[0]) or (self.style != "" and ev.implicit[1]):
                return
        elif ev.implicit:
            return
        text = _prepare_tag(tag)
        if text:
            self.write_indicator(text, True)

    # -------------------------------------------------------- scalars
    def choose_scalar_style(self) -> str:
        ev = self.event
        if self.analysis is None:
            self.analysis = _analyze(ev.value)
        a = self.analysis
        if ev.style == '"':
            return '"'
        if not ev.style and ev.implicit[0]:
            if (not (self.simple_key and (a.empty or a.multiline))
                    and ((self.flow_level and a.flow_plain)
                         or (not self.flow_level and a.block_plain))):
                return ""
        if ev.style and ev.style in "|>":
            if not self.flow_level and not self.simple_key and a.block:
                return ev.style
        if not ev.style or ev.style == "'":
            if a.single_quoted and not (self.simple_key and a.multiline):
                return "'"
        return '"'

    def process_scalar(self) -> None:
        if self.analysis is None:
            self.analysis = _analyze(self.event.value)
        if self.style is None:
            self.style = self.choose_scalar_style()
        split = not self.simple_key
        text = self.analysis.scalar
        if self.style == '"':
            self.write_double_quoted(text, split)
        elif self.style == "'":
            self.write_single_quoted(text, split)
        elif self.style == "|":
            self.write_literal(text)
        else:  # the representer asks for no folded scalars
            self.write_plain(text, split)
        self.analysis = None
        self.style = None

    # -------------------------------------------------------- writing
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
                if ch is None or ch not in _LINE_BREAKS:
                    if text[start] == "\n":
                        self.write_line_break()
                    for br in text[start:end]:
                        self.write_line_break(br)
                    self.write_indent()
                    self.whitespace = self.indention = False
                    start = end
            else:
                if ch is None or ch in " " + _LINE_BREAKS:
                    self.write(text[start:end])
                    start = end
            if ch is not None:
                spaces = ch == " "
                breaks = ch in _LINE_BREAKS
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
                if ch is None or ch not in _LINE_BREAKS:
                    if text[start] == "\n":
                        self.write_line_break()
                    for br in text[start:end]:
                        self.write_line_break(br)
                    self.write_indent()
                    start = end
            else:
                if ch is None or ch in " " + _LINE_BREAKS or ch == "'":
                    if start < end:
                        self.write(text[start:end])
                        start = end
            if ch == "'":
                self.write("''")
                start = end + 1
            if ch is not None:
                spaces = ch == " "
                breaks = ch in _LINE_BREAKS
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

    def write_literal(self, text: str) -> None:
        hints = ""
        if text:
            if text[0] in " " + _LINE_BREAKS:
                hints += str(self.best_indent)
            if text[-1] not in _LINE_BREAKS:
                hints += "-"
            elif len(text) == 1 or text[-2] in _LINE_BREAKS:
                hints += "+"
        self.write_indicator("|" + hints, True)
        if hints[-1:] == "+":
            self.open_ended = True
        self.write_line_break()
        breaks = True
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if breaks:
                if ch is None or ch not in _LINE_BREAKS:
                    for br in text[start:end]:
                        self.write_line_break(br)
                    if ch is not None:
                        self.write_indent()
                    start = end
            else:
                if ch is None or ch in _LINE_BREAKS:
                    self.out.append(text[start:end])  # PyYAML does not count these columns
                    if ch is None:
                        self.write_line_break()
                    start = end
            if ch is not None:
                breaks = ch in _LINE_BREAKS
            end += 1


def safe_dump(doc: Any) -> str:
    """``yaml.safe_dump(doc, sort_keys=False)``."""
    try:
        return _Emitter(_serialize(_Representer().node(doc))).run()
    except RecursionError:
        raise YAMLSubsetError("the document nests too deeply to write") from None


def dump(doc: Any, path) -> None:
    """Write :func:`safe_dump` of ``doc`` to ``path``."""
    Path(path).write_text(safe_dump(doc))
