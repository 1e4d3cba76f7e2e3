"""A reader for the YAML subset of training configs, in plain Python.

The card has no PyYAML, and the port may not need it, so the configs
(``configs/*.yaml`` and the reference's threestudio YAMLs) are read here.
What it reads:

- block mappings by indentation, including a block sequence at the same
  indentation as its key;
- block sequences (``- x``), whose items may be scalars, flow collections,
  nested sequences or mappings;
- flow sequences and flow mappings (``[0, 0.75, 0.25, 2000]``, ``{a: 1}``),
  nested, over one or more lines;
- plain, single-quoted and double-quoted scalars, and comments.

Plain scalars resolve as PyYAML's ``SafeLoader`` (YAML 1.1) resolves them:
``1e-4`` stays a string (a float needs a dot; an exponent needs a sign),
``0.0001`` and ``1.0e-4`` are floats, ``yes``/``no``/``on``/``off``/
``true``/``false`` are booleans, ``~``, ``null`` and an empty value are
None, ``1_000`` is 1000, ``017`` is octal and ``1:30`` is 90.  ``???`` and
OmegaConf's ``${...}`` interpolations stay strings.

Everything else raises ``ValueError`` naming the line: anchors and
aliases, tags, block scalars (``|``, ``>``), directives, a second
document, explicit (``?``) and complex keys, merge keys, timestamps,
tabs in indentation and plain scalars continued over several lines.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

__all__ = ["load", "load_file"]

_BOOL = {
    **dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
    **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False),
}
_NULL = ("~", "null", "Null", "NULL", "")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
    (?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# Characters that may not start a plain scalar, and what they would start.
_REFUSED_START = {"&": "an anchor", "*": "an alias", "!": "a tag", "|": "a block scalar",
                  ">": "a block scalar", "%": "a directive", "@": "a reserved indicator",
                  "`": "a reserved indicator"}


def _fail(lineno: int, msg: str):
    raise ValueError(f"YAML line {lineno}: {msg}")


def _sexagesimal(digits: str) -> float:
    value = 0
    for part in digits.split(":"):
        value = value * 60 + float(part)
    return value


def _resolve_plain(text: str, lineno: int = 0) -> Any:
    """The value of a plain scalar, as PyYAML's SafeLoader resolves it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * int(_sexagesimal(v))
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _sexagesimal(v)
        return sign * float(v)
    if _TIMESTAMP.match(text):
        _fail(lineno, f"timestamp {text!r}")
    if text == "<<":
        _fail(lineno, "merge key '<<'")
    if text == "=":
        _fail(lineno, "value key '='")
    return text


def _strip_comment(text: str, lineno: int) -> str:
    """``text`` without its comment: a '#' at the start or after white space,
    outside a quoted scalar.  A quote opens a scalar only where a scalar
    may start (line start, or after ``: ``, ``- ``, ``[``, ``{``, ``,``)."""
    i, n = 0, len(text)
    prev = ""  # last non-space character before i
    while i < n:
        c = text[i]
        if c in "'\"" and prev in ("", ":", "-", "[", "{", ",", "?"):
            i = _skip_quoted(text, i, lineno)
            prev = c
            continue
        if c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        if not c.isspace():
            prev = c
        i += 1
    return text.rstrip()


def _skip_quoted(text: str, i: int, lineno: int) -> int:
    """Index just past the quoted scalar that starts at ``text[i]``."""
    q, j, n = text[i], i + 1, len(text)
    while j < n:
        if q == "'" and text[j] == "'":
            if j + 1 < n and text[j + 1] == "'":
                j += 2
                continue
            return j + 1
        if q == '"' and text[j] == "\\":
            j += 2
            continue
        if q == '"' and text[j] == '"':
            return j + 1
        j += 1
    _fail(lineno, "a quoted scalar continued over several lines")


def _quoted(text: str, i: int, lineno: int) -> Tuple[str, int]:
    """The quoted scalar at ``text[i]`` and the index past it."""
    end = _skip_quoted(text, i, lineno)
    body = text[i + 1:end - 1]
    if text[i] == "'":
        return body.replace("''", "'"), end
    out, j = [], 0
    while j < len(body):
        c = body[j]
        if c != "\\":
            out.append(c)
            j += 1
            continue
        e = body[j + 1] if j + 1 < len(body) else ""
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            j += 2
        elif e in _HEX_ESCAPES:
            k = _HEX_ESCAPES[e]
            code = body[j + 2:j + 2 + k]
            if len(code) != k or not all(ch in "0123456789abcdefABCDEF" for ch in code):
                _fail(lineno, f"bad escape \\{e}{code}")
            out.append(chr(int(code, 16)))
            j += 2 + k
        else:
            _fail(lineno, f"unknown escape \\{e}")
    return "".join(out), end


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text = no, indent, text


def _lines(source: str) -> List[_Line]:
    """The document's non-empty lines, comments stripped; checks the
    document markers and directives."""
    out, started, ended = [], False, False
    for no, raw in enumerate(source.splitlines(), start=1):
        body = raw.lstrip(" ")
        if not body.strip():
            continue
        if body.startswith("\t"):
            _fail(no, "a tab in the indentation")
        text = _strip_comment(body, no)
        if not text:
            continue
        indent = len(raw) - len(body)
        if indent == 0 and text.startswith("%"):
            _fail(no, "a directive")
        if indent == 0 and (text == "---" or text.startswith("--- ")):
            if started or out:
                _fail(no, "a second document")
            if text != "---":
                _fail(no, "content on the document-start line")
            started = True
            continue
        elif indent == 0 and (text == "..." or text.startswith("... ")):
            ended = True
            continue
        if ended:
            _fail(no, "content after the document end '...'")
        out.append(_Line(no, indent, text))
    return out


def _key_split(text: str, lineno: int):
    """``(key, rest)`` when ``text`` is a mapping entry ``key: rest``,
    else None."""
    if text.startswith("? ") or text == "?":
        _fail(lineno, "an explicit key '?'")
    if text[0] in "'\"":
        key, end = _quoted(text, 0, lineno)
        rest = text[end:].lstrip()
        return (key, rest[1:].strip()) if rest.startswith(":") else None
    m = re.search(r":(?:\s|$)", text)
    if m is None:
        return None
    raw = text[:m.start()].rstrip()
    if raw and raw[0] in "[{":
        if _flow_closes_before(text, m.start()):
            _fail(lineno, "a flow collection as a key")
        return None
    if raw and raw[0] in _REFUSED_START:
        _fail(lineno, _REFUSED_START[raw[0]])
    return _resolve_plain(raw, lineno), text[m.end():].strip()


def _is_item(text: str) -> bool:
    """A block sequence entry: ``-`` alone or followed by a space."""
    return text == "-" or text.startswith("- ")


def _flow_closes_before(text: str, pos: int) -> bool:
    depth = 0
    for c in text[:pos]:
        depth += c in "[{"
        depth -= c in "]}"
    return depth == 0


class _Parser:
    def __init__(self, source: str):
        self.lines = _lines(source)

    def parse(self) -> Any:
        if not self.lines:
            return None
        value, i = self.block(0, self.lines[0].indent)
        if i < len(self.lines):
            line = self.lines[i]
            _fail(line.no, f"unexpected indentation or content {line.text!r}")
        return value

    # -- block context
    def block(self, i: int, indent: int) -> Tuple[Any, int]:
        line = self.lines[i]
        if _is_item(line.text):
            return self.sequence(i, indent)
        if _key_split(line.text, line.no) is not None:
            return self.mapping(i, indent)
        return self.inline(i, indent)

    def mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        out = {}
        while i < len(self.lines) and self.lines[i].indent == indent:
            line = self.lines[i]
            kv = _key_split(line.text, line.no)
            if kv is None:
                if _is_item(line.text):
                    _fail(line.no, "a sequence item where a mapping key belongs")
                _fail(line.no, f"expected 'key: value', got {line.text!r}")
            key, rest = kv
            i += 1
            if rest:
                value, i = self.inline_text(rest, line.no, i, indent)
            elif i < len(self.lines) and self.lines[i].indent > indent:
                value, i = self.block(i, self.lines[i].indent)
            elif (i < len(self.lines) and self.lines[i].indent == indent
                  and _is_item(self.lines[i].text)):
                value, i = self.sequence(i, indent)
            else:
                value = None
            out[key] = value
        if i < len(self.lines) and self.lines[i].indent > indent:
            _fail(self.lines[i].no, "bad indentation")
        return out, i

    def sequence(self, i: int, indent: int) -> Tuple[list, int]:
        out = []
        while i < len(self.lines) and self.lines[i].indent == indent:
            line = self.lines[i]
            if not _is_item(line.text):
                break
            rest = line.text[1:].lstrip()
            if not rest:
                i += 1
                if i < len(self.lines) and self.lines[i].indent > indent:
                    value, i = self.block(i, self.lines[i].indent)
                else:
                    value = None
            else:
                # The item starts on the dash's line: parse it as a block at
                # the column where its text begins.
                col = indent + len(line.text) - len(rest)
                self.lines[i] = _Line(line.no, col, rest)
                value, i = self.block(i, col)
            out.append(value)
        if i < len(self.lines) and self.lines[i].indent > indent:
            _fail(self.lines[i].no, "bad indentation")
        return out, i

    def inline(self, i: int, indent: int) -> Tuple[Any, int]:
        line = self.lines[i]
        return self.inline_text(line.text, line.no, i + 1, indent - 1)

    def inline_text(self, text: str, lineno: int, i: int, parent_indent: int):
        """A value written on one line (``text``, from line ``lineno``); a
        flow collection may take the following lines deeper than
        ``parent_indent``.  Returns (value, index of the next line)."""
        if text[0] in "[{":
            while not _flow_balanced(text, lineno):
                if i >= len(self.lines) or self.lines[i].indent <= parent_indent:
                    _fail(lineno, "an unclosed flow collection")
                text = text + " " + self.lines[i].text
                i += 1
            value, end = _Flow(text, lineno).value(0)
            if text[end:].strip():
                _fail(lineno, f"content after a flow collection: {text[end:].strip()!r}")
            return value, i
        if text[0] in "'\"":
            value, end = _quoted(text, 0, lineno)
            if text[end:].strip():
                _fail(lineno, f"content after a quoted scalar: {text[end:].strip()!r}")
        else:
            if text[0] in _REFUSED_START:
                _fail(lineno, _REFUSED_START[text[0]])
            if _is_item(text) or re.search(r":(?:\s|$)", text):
                _fail(lineno, f"a collection where a scalar belongs: {text!r}")
            value = _resolve_plain(text, lineno)
        if i < len(self.lines) and self.lines[i].indent > parent_indent and not (
                _is_item(self.lines[i].text)
                or _key_split(self.lines[i].text, self.lines[i].no) is not None):
            _fail(self.lines[i].no, "a scalar continued over several lines")
        return value, i


def _flow_balanced(text: str, lineno: int) -> bool:
    depth, i = 0, 0
    while i < len(text):
        c = text[i]
        if c in "'\"" and (i == 0 or text[i - 1] in " [{,:"):
            i = _skip_quoted(text, i, lineno)
            continue
        depth += c in "[{"
        depth -= c in "]}"
        i += 1
    return depth <= 0


class _Flow:
    """Flow sequences and mappings inside one (joined) line of text."""

    def __init__(self, text: str, lineno: int):
        self.text, self.no = text, lineno

    def ws(self, i: int) -> int:
        while i < len(self.text) and self.text[i] == " ":
            i += 1
        return i

    def value(self, i: int) -> Tuple[Any, int]:
        i = self.ws(i)
        if i >= len(self.text):
            _fail(self.no, "an unclosed flow collection")
        c = self.text[i]
        if c == "[":
            return self.seq(i + 1)
        if c == "{":
            return self.map(i + 1)
        if c in "'\"":
            v, end = _quoted(self.text, i, self.no)
            return v, self.ws(end)
        if c in _REFUSED_START:
            _fail(self.no, _REFUSED_START[c])
        if c == "?":  # in a flow collection '?' always starts an explicit key
            _fail(self.no, "an explicit key '?'")
        j = i
        while j < len(self.text):
            ch = self.text[j]
            if ch in ",[]{}":
                break
            if ch == ":" and (j + 1 == len(self.text) or self.text[j + 1] in " ,[]{}"):
                break
            j += 1
        if j == i:
            _fail(self.no, "an empty entry in a flow collection")
        return _resolve_plain(self.text[i:j].rstrip(), self.no), self.ws(j)

    def seq(self, i: int) -> Tuple[list, int]:
        out = []
        i = self.ws(i)
        while True:
            if i < len(self.text) and self.text[i] == "]":
                return out, i + 1
            v, i = self.value(i)
            if i < len(self.text) and self.text[i] == ":":
                _fail(self.no, "a mapping inside a flow sequence")
            out.append(v)
            i = self.sep(i, "]")

    def map(self, i: int) -> Tuple[dict, int]:
        out = {}
        i = self.ws(i)
        while True:
            if i < len(self.text) and self.text[i] == "}":
                return out, i + 1
            k, i = self.value(i)
            if isinstance(k, (list, dict)):
                _fail(self.no, "a collection as a key")
            if i < len(self.text) and self.text[i] == ":":
                i = self.ws(i + 1)
                if i < len(self.text) and self.text[i] in ",}":
                    v = None
                else:
                    v, i = self.value(i)
            else:
                v = None
            out[k] = v
            i = self.sep(i, "}")

    def sep(self, i: int, close: str) -> int:
        i = self.ws(i)
        if i < len(self.text) and self.text[i] == ",":
            return self.ws(i + 1)
        if i < len(self.text) and self.text[i] == close:
            return i
        _fail(self.no, f"expected ',' or '{close}' in a flow collection")


def load(source: str) -> Any:
    """Parse one YAML document in the subset; raises ``ValueError`` naming
    the line for anything outside it."""
    return _Parser(source).parse()


def load_file(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return load(f.read())
