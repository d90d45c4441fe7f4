"""The port's YAML reader: the subset of YAML that the repository's configs
and dataset catalogs use, read to exactly what ``yaml.safe_load`` gives.

PyYAML is not a dependency of the port: ``Catalog.load``, ``run_yaml`` and
the bench CLI read every YAML through this module, on a host with PyYAML
or without it alike.  What it reads:

- comments (``#`` at a line's start or after a space), blank lines, one
  leading ``---``;
- block mappings and block sequences nested by indentation, a sequence
  item that opens a mapping (``- type: PQ`` with its continuation keys at
  the key's column) and a sequence at its parent key's own indentation;
- flow sequences on one line (``[32]``, ``[1.2f]``, ``[No]``,
  ``[2.0, 4.0, 6.0]``, nested ``[[1, 2]]``, ``[]``);
- plain scalars, resolved by YAML 1.1's rules as PyYAML resolves them:
  null (empty, ``~``, ``null``), booleans (``yes`` / ``no`` / ``true`` /
  ``false`` / ``on`` / ``off`` in three casings), decimal ints (``10``,
  ``-3``, ``1_000``), floats with a dot (``-1.0``, ``.5``, ``1.0e+5``,
  ``.inf``, ``.nan``) and strings (``1.2f``, ``${DATA}/x``, ``1e5``);
  mapping keys resolve the same way (``10:`` is the int 10);
- single- and double-quoted scalars (a double-quoted one without escapes).

Anything else raises ``ValueError`` naming the line: anchors and aliases,
tags, block scalars (``|``, ``>``), flow mappings, multi-line scalars and
flow sequences, complex keys, directives, a second document, octal / hex /
binary / sexagesimal numbers, timestamps, merge keys and tab indentation.
"""

from __future__ import annotations

import os
import re
from typing import Any, NamedTuple

_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)\Z")
_FLOAT = re.compile(r"(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)\Z")
_INF_NAN = re.compile(r"(?:[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))\Z")
# forms PyYAML resolves that this reader does not: octal, hex, binary and
# sexagesimal numbers, timestamps, the merge key and the value key
_UNSUPPORTED = re.compile(
    r"(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9].*)?"
    r"|<<|=)\Z"
)
_INDICATORS = set(",[]{}#&*!|>'\"%@`")


class _Line(NamedTuple):
    no: int  # 1-based line number in the source
    indent: int
    text: str  # without indentation and comment


class _Reader:
    def __init__(self, text: str, source: str):
        self.source = source
        self.lines = self._lines(text)

    def error(self, no: int, msg: str) -> ValueError:
        return ValueError(f"{self.source}:{no}: {msg} (not in the YAML subset this reader reads)")

    # -- lines -----------------------------------------------------------------

    def _lines(self, text: str) -> list[_Line]:
        out, started = [], False
        for no, raw in enumerate(text.lstrip("﻿").splitlines(), 1):
            body = raw.lstrip(" ")
            if body.startswith("\t") and body.strip():
                raise self.error(no, "tab indentation")
            body = self._strip_comment(no, body).rstrip(" \t")
            if not body:
                continue
            indent = len(raw) - len(raw.lstrip(" "))
            if indent == 0 and (body == "---" or body.startswith("--- ") or body == "..."):
                if started or body != "---":
                    raise self.error(no, "a second document or a document end marker")
                started = True
                continue
            if indent == 0 and body.startswith("%"):
                raise self.error(no, "a directive")
            started = True
            out.append(_Line(no, indent, body))
        return out

    def _strip_comment(self, no: int, text: str) -> str:
        quote, j = None, 0
        while j < len(text):
            c = text[j]
            if quote:
                if c == quote:
                    if quote == "'" and text[j + 1 : j + 2] == "'":
                        j += 1
                    else:
                        quote = None
            elif c in "'\"" and (not text[:j].strip() or text[:j].rstrip()[-1] in ":-[,"):
                quote = c
            elif c == "#" and (j == 0 or text[j - 1] in " \t"):
                return text[:j]
            j += 1
        if quote:
            raise self.error(no, "a quoted scalar over several lines")
        return text

    # -- structure ---------------------------------------------------------------

    @staticmethod
    def _is_item(text: str) -> bool:
        return text == "-" or text.startswith("- ")

    def parse(self) -> Any:
        if not self.lines:
            return None
        value, i = self._block(0, self.lines[0].indent)
        if i < len(self.lines):
            raise self.error(self.lines[i].no, "unexpected indentation")
        return value

    def _block(self, i: int, indent: int) -> tuple[Any, int]:
        line = self.lines[i]
        if self._is_item(line.text):
            return self._sequence(i, indent)
        if self._split_key(line) is not None:
            return self._mapping(i, indent)
        value = self._inline(line, line.text)
        if i + 1 < len(self.lines) and self.lines[i + 1].indent > indent:
            raise self.error(self.lines[i + 1].no, "a multi-line scalar")
        return value, i + 1

    def _sequence(self, i: int, indent: int) -> tuple[list, int]:
        out = []
        while i < len(self.lines) and self.lines[i].indent == indent and self._is_item(self.lines[i].text):
            line = self.lines[i]
            rest = line.text[1:]
            item = rest.lstrip(" ")
            if item:
                col = indent + 1 + len(rest) - len(item)
                self.lines[i] = _Line(line.no, col, item)
                value, i = self._block(i, col)
            elif i + 1 < len(self.lines) and self.lines[i + 1].indent > indent:
                value, i = self._block(i + 1, self.lines[i + 1].indent)
            else:
                value, i = None, i + 1
            out.append(value)
        return out, i

    def _mapping(self, i: int, indent: int) -> tuple[dict, int]:
        out: dict = {}
        while i < len(self.lines) and self.lines[i].indent == indent:
            line = self.lines[i]
            kv = None if self._is_item(line.text) else self._split_key(line)
            if kv is None:
                raise self.error(line.no, "expected 'key: value' in a mapping")
            key = self._scalar(line, kv[0], is_key=True)
            i += 1
            nxt = self.lines[i] if i < len(self.lines) else None
            if kv[1]:
                value = self._inline(line, kv[1])
                if nxt is not None and nxt.indent > indent:
                    raise self.error(nxt.no, "a multi-line value")
            elif nxt is not None and nxt.indent > indent:
                value, i = self._block(i, nxt.indent)
            elif nxt is not None and nxt.indent == indent and self._is_item(nxt.text):
                value, i = self._sequence(i, indent)
            else:
                value = None
            out[key] = value
        return out, i

    def _split_key(self, line: _Line) -> tuple[str, str] | None:
        """``(key, value)`` at the first ``:`` followed by a space or the
        line's end, outside quotes and brackets; None for no such colon."""
        text, quote, depth = line.text, None, 0
        for j, c in enumerate(text):
            if quote:
                if c == quote:
                    quote = None
            elif c in "'\"" and not text[:j].strip():
                quote = c
            elif c in "[{":
                depth += 1
            elif c in "]}":
                depth -= 1
            elif c == ":" and depth == 0 and (j + 1 == len(text) or text[j + 1] == " "):
                return text[:j].rstrip(), text[j + 1 :].strip()
        return None

    # -- values ------------------------------------------------------------------

    def _inline(self, line: _Line, text: str) -> Any:
        if text.startswith("["):
            value, end = self._flow_sequence(line, text, 0)
            if text[end:].strip():
                raise self.error(line.no, f"text after a flow sequence: {text[end:].strip()!r}")
            return value
        return self._scalar(line, text)

    def _flow_sequence(self, line: _Line, text: str, j: int) -> tuple[list, int]:
        out, j = [], j + 1
        while True:
            while j < len(text) and text[j] == " ":
                j += 1
            if j >= len(text):
                raise self.error(line.no, "a flow sequence over several lines")
            if text[j] == "]":
                return out, j + 1
            if text[j] == "[":
                item, j = self._flow_sequence(line, text, j)
            elif text[j] in "'\"":
                end = self._quote_end(line, text, j)
                item, j = self._scalar(line, text[j:end]), end
            else:
                end = j
                while end < len(text) and text[end] not in ",[]{}":
                    end += 1
                if end < len(text) and text[end] in "[{}":
                    raise self.error(line.no, "a flow mapping or a bracket inside a flow scalar")
                plain = text[j:end].strip()
                if not plain:
                    raise self.error(line.no, "an empty entry in a flow sequence")
                item, j = self._scalar(line, plain), end
            out.append(item)
            while j < len(text) and text[j] == " ":
                j += 1
            if j < len(text) and text[j] == ",":
                j += 1
            elif j < len(text) and text[j] != "]":
                raise self.error(line.no, "expected ',' or ']' in a flow sequence")

    def _quote_end(self, line: _Line, text: str, j: int) -> int:
        q, k = text[j], j + 1
        while k < len(text):
            if text[k] == q:
                if q == "'" and text[k + 1 : k + 2] == "'":
                    k += 2
                    continue
                return k + 1
            k += 1
        raise self.error(line.no, "an unterminated quoted scalar")

    def _scalar(self, line: _Line, text: str, is_key: bool = False) -> Any:
        if text[:1] in "'\"":
            end = self._quote_end(line, text, 0)
            if end != len(text):
                raise self.error(line.no, f"text after a quoted scalar: {text!r}")
            body = text[1:-1]
            if text[0] == "'":
                return body.replace("''", "'")
            if "\\" in body:
                raise self.error(line.no, "an escape in a double-quoted scalar")
            return body
        what = "key" if is_key else "value"
        if text[:1] in _INDICATORS or text[:1] == "?" and text[1:2] in ("", " "):
            raise self.error(line.no, f"a {what} starting with {text[:1]!r} (anchor, alias, tag, block "
                                      f"scalar, flow mapping or complex key)")
        if text == "-" or text.startswith("- "):
            raise self.error(line.no, f"a sequence item as a {what}")
        if ": " in text or text.endswith(":"):
            raise self.error(line.no, f"a mapping inside a {what}: {text!r}")
        return self._resolve(line, text)

    def _resolve(self, line: _Line, s: str) -> Any:
        if s in _NULL:
            return None
        if s in _TRUE:
            return True
        if s in _FALSE:
            return False
        if _FLOAT.match(s) or _INF_NAN.match(s):
            v = s.replace("_", "").lower()
            sign = -1.0 if v[0] == "-" else 1.0
            v = v.lstrip("+-")
            if v == ".inf":
                return sign * float("inf")
            if v == ".nan":
                return float("nan")
            return sign * float(v)
        if _INT.match(s):
            v = s.replace("_", "")
            return -int(v[1:]) if v[0] == "-" else int(v.lstrip("+"))
        if _UNSUPPORTED.match(s):
            raise self.error(line.no, f"a scalar that YAML 1.1 reads as another type: {s!r}")
        return s


def load(text: str, source: str = "<string>") -> Any:
    """Parse YAML ``text`` as ``yaml.safe_load`` would; ``source`` names it in
    errors."""
    return _Reader(text, source).parse()


def load_file(path: str | os.PathLike) -> Any:
    """:func:`load` of a file's contents."""
    with open(path, encoding="utf-8") as f:
        return load(f.read(), str(path))
