"""A reader for the small subset of YAML that the repo's configs use.

The port reads its experiment, marker and camera files with this reader
and never with PyYAML, so one code path runs wherever the port does,
including machines without PyYAML.  The subset:

  * comments, whole-line and after a value (`# ...` preceded by a space);
  * block mappings, nested by indentation;
  * block lists (`- item`), whose items are scalars, flow lists or
    mappings (`- x: 1` with the item's further keys under `x`);
  * flow lists of scalars on one line (`[5, 5]`);
  * plain scalars, resolved exactly as `yaml.safe_load` (YAML 1.1)
    resolves them: decimal int, float (`8.0`, `1.`, `.5`, `1.0e+3`,
    `.inf`, `.nan`), bool (`true`, `yes`, `on`, ...), null (`~`, `null`,
    an empty value) and string; `1e-3` has no dot and `1.0e3` no exponent
    sign, so both stay strings, as in PyYAML.

Anything else raises `ValueError` naming the file and line: tabs,
anchors and aliases, tags, quoted scalars, flow mappings, block scalars,
multi-line scalars, octal, hex, binary and sexagesimal numbers,
timestamps, merge keys, complex keys, several documents, duplicate keys.
It never reads such a file some other way.
"""

from __future__ import annotations

import re
from typing import Any

# PyYAML's implicit resolvers (resolver.py), whole-string matches
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_NULL = re.compile(r"^(?:~|null|Null|NULL)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_DECIMAL = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
# a plain scalar may not start with an indicator; `-`, `?` and `:` only
# when a space follows (or nothing does)
_INDICATORS = set("[]{},#&*!|>'\"%@`")
_KEY_SEP = re.compile(r":(?: |$)")


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text = no, indent, text


class _Parser:
    def __init__(self, text: str, name: str):
        self.name = name
        self.lines = []
        for no, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw:
                self.fail(no, "tab character")
            body = self._strip_comment(raw).rstrip()
            if not body.strip():
                continue
            stripped = body.lstrip(" ")
            if stripped in ("---", "...") or stripped.startswith(("--- ", "%")):
                self.fail(no, "document markers and directives are not supported")
            self.lines.append(_Line(no, len(body) - len(stripped), stripped))

    def fail(self, no: int, why: str):
        raise ValueError(f"{self.name}:{no}: {why} (outside the YAML subset this reader takes)")

    @staticmethod
    def _strip_comment(raw: str) -> str:
        """`#` at the start or after a space opens a comment; quoted
        scalars, where it would not, are outside the subset and raise."""
        for i, ch in enumerate(raw):
            if ch == "#" and (i == 0 or raw[i - 1] == " "):
                return raw[:i]
        return raw

    # ------------------------------------------------------------ values
    def scalar(self, s: str, no: int, flow: bool = False) -> Any:
        if not s:
            return None
        if s[0] in _INDICATORS or s[:2] in ("- ", "? ", ": ") or s in ("-", "?", ":"):
            self.fail(no, f"unsupported syntax: {s!r}")
        if flow and any(c in s for c in ",[]{}"):
            self.fail(no, f"nested flow collection: {s!r}")
        if any(c in s for c in "[]{}") or ": " in s or s.endswith(":"):
            self.fail(no, f"unsupported plain scalar: {s!r}")
        if _NULL.match(s):
            return None
        if _BOOL.match(s):
            return s in _TRUE
        if _INT.match(s):
            if not _DECIMAL.match(s):
                self.fail(no, f"octal, hex, binary or sexagesimal int: {s!r}")
            return int(s.replace("_", ""))
        if _FLOAT.match(s):
            return self._float(s, no)
        if s == "=" or s == "<<" or _TIMESTAMP.match(s):
            self.fail(no, f"value, merge or timestamp scalar: {s!r}")
        return s

    def _float(self, s: str, no: int) -> float:
        v = s.replace("_", "").lower()
        if ":" in v:
            self.fail(no, f"sexagesimal float: {s!r}")
        sign = -1.0 if v[0] == "-" else 1.0
        if v.lstrip("+-") == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        try:
            return float(v)
        except ValueError:
            self.fail(no, f"malformed float: {s!r}")

    def inline(self, s: str, no: int) -> Any:
        """A value on the line of its key or dash: a flow list or a scalar."""
        if s.startswith("{"):
            self.fail(no, "flow mappings are not supported")
        if s.startswith("["):
            if not s.endswith("]"):
                self.fail(no, "multi-line or malformed flow list")
            body = s[1:-1].strip()
            if not body:
                return []
            items = [i.strip() for i in body.split(",")]
            if items[-1] == "":
                items.pop()
            if any(i == "" for i in items):
                self.fail(no, f"empty item in flow list: {s!r}")
            return [self.scalar(i, no, flow=True) for i in items]
        return self.scalar(s, no)

    # ------------------------------------------------------------ blocks
    def block(self, i: int, indent: int):
        """The block node whose first line is lines[i], at `indent`."""
        if self._is_item(self.lines[i].text):
            return self.sequence(i, indent)
        if _KEY_SEP.search(self.lines[i].text):
            return self.mapping(i, indent)
        line = self.lines[i]
        value = self.inline(line.text, line.no)
        return value, self._after_leaf(i + 1, indent)

    @staticmethod
    def _is_item(text: str) -> bool:
        return text == "-" or text.startswith("- ")

    def _after_leaf(self, i: int, indent: int) -> int:
        """A scalar ends its node: a deeper line after it would continue it."""
        if i < len(self.lines) and self.lines[i].indent > indent:
            self.fail(self.lines[i].no, "multi-line scalar or bad indentation")
        return i

    def _child(self, i: int, indent: int, allow_same_indent_list: bool):
        """The value of a key or dash with nothing after it on its line."""
        if i < len(self.lines):
            nxt = self.lines[i]
            if nxt.indent > indent:
                return self.block(i, nxt.indent)
            if allow_same_indent_list and nxt.indent == indent and self._is_item(nxt.text):
                return self.sequence(i, indent)
        return None, i

    def mapping(self, i: int, indent: int):
        out = {}
        while i < len(self.lines) and self.lines[i].indent == indent:
            line = self.lines[i]
            if self._is_item(line.text):
                break
            if line.text.startswith("? "):
                self.fail(line.no, "complex keys are not supported")
            m = _KEY_SEP.search(line.text)
            if m is None:
                self.fail(line.no, f"expected `key: value`, got {line.text!r}")
            key_text, rest = line.text[:m.start()].rstrip(), line.text[m.end():].strip()
            if ":" in key_text or not key_text:
                self.fail(line.no, f"unsupported key {key_text!r}")
            key = self.scalar(key_text, line.no)
            if key in out:
                self.fail(line.no, f"duplicate key {key_text!r}")
            if rest:
                value, i = self.inline(rest, line.no), self._after_leaf(i + 1, indent)
            else:
                value, i = self._child(i + 1, indent, allow_same_indent_list=True)
            out[key] = value
        if i < len(self.lines) and self.lines[i].indent > indent:
            self.fail(self.lines[i].no, "bad indentation")
        return out, i

    def sequence(self, i: int, indent: int):
        out = []
        while (i < len(self.lines) and self.lines[i].indent == indent
               and self._is_item(self.lines[i].text)):
            line = self.lines[i]
            rest = line.text[1:]
            stripped = rest.lstrip(" ")
            if not stripped:
                value, i = self._child(i + 1, indent, allow_same_indent_list=False)
            elif self._is_item(stripped):
                self.fail(line.no, "nested block lists on one line are not supported")
            elif _KEY_SEP.search(stripped) and not stripped.startswith("["):
                # `- key: value`: a mapping whose keys sit at the column of `key`
                col = indent + 1 + len(rest) - len(stripped)
                self.lines[i] = _Line(line.no, col, stripped)
                value, i = self.mapping(i, col)
            else:
                value, i = self.inline(stripped, line.no), self._after_leaf(i + 1, indent)
            out.append(value)
        if i < len(self.lines) and self.lines[i].indent > indent:
            self.fail(self.lines[i].no, "bad indentation")
        return out, i

    def document(self):
        if not self.lines:
            return None
        value, i = self.block(0, self.lines[0].indent)
        if i < len(self.lines):
            self.fail(self.lines[i].no, "content after the top-level node")
        return value


def loads(text: str, name: str = "<string>") -> Any:
    """Parse `text`; `name` labels the errors."""
    return _Parser(text, name).document()


def load(path) -> Any:
    """Parse the file at `path` (what `yaml.safe_load(open(path))` gives, for
    the subset this module takes)."""
    with open(path, encoding="utf-8") as f:
        return loads(f.read(), str(path))
