"""A reader for the rcnn detector YAML files (`configs/{ycbv,lmo}_rcnn.yaml`),
without PyYAML (which the card's machine does not have).

It reads the subset those files use, as `yaml.safe_load` reads it: `#`
comments, nested block maps by indentation, block lists (`- item`) whose
items are scalars or flow lists, flow lists (`[32, 64]`), and scalars that are
ints (`32`, `-1`), floats, `true`/`false`, `null` or plain and quoted
strings. Anything else (anchors, multi-line strings, flow maps, documents)
raises ValueError.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

_INT = re.compile(r"^[-+]?[0-9]+$")
_FLOAT = re.compile(r"^[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?$")


def _scalar(text: str) -> Any:
    text = text.strip()
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        return [] if not inner else [_scalar(x) for x in inner.split(",")]
    if text[:1] in "{&*!|>":
        raise ValueError(f"unsupported YAML: {text!r}")
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text) and any(c in text for c in ".eE"):
        return float(text)
    if text in ("true", "True", "false", "False"):
        return text in ("true", "True")
    if text in ("", "null", "~"):
        return None
    return text


def _strip_comment(line: str) -> str:
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _lines(text: str) -> List[Tuple[int, str]]:
    out = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if line.strip() in ("---", "..."):
            raise ValueError("YAML documents are not supported")
        out.append((len(line) - len(line.lstrip(" ")), line.strip()))
    return out


def _block(lines, i: int, indent: int):
    """Parse the block starting at lines[i] (at `indent`); returns (value, next i)."""
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        items = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1].startswith("- ") or lines[i][1] == "-"):
            rest = lines[i][1][1:].strip()
            if not rest:
                value, i = _block(lines, i + 1, lines[i + 1][0])
                items.append(value)
                continue
            if ":" in rest and not rest.startswith("["):
                raise ValueError(f"maps inside block lists are not supported: {rest!r}")
            items.append(_scalar(rest))
            i += 1
        return items, i
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        text = lines[i][1]
        if text.startswith("- "):
            raise ValueError(f"a list item where a key was expected: {text!r}")
        key, sep, rest = text.partition(":")
        if not sep or (rest and not rest.startswith(" ")):
            raise ValueError(f"not a key: value line: {text!r}")
        key = _scalar(key)
        rest = rest.strip()
        i += 1
        if rest:
            out[key] = _scalar(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and lines[i][1].startswith("- "))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def loads(text: str) -> Any:
    """`yaml.safe_load(text)` for the subset above."""
    lines = _lines(text)
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected indentation at {lines[i][1]!r}")
    return value


def load(path: str) -> Any:
    with open(path) as f:
        return loads(f.read())
