"""Config machinery: defaults <- CLI <- YAML.

Counterpart of ``pdb2reaction_tpu/workflows/config.py``: ``deep_update``,
``apply_yaml_overrides`` (ordered candidate key paths, YAML wins over
the CLI), ``load_yaml_dict``, ``parse_bool``, choice aliases
(light -> lbfgs, heavy -> rfo), the echo block printed at the start of a
run and elapsed-time formatting.

The port has no YAML library. ``load_yaml_dict`` reads ``--args-yaml``
files with ``read_yaml``, a reader of the subset such files use:

- block mappings nested by indentation (spaces), ``key: value``;
- lists as ``- item`` blocks (items may be scalars, mappings or lists)
  or as one-line flow lists ``[a, b, [c]]``;
- scalars as PyYAML's ``safe_load`` resolves them: null (``~``,
  ``null``, empty), booleans (``true``/``false``/``yes``/``no``/``on``/
  ``off`` in its three cases), decimal integers, floats (``1.5``,
  ``1.0e-5``, ``.inf``, ``.nan``; ``1e-5`` is a string, as there), single-
  or double-quoted strings (the escapes ``\\\\``, ``\\"``, ``\\n`` and
  ``\\t``) and plain strings;
- ``#`` comments.

Anything else raises ``ValueError`` naming the construct: anchors and
aliases, tags, multi-document files and directives, block scalars
(``|``, ``>``), flow mappings (``{...}``), complex keys, merge keys,
multi-line scalars and flow lists, tabs in indentation, any other
escape in a double-quoted string, and scalars that
PyYAML would read as something other than the types above (binary,
octal, hexadecimal and sexagesimal numbers, timestamps).
"""

from __future__ import annotations

import re
import time
from pathlib import Path
from typing import (Any, Dict, Iterable, List, Mapping, Optional, Sequence,
                    Tuple)

_ALIASES = {
    "light": "lbfgs",
    "heavy": "rfo",
}


def deep_update(base: Dict[str, Any],
                override: Mapping[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``override`` into ``base`` (in place, returned)."""
    for k, v in override.items():
        if (k in base and isinstance(base[k], dict)
                and isinstance(v, Mapping)):
            deep_update(base[k], v)
        else:
            base[k] = v
    return base


def apply_yaml_overrides(cfg: Dict[str, Any], yaml_dict: Mapping[str, Any],
                         candidates: Sequence[Tuple[str, ...]]
                         ) -> Dict[str, Any]:
    """Merge the mapping at every candidate key path of ``yaml_dict`` that
    exists into ``cfg``, in the order given: a later candidate refines
    an earlier one. E.g. candidates [("opt", "lbfgs"), ("lbfgs",)]."""
    for path in candidates:
        node: Any = yaml_dict
        ok = True
        for key in path:
            if isinstance(node, Mapping) and key in node:
                node = node[key]
            else:
                ok = False
                break
        if ok and isinstance(node, Mapping):
            deep_update(cfg, node)
    return cfg


def load_yaml_dict(path) -> Dict[str, Any]:
    """The top-level mapping of the YAML file at ``path`` (``{}`` for
    None or an empty file), read with ``read_yaml``."""
    if path is None:
        return {}
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"YAML file not found: {p}")
    data = read_yaml(p.read_text()) or {}
    if not isinstance(data, dict):
        raise ValueError(f"Top-level YAML in {p} must be a mapping")
    return data


# ---------------------------------------------------------------------------
# the YAML subset reader
# ---------------------------------------------------------------------------

_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                              "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                               "off", "Off", "OFF")}}
_NULL = ("~", "null", "Null", "NULL", "")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
# what PyYAML reads as numbers or dates outside the subset
_OTHER = (
    (re.compile(r"[-+]?0b[0-1_]+$"), "a binary integer"),
    (re.compile(r"[-+]?0x[0-9a-fA-F_]+$"), "a hexadecimal integer"),
    (re.compile(r"[-+]?0[0-7_]+$"), "an octal integer"),
    (re.compile(r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$"),
     "a sexagesimal number"),
    (re.compile(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:$|[Tt ])"),
     "a timestamp"),
)
_ESCAPES = {"\\": "\\", '"': '"', "n": "\n", "t": "\t"}


class _Reader:
    """Line-based recursive descent over (indent, text) lines."""

    def __init__(self, text: str):
        self.lines: List[Tuple[int, str, int]] = []
        for no, raw in enumerate(text.splitlines(), start=1):
            body = _strip_comment(raw).rstrip()
            if not body.strip():
                continue
            lead = body[:len(body) - len(body.lstrip(" \t"))]
            if "\t" in lead:
                raise ValueError(f"YAML line {no}: a tab in the "
                                 "indentation is not supported")
            s = body.strip()
            if s in ("---", "...") or s.startswith(("--- ", "%")):
                raise ValueError(f"YAML line {no}: directives and "
                                 "multi-document files are not supported")
            self.lines.append((len(lead), s, no))

    def read(self):
        if not self.lines:
            return None
        ind = self.lines[0][0]
        value, i = self._node(0, ind)
        if i != len(self.lines):
            raise ValueError(f"YAML line {self.lines[i][2]}: unexpected "
                             "indentation")
        return value

    def _node(self, i, ind):
        if _is_item(self.lines[i][1]):
            return self._seq(i, ind)
        if _split_key(self.lines[i][1], self.lines[i][2]) is not None:
            return self._map(i, ind)
        ind0, s, no = self.lines[i]
        if i + 1 < len(self.lines) and self.lines[i + 1][0] > ind0:
            raise ValueError(f"YAML line {no}: multi-line scalars are not "
                             "supported")
        return _scalar_or_flow(s, no), i + 1

    def _child(self, i, ind, key_ind):
        """The value of a key or item whose text ended the line: a block
        indented deeper, a list at the key's own indentation, or null."""
        if i < len(self.lines):
            nind, ns, _ = self.lines[i]
            if nind > ind or (key_ind and nind == ind and _is_item(ns)):
                return self._node(i, nind)
        return None, i

    def _map(self, i, ind):
        out: Dict[Any, Any] = {}
        while i < len(self.lines) and self.lines[i][0] == ind:
            _, s, no = self.lines[i]
            kv = _split_key(s, no)
            if kv is None:
                raise ValueError(f"YAML line {no}: expected 'key: value'")
            key, rest = kv
            if rest == "":
                out[key], i = self._child(i + 1, ind, True)
            else:
                out[key] = _scalar_or_flow(rest, no)
                i += 1
                if i < len(self.lines) and self.lines[i][0] > ind:
                    raise ValueError(f"YAML line {no}: multi-line scalars "
                                     "are not supported")
        return out, i

    def _seq(self, i, ind):
        out: List[Any] = []
        while i < len(self.lines) and self.lines[i][0] == ind \
                and _is_item(self.lines[i][1]):
            _, s, no = self.lines[i]
            rest = s[1:].lstrip(" ")
            if rest == "":
                value, i = self._child(i + 1, ind, False)
            else:
                # the item's content as a line of its own at its column
                col = ind + len(s) - len(rest)
                self.lines[i] = (col, rest, no)
                value, i = self._node(i, col)
            out.append(value)
        return out, i


def _is_item(s: str) -> bool:
    return s == "-" or s.startswith("- ")


def _strip_comment(raw: str) -> str:
    """The line without its comment; '#' counts at the start or after a
    space, outside quotes."""
    quote = None
    i = 0
    while i < len(raw):
        ch = raw[i]
        if quote == "'":
            if ch == "'":
                if raw[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if ch == "\\":
                i += 1
            elif ch == '"':
                quote = None
        elif ch in "'\"" and (i == 0 or raw[i - 1] in " \t[,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or raw[i - 1] in " \t"):
            return raw[:i]
        i += 1
    return raw


def _split_key(s: str, no: int):
    """(key, rest) of a 'key: value' line, or None when the line holds no
    mapping key."""
    if s.startswith("? "):
        raise ValueError(f"YAML line {no}: complex keys are not supported")
    if s[0] in "'\"":
        text, end = _quoted(s, 0, no)
        rest = s[end:]
        if rest.startswith(":") and (len(rest) == 1 or rest[1] == " "):
            return text, rest[1:].strip()
        return None
    if s[0] in "[{&*!|>":
        return None
    m = re.search(r":( |$)", s)
    if m is None:
        return None
    key = s[:m.start()].rstrip()
    if key == "<<":
        raise ValueError(f"YAML line {no}: merge keys are not supported")
    return _plain(key, no), s[m.end():].strip()


def _scalar_or_flow(s: str, no: int):
    if s.startswith("["):
        value, end = _flow_seq(s, 0, no)
        if s[end:].strip():
            raise ValueError(f"YAML line {no}: text after a flow list")
        return value
    if s.startswith("{"):
        raise ValueError(f"YAML line {no}: flow mappings are not supported")
    if s[0] in "'\"":
        text, end = _quoted(s, 0, no)
        if s[end:].strip():
            raise ValueError(f"YAML line {no}: text after a quoted string")
        return text
    return _plain(s, no)


def _flow_seq(s: str, i: int, no: int):
    """A flow list starting at s[i] == '['; returns (list, index after)."""
    out = []
    i += 1
    while True:
        while i < len(s) and s[i] == " ":
            i += 1
        if i >= len(s):
            raise ValueError(f"YAML line {no}: multi-line flow lists are "
                             "not supported")
        if s[i] == "]":
            return out, i + 1
        if s[i] == "[":
            value, i = _flow_seq(s, i, no)
        elif s[i] == "{":
            raise ValueError(f"YAML line {no}: flow mappings are not "
                             "supported")
        elif s[i] in "'\"":
            value, i = _quoted(s, i, no)
        else:
            j = i
            while j < len(s) and s[j] not in ",]":
                j += 1
            tok = s[i:j].strip()
            if ": " in tok or tok.endswith(":"):
                raise ValueError(f"YAML line {no}: flow mappings are not "
                                 "supported")
            value, i = _plain(tok, no), j
        out.append(value)
        while i < len(s) and s[i] == " ":
            i += 1
        if i < len(s) and s[i] == ",":
            i += 1
        elif i < len(s) and s[i] != "]":
            raise ValueError(f"YAML line {no}: expected ',' or ']' in a "
                             "flow list")


def _quoted(s: str, i: int, no: int):
    """A quoted string starting at s[i]; returns (text, index after)."""
    q = s[i]
    out = []
    j = i + 1
    while j < len(s):
        ch = s[j]
        if q == "'":
            if ch == "'":
                if s[j + 1:j + 2] == "'":
                    out.append("'")
                    j += 2
                    continue
                return "".join(out), j + 1
            out.append(ch)
        else:
            if ch == '"':
                return "".join(out), j + 1
            if ch == "\\":
                e = s[j + 1:j + 2]
                if e not in _ESCAPES:
                    raise ValueError(f"YAML line {no}: the escape "
                                     f"'\\{e}' is outside the subset "
                                     "(\\\\, \\\", \\n, \\t)")
                out.append(_ESCAPES[e])
                j += 2
                continue
            out.append(ch)
        j += 1
    raise ValueError(f"YAML line {no}: multi-line quoted strings are not "
                     "supported")


def _plain(tok: str, no: int):
    """A plain scalar resolved as PyYAML's safe_load resolves it."""
    if tok[:1] in ("&", "*"):
        raise ValueError(f"YAML line {no}: anchors and aliases are not "
                         "supported")
    if tok[:1] == "!":
        raise ValueError(f"YAML line {no}: tags are not supported")
    if tok[:1] in ("|", ">"):
        raise ValueError(f"YAML line {no}: block scalars are not supported")
    if tok[:1] in ("@", "`", "%") or tok[:2] in ("- ", "? ", ": "):
        raise ValueError(f"YAML line {no}: {tok!r} cannot start a plain "
                         "scalar")
    if tok in _NULL:
        return None
    if tok in _BOOL:
        return _BOOL[tok]
    if _INT.match(tok):
        return int(tok.replace("_", ""))
    if _FLOAT.match(tok):
        return float(tok.replace("_", ""))
    m = _INF.match(tok)
    if m:
        return float("-inf") if m.group(1) == "-" else float("inf")
    if _NAN.match(tok):
        return float("nan")
    for pat, what in _OTHER:
        if pat.match(tok):
            raise ValueError(f"YAML line {no}: {tok!r} reads as {what}, "
                             "which is not supported")
    return tok


def read_yaml(text: str):
    """The document in ``text`` as Python values (None when it is empty);
    see the module docstring for the subset."""
    return _Reader(text).read()


# ---------------------------------------------------------------------------
# choices, booleans, echoes, times
# ---------------------------------------------------------------------------

def normalize_choice(value: Optional[str],
                     choices: Optional[Iterable[str]] = None
                     ) -> Optional[str]:
    if value is None:
        return None
    v = str(value).strip().lower()
    v = _ALIASES.get(v, v)
    if choices is not None and v not in set(choices):
        raise ValueError(f"Invalid choice {value!r}; allowed: "
                         f"{sorted(set(choices))}")
    return v


def parse_bool(value) -> bool:
    """Explicit True|False CLI booleans."""
    if isinstance(value, bool):
        return value
    v = str(value).strip().lower()
    if v in ("true", "1", "yes", "on"):
        return True
    if v in ("false", "0", "no", "off"):
        return False
    raise ValueError(f"Expected True or False, got {value!r}")


def _echo(value, indent: str) -> List[str]:
    """Block-style lines of a value, YAML-like: nested mappings indented
    two spaces, lists as '- item', booleans and None as true / false /
    null."""
    if isinstance(value, Mapping):
        if not value:
            return ["{}"]
        out = []
        for k, v in value.items():
            sub = _echo(v, indent + "  ")
            if isinstance(v, (Mapping, list, tuple)) and v:
                out.append(f"{indent}{k}:")
                out += sub
            else:
                out.append(f"{indent}{k}: {sub[0].strip()}")
        return out
    if isinstance(value, (list, tuple)):
        if not value:
            return ["[]"]
        out = []
        for v in value:
            sub = _echo(v, indent + "  ")
            if isinstance(v, (Mapping, list, tuple)) and v:
                out.append(f"{indent}-")
                out += sub
            else:
                out.append(f"{indent}- {sub[0].strip()}")
        return out
    if isinstance(value, bool):
        return ["true" if value else "false"]
    if value is None:
        return ["null"]
    return [str(value)]


def pretty_block(title: str, cfg: Mapping[str, Any]) -> str:
    """A titled block echoing a run's settings, nested mappings indented
    as YAML would show them."""
    body = "".join(line + "\n" for line in _echo(dict(cfg), ""))
    bar = "-" * max(len(title), 8)
    return f"{bar}\n{title}\n{bar}\n{body}"


def format_elapsed(t_start: float, t_end: Optional[float] = None) -> str:
    dt = (t_end if t_end is not None else time.time()) - t_start
    h = int(dt // 3600)
    m = int((dt % 3600) // 60)
    s = dt % 60
    return f"{h:02d}:{m:02d}:{s:06.3f}"
