"""A yacs-compatible configuration node that needs no PyYAML.

Same API subset and merge semantics as the JAX package's ``config/node.py``
(attribute access, ``clone``, ``merge_from_file``, ``merge_from_other_cfg``,
``merge_from_list``, ``freeze``/``defrost``): unknown keys raise
``KeyError``, merged values are type-checked against the default with the yacs
casts, lists are replaced wholesale.

The config files this package reads are block mappings of scalars
(``config/yamls/*.yaml``), so ``load_yaml`` parses that subset of YAML itself
and resolves plain scalars the way ``yaml.safe_load`` does (YAML 1.1: ``5e-4``
has no dot and stays a string, ``yes``/``no`` are booleans). Command-line
overrides are coerced with ``ast.literal_eval`` as in yacs.
"""

from __future__ import annotations

import ast
import copy
import re
from typing import Any, Dict, List

_VALID_SCALAR_TYPES = (bool, int, float, str, type(None))

# PyYAML's implicit resolvers for plain scalars (YAML 1.1), restricted to
# decimal integers; octal, hex and base-60 forms are not read as numbers.
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _scalar(text: str) -> Any:
    """One YAML scalar as ``yaml.safe_load`` resolves it (quoted or plain)."""
    if text[:1] in ("'", '"'):
        if len(text) < 2 or text[-1] != text[0]:
            raise ValueError(f"unterminated quoted scalar: {text}")
        if text[0] == "'":
            return text[1:-1].replace("''", "'")
        return ast.literal_eval(text)
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text in _TRUE
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.lstrip("+-") in (".inf", ".nan"):
            return float(t.replace(".", ""))
        return float(t)
    return text


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that is outside quotes and starts a token."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def load_yaml(text: str) -> Dict[str, Any] | None:
    """Parse a block mapping of scalars (any nesting depth) without PyYAML.

    Covers what config files of this package hold: ``KEY:`` opening a nested
    mapping, ``KEY: scalar`` and comments. Anything else raises ValueError.
    """
    root: Dict[str, Any] = {}
    stack: List = []  # (indent of the mapping's keys, mapping)
    pending = None  # (indent, mapping, key) of a "KEY:" awaiting its block
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() == "---":
            continue
        indent = len(line) - len(line.lstrip(" "))
        if "\t" in line[:indent]:
            raise ValueError(f"line {lineno}: tab indentation")
        key, sep, rest = line.strip().partition(":")
        if not sep or (rest and not rest.startswith(" ")):
            raise ValueError(f"line {lineno}: not a 'KEY: value' line: {raw!r}")
        key, rest = key.strip(), rest.strip()
        if not stack:
            stack.append((indent, root))
        if pending is not None and indent > pending[0]:
            child: Dict[str, Any] = {}
            pending[1][pending[2]] = child
            stack.append((indent, child))
        pending = None
        while len(stack) > 1 and indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise ValueError(f"line {lineno}: bad indentation: {raw!r}")
        mapping = stack[-1][1]
        if rest:
            mapping[key] = _scalar(rest)
        else:
            mapping[key] = None
            pending = (indent, mapping, key)
    return root or None


def _literal(value: str) -> Any:
    """yacs ``_decode_cfg_value``: a Python literal if it parses, else the string."""
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _check_value(value: Any, full_key: str) -> Any:
    if isinstance(value, dict):
        return CfgNode({k: _check_value(v, f"{full_key}.{k}") for k, v in value.items()})
    if isinstance(value, CfgNode):
        return value
    if isinstance(value, (list, tuple)):
        return [_check_value(v, f"{full_key}[{i}]") for i, v in enumerate(value)]
    if not isinstance(value, _VALID_SCALAR_TYPES):
        raise ValueError(
            f"Invalid config value type {type(value)} for key {full_key!r}; "
            f"allowed: dict/list/{_VALID_SCALAR_TYPES}"
        )
    return value


def _coerce(replacement: Any, original: Any, full_key: str) -> Any:
    """Type-check a merged value against the default, with yacs-style casts."""
    if original is None or replacement is None:
        return replacement
    o_type, r_type = type(original), type(replacement)
    if o_type is r_type:
        return replacement
    if o_type is float and r_type is int:
        return float(replacement)
    if o_type is int and r_type is float and float(int(replacement)) == replacement:
        return int(replacement)
    if o_type in (list, tuple) and r_type in (list, tuple):
        return list(replacement)
    # YAML 1.1 reads an unquoted "5e-4" as a string; numeric keys accept it.
    if o_type in (int, float) and r_type is str:
        try:
            num = float(replacement)
        except ValueError:
            pass
        else:
            return int(num) if o_type is int and num == int(num) else num
    raise ValueError(
        f"Type mismatch for key {full_key!r}: default is {o_type.__name__}, "
        f"replacement is {r_type.__name__} ({replacement!r})"
    )


class CfgNode(dict):
    """Nested attribute-style config dictionary (yacs-compatible subset)."""

    _FROZEN = "__frozen__"

    def __init__(self, init_dict: Dict[str, Any] | None = None):
        super().__init__()
        object.__setattr__(self, CfgNode._FROZEN, False)
        if init_dict:
            for k, v in init_dict.items():
                super().__setitem__(k, _check_value(v, k))

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(f"Attempted to set {name} on a frozen CfgNode")
        super().__setitem__(name, _check_value(value, name))

    def __setitem__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise KeyError(f"Attempted to set {name} on a frozen CfgNode")
        super().__setitem__(name, _check_value(value, name))

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode._FROZEN)

    def freeze(self) -> None:
        self._set_frozen(True)

    def defrost(self) -> None:
        self._set_frozen(False)

    def _set_frozen(self, frozen: bool) -> None:
        object.__setattr__(self, CfgNode._FROZEN, frozen)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_frozen(frozen)

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __deepcopy__(self, memo) -> "CfgNode":
        node = CfgNode()
        for k, v in self.items():
            dict.__setitem__(node, k, copy.deepcopy(v, memo))
        return node

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        _merge_into(other, self, [])

    def merge_from_file(self, filename) -> None:
        with open(filename, "r") as f:
            loaded = load_yaml(f.read())
        if loaded is None:
            return
        self.merge_from_other_cfg(CfgNode(loaded))

    def merge_from_list(self, opts: List[Any]) -> None:
        if len(opts) % 2 != 0:
            raise ValueError(f"Override list has odd length: {opts}")
        for full_key, value in zip(opts[0::2], opts[1::2]):
            keys = full_key.split(".")
            node = self
            for sub in keys[:-1]:
                if sub not in node:
                    raise KeyError(f"Non-existent key: {full_key}")
                node = node[sub]
            leaf = keys[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent key: {full_key}")
            if isinstance(value, str):
                value = _literal(value)
            dict.__setitem__(node, leaf, _coerce(value, node[leaf], full_key))

    def __repr__(self) -> str:
        return f"CfgNode({dict.__repr__(self)})"


def _merge_into(src: CfgNode, dst: CfgNode, key_path: List[str]) -> None:
    for key, src_val in src.items():
        full_key = ".".join(key_path + [key])
        if key not in dst:
            raise KeyError(f"Non-existent config key: {full_key}")
        dst_val = dst[key]
        if isinstance(src_val, CfgNode):
            if not isinstance(dst_val, CfgNode):
                raise ValueError(f"Cannot merge dict into non-dict key {full_key!r}")
            _merge_into(src_val, dst_val, key_path + [key])
        else:
            dict.__setitem__(dst, key, _coerce(src_val, dst_val, full_key))
