"""YAML configuration with attribute access (port of ``utils/config.py``).

:class:`Config` keeps the reference contract that a missing key reads as
``None``.  Configs are read with PyYAML when it imports; otherwise with
:func:`parse_yaml`, a reader for the subset that ``configs/*.yaml`` use:
nested block maps by indentation, plain scalars and ``#`` comments.  Its
scalars resolve as PyYAML's YAML 1.1 resolver does (bool, int, float, null,
else string).
"""

from __future__ import annotations

import ast
import re
from typing import Any, Mapping

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "true", "on"}
_INT = re.compile(r"^[-+]?(?:0b[0-1_]+|0[0-7_]+|(?:0|[1-9][0-9_]*)|0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_NULL = {"", "~", "null", "Null", "NULL"}


class Config(dict):
    """A dict whose keys are attribute-accessible; missing keys -> ``None``.

    Nested dicts are lazily wrapped so ``cfg.model.enc.n_layer`` works.
    """

    def __getattr__(self, item: str) -> Any:
        if item.startswith("__") and item.endswith("__"):
            raise AttributeError(item)
        if item not in self:
            return None
        value = self[item]
        if type(value) is dict:
            value = Config(value)
            self[item] = value
        return value

    def __setattr__(self, item: str, value: Any) -> None:
        self[item] = value

    def override(self, dotted_key: str, value: Any) -> "Config":
        """Set ``a.b.c`` style key paths (used by CLI ``--set`` overrides)."""
        parts = dotted_key.split(".")
        node = self
        for part in parts[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, dict):
                nxt = Config()
                node[part] = nxt
            elif type(nxt) is dict:
                nxt = Config(nxt)
                node[part] = nxt
            node = nxt
        node[parts[-1]] = value
        return self


def _scalar(text: str) -> Any:
    if text in _NULL:
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        clean = text.replace("_", "")
        sign = -1 if clean.startswith("-") else 1
        body = clean.lstrip("+-")
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if body != "0" and body.startswith("0"):
            return sign * int(body, 8)
        return sign * int(body)
    if _FLOAT.match(text):
        clean = text.replace("_", "").lower()
        if clean.endswith(("inf", "nan")):
            return float(clean.replace(".", ""))
        return float(clean)
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    return text


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment: at line start or after whitespace, outside quotes."""
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


def parse_yaml(text: str) -> dict:
    """Parse the block-map YAML subset of ``configs/*.yaml`` into dicts."""
    root: dict = {}
    # stack of (indent of the mapping's keys, mapping); a key with an empty
    # value opens a child mapping when the next line is deeper, else reads
    # as None
    stack = [(None, root)]
    pending = None   # (indent, parent, key) of a key whose value is empty
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() == "---":
            continue
        indent = len(line) - len(line.lstrip(" "))
        key, sep, value = line.strip().partition(":")
        if not sep or (value and not value.startswith((" ", "\t"))):
            raise ValueError(f"line {lineno}: not a 'key: value' line: {raw!r}")
        key, value = key.strip(), value.strip()
        if pending is not None:
            p_indent, p_parent, p_key = pending
            pending = None
            if indent > p_indent:
                child: dict = {}
                p_parent[p_key] = child
                stack.append((indent, child))
        while len(stack) > 1 and indent < stack[-1][0]:
            stack.pop()
        top_indent, parent = stack[-1]
        if top_indent is None:
            stack[-1] = (indent, parent)
        elif indent != top_indent:
            raise ValueError(f"line {lineno}: bad indentation: {raw!r}")
        if value:
            parent[key] = _scalar(value)
        else:
            parent[key] = None
            pending = (indent, parent, key)
    return root


def _load_text(text: str) -> dict:
    try:
        import yaml
    except ImportError:
        return parse_yaml(text)
    return yaml.safe_load(text)


def load_config(path_or_stream, overrides: Mapping[str, Any] | None = None) -> Config:
    """Load a YAML config file (same schema as the reference ``config/*.yaml``)."""
    if hasattr(path_or_stream, "read"):
        text = path_or_stream.read()
    else:
        with open(path_or_stream, "r", encoding="utf-8") as fh:
            text = fh.read()
    cfg = Config(_load_text(text) or {})
    for key, value in (overrides or {}).items():
        cfg.override(key, value)
    return cfg


def _dump_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return ".nan"
        if value in (float("inf"), float("-inf")):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        mant, e, exp = text.partition("e")
        if "." not in mant:       # YAML 1.1 reads "1e-05" as a string
            mant += ".0"
        return mant + e + exp
    if isinstance(value, str):
        if _scalar(value) == value and value == value.strip() and not (
                set(value) & set("#:'\"{}[],&*!|>%@`") or value.startswith("-")):
            return value
        return "'" + value.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(value).__name__} {value!r} to a config")


def dump_config(cfg: Mapping, path: str) -> None:
    """Write a config as the block-map YAML that :func:`parse_yaml` (and
    PyYAML) read back."""
    lines = []

    def emit(node: Mapping, indent: int) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                lines.append(" " * indent + f"{key}:")
                emit(value, indent + 4)
            else:
                lines.append(" " * indent + f"{key}: {_dump_scalar(value)}")

    emit(cfg, 0)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")


def apply_overrides(cfg, pairs):
    """Apply CLI ``KEY=VALUE`` override pairs (dotted keys; values parsed as
    Python literals when possible, else kept as strings)."""
    for kv in pairs or []:
        key, value = kv.split("=", 1)
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
        cfg.override(key, value)
    return cfg


def stack_context(data_cfg):
    """(left, right) frame-stacking context from a ``data:`` block, default
    (3, 0); an explicit 0 stays 0."""
    left = data_cfg.left_context_width
    right = data_cfg.right_context_width
    return (3 if left is None else left), (0 if right is None else right)


def subsample_factor(data_cfg) -> int:
    """Frame-subsampling factor from a ``data:`` block, default 3."""
    f = data_cfg.subsample
    return 3 if f is None else f
