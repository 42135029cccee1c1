"""YAML configuration engine.

The reference drives everything from Hydra/OmegaConf YAML (reference:
torchok/__main__.py:13-50). Neither library ships in this environment, so this
module implements the same user-facing surface natively:

* YAML with anchors/aliases (plain PyYAML handles those),
* ``${oc.env:VAR}`` / ``${oc.env:VAR,default}`` env interpolation,
* ``${now:%Y-%m-%d}`` timestamp interpolation,
* ``${a.b.c}`` config self-references,
* dotted command-line overrides (``a.b.c=value``) and ``+key=value`` additions,
* attribute-style access (``cfg.task.params``) via :class:`ConfigNode`.

PyYAML is imported only by the functions that parse YAML text, so a config
given as a dict (see ``torchok_tpu_torch.__main__.run``) needs no pyyaml.
"""
from __future__ import annotations

import copy
import datetime
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")

# The process-wide "now" is frozen at import of a config so that multiple
# ${now:...} interpolations in one file agree (mirrors hydra semantics).
_NOW: Optional[datetime.datetime] = None


class MissingMandatoryValue(Exception):
    pass


class ConfigNode:
    """Attribute-access wrapper over a dict tree (a minimal DictConfig)."""

    __slots__ = ("_data",)

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self._data[k] = _wrap(v)

    # -- mapping protocol ---------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return self._data[key]
        except KeyError:
            raise AttributeError(f"Config has no key {key!r}. Keys: {sorted(self._data)}")

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = _wrap(value)

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = _wrap(value)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __bool__(self) -> bool:
        return bool(self._data)

    def __eq__(self, other) -> bool:
        if isinstance(other, ConfigNode):
            return self.to_dict() == other.to_dict()
        if isinstance(other, dict):
            return self.to_dict() == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"ConfigNode({self.to_dict()!r})"

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def keys(self):
        return self._data.keys()

    def values(self):
        return self._data.values()

    def items(self):
        return self._data.items()

    def setdefault(self, key: str, default: Any = None) -> Any:
        if key not in self._data:
            self._data[key] = _wrap(default)
        return self._data[key]

    def pop(self, key: str, *default) -> Any:
        return self._data.pop(key, *default)

    def update(self, other: Union[Dict[str, Any], "ConfigNode"]) -> None:
        for k, v in (other.items() if hasattr(other, "items") else other):
            self._data[k] = _wrap(v)

    def to_dict(self) -> Dict[str, Any]:
        return _unwrap(self)

    def copy(self) -> "ConfigNode":
        return ConfigNode(copy.deepcopy(self.to_dict()))


def _wrap(value: Any) -> Any:
    if isinstance(value, ConfigNode):
        return value
    if isinstance(value, dict):
        return ConfigNode(value)
    if isinstance(value, (list, tuple)):
        return [_wrap(v) for v in value]
    return value


def _unwrap(value: Any) -> Any:
    if isinstance(value, ConfigNode):
        return {k: _unwrap(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_unwrap(v) for v in value]
    return value


# ---------------------------------------------------------------------------
# Interpolation
# ---------------------------------------------------------------------------

def _lookup(root: Dict[str, Any], dotted: str) -> Any:
    node: Any = root
    for part in dotted.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        elif isinstance(node, list) and part.lstrip("-").isdigit():
            node = node[int(part)]
        else:
            raise KeyError(f"Interpolation key {dotted!r} not found in config")
    return node


def _resolve_expr(expr: str, root: Dict[str, Any]) -> Any:
    expr = expr.strip()
    if expr.startswith("oc.env:"):
        body = expr[len("oc.env:"):]
        if "," in body:
            var, default = body.split(",", 1)
            return os.environ.get(var.strip(), default.strip())
        var = body.strip()
        if var not in os.environ:
            raise MissingMandatoryValue(f"Environment variable {var!r} is not set")
        return os.environ[var]
    if expr.startswith("now:"):
        fmt = expr[len("now:"):]
        return _NOW.strftime(fmt)  # type: ignore[union-attr]
    if expr == "now":
        return _NOW.strftime("%Y-%m-%d_%H-%M-%S")  # type: ignore[union-attr]
    return _lookup(root, expr)


def _resolve_value(value: Any, root: Dict[str, Any], depth: int = 0) -> Any:
    if depth > 16:
        raise RecursionError("Interpolation depth exceeded (cyclic reference?)")
    if isinstance(value, str):
        full = _INTERP_RE.fullmatch(value)
        if full:
            resolved = _resolve_expr(full.group(1), root)
            return _resolve_value(resolved, root, depth + 1)
        def sub(m: re.Match) -> str:
            r = _resolve_expr(m.group(1), root)
            r = _resolve_value(r, root, depth + 1)
            return str(r)
        return _INTERP_RE.sub(sub, value)
    return value


def _resolve_tree(node: Any, root: Dict[str, Any]) -> Any:
    if isinstance(node, dict):
        return {k: _resolve_tree(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_tree(v, root) for v in node]
    return _resolve_value(node, root)


def resolve(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve all interpolations in a raw config dict (multi-pass)."""
    global _NOW
    if _NOW is None:
        _NOW = datetime.datetime.now()
    for _ in range(8):
        resolved = _resolve_tree(tree, tree)
        if resolved == tree:
            return resolved
        tree = resolved
    return tree


# ---------------------------------------------------------------------------
# Overrides
# ---------------------------------------------------------------------------

def _parse_scalar(text: str) -> Any:
    import yaml  # only the CLI override path needs YAML scalars
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def apply_override(tree: Dict[str, Any], key: str, value: str) -> None:
    """Apply one dotted override; ``+``-prefixed keys may create new paths."""
    additive = key.startswith("+")
    if additive:
        key = key[1:]
    parts = key.split(".")
    node: Any = tree
    for part in parts[:-1]:
        if isinstance(node, list):
            node = node[int(part)]
        elif part in node:
            node = node[part]
        elif additive:
            node[part] = {}
            node = node[part]
        else:
            raise KeyError(
                f"Override path {key!r} not found at {part!r} (prefix with '+' to add)"
            )
    leaf = parts[-1]
    parsed = _parse_scalar(value)
    if isinstance(node, list):
        node[int(leaf)] = parsed
    else:
        if leaf not in node and not additive:
            raise KeyError(f"Override key {key!r} does not exist (prefix with '+' to add)")
        node[leaf] = parsed


def parse_overrides(args: List[str]) -> List[tuple]:
    pairs = []
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"Override {arg!r} must be key=value")
        k, v = arg.split("=", 1)
        pairs.append((k.strip(), v.strip()))
    return pairs


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

def load_yaml(path: Union[str, Path]) -> Dict[str, Any]:
    import yaml  # imported here so the package runs where pyyaml is absent
    with open(path, "r") as f:
        data = yaml.safe_load(f)
    return data or {}


def load_config(
    config_path: Union[str, Path],
    config_name: str,
    overrides: Optional[List[str]] = None,
) -> ConfigNode:
    """Load ``<config_path>/<config_name>.yaml``, apply overrides, resolve."""
    global _NOW
    _NOW = datetime.datetime.now()
    name = config_name if config_name.endswith((".yaml", ".yml")) else config_name + ".yaml"
    path = Path(config_path) / name
    if not path.exists():
        alt = Path(config_path) / (config_name + ".yml")
        if alt.exists():
            path = alt
        else:
            raise FileNotFoundError(f"Config file {path} not found")
    tree = load_yaml(path)
    for key, value in parse_overrides(overrides or []):
        if key in ("mode", "+mode"):
            # mode is consumed by the CLI, not part of the config schema
            continue
        apply_override(tree, key, value)
    return config_from_dict(tree)


def config_from_dict(tree: Dict[str, Any]) -> ConfigNode:
    """Resolve interpolations in a raw config tree and wrap it."""
    global _NOW
    if _NOW is None:
        _NOW = datetime.datetime.now()
    tree = resolve(copy.deepcopy(tree))
    # hydra block (run dir etc.) is accepted for YAML-surface parity but the
    # engine derives its run dir from the logger params instead.
    tree.pop("hydra", None)
    return ConfigNode(tree)
