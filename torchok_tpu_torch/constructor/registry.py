"""Component registry.

Name -> class registries with wildcard listing, mirroring the behavior of the
reference registry (reference: torchok/constructor/registry.py:10-138). The
PyTorch port keeps its own instances under the same registry names as
``torchok_tpu``, so one YAML names the same components in both packages.
"""
from __future__ import annotations

import fnmatch
import re
import sys
from typing import Any, Dict, Iterable, List, Optional


def _natural_key(s: str) -> List[Any]:
    """Sort key that orders embedded integers numerically."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s.lower())]


class Registry:
    """A name -> class mapping for a component family.

    Supports decorator registration, duplicate-name protection, wildcard
    listing, and automatic ``__all__`` append on the defining module.
    """

    def __init__(self, name: str):
        self._name = name
        self._entries: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return self._name

    @property
    def entries(self) -> Dict[str, Any]:
        return dict(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def __repr__(self) -> str:
        return f"Registry(name={self._name}, items={sorted(self._entries)})"

    def get(self, key: str) -> Any:
        """Look up a registered class, raising with suggestions on miss."""
        if key not in self._entries:
            close = [k for k in self._entries if key.lower() in k.lower()]
            hint = f" Did you mean one of {close}?" if close else ""
            raise KeyError(
                f"{key!r} is not registered in the {self._name} registry.{hint}"
            )
        return self._entries[key]

    def register_class(self, cls: Any = None, *, name: Optional[str] = None):
        """Register a class or function, usable as a decorator."""
        def _do_register(obj):
            key = name or obj.__name__
            if key in self._entries:
                raise KeyError(
                    f"{key!r} is already registered in the {self._name} registry"
                )
            self._entries[key] = obj
            mod = sys.modules.get(getattr(obj, "__module__", None))
            if mod is not None:
                if hasattr(mod, "__all__"):
                    if key not in mod.__all__:
                        mod.__all__.append(key)
                else:
                    mod.__all__ = [key]
            return obj

        if cls is None:
            return _do_register
        return _do_register(cls)

    def register_many(self, objs: Iterable[Any], prefix: str = "") -> None:
        for obj in objs:
            self.register_class(obj, name=f"{prefix}{obj.__name__}")

    def list_models(self, filter: str = "", exclude_filters: Any = "") -> List[str]:
        """List registered names with optional wildcard include/exclude filters."""
        names = list(self._entries)
        if filter:
            names = fnmatch.filter(names, filter)
        if exclude_filters:
            if isinstance(exclude_filters, str):
                exclude_filters = [exclude_filters]
            for xf in exclude_filters:
                excluded = set(fnmatch.filter(names, xf))
                names = [n for n in names if n not in excluded]
        return sorted(names, key=_natural_key)
