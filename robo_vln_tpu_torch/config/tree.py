"""Layered, freezable configuration trees (the port's own copy of
robo_vln_tpu/config/tree.py; the port imports nothing of the JAX package).

Re-implements the two-level yacs semantics the reference relies on
(/root/reference/robo_vln_baselines/config/default.py:263-290 and
/root/reference/habitat_extensions/config/default.py:119-144): a tree of
defaults, merged with YAML files, then with dot-path CLI overrides, then
frozen.  Unlike yacs this is a ~200-line dependency-free implementation with
explicit clone/defrost/freeze so trainers can use the same mutation idiom the
reference uses throughout (e.g. robo_vln_trainer.py:848-868).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterator, List, Optional, Union


class ConfigTree:
    """An attribute-accessible, freezable nested config node."""

    __slots__ = ("_data", "_frozen")

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        object.__setattr__(self, "_frozen", False)
        if data:
            for k, v in data.items():
                self._data[k] = ConfigTree(v) if isinstance(v, dict) else v

    # pickling and deep copies set the slots directly, past the frozen check
    # of __setattr__ (a policy holding its config is sent to spawned ranks)
    def __getstate__(self):
        return {"_data": self._data, "_frozen": self._frozen}

    def __setstate__(self, state) -> None:
        object.__setattr__(self, "_data", state["_data"])
        object.__setattr__(self, "_frozen", state["_frozen"])

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._data[name]
        except KeyError:
            raise AttributeError(f"Config has no key {name!r}") from None

    def __setattr__(self, name: str, value: Any) -> None:
        if self._frozen:
            raise AttributeError(
                f"Cannot set {name!r}: config is frozen (call .defrost() first)"
            )
        if isinstance(value, dict):
            value = ConfigTree(value)
        self._data[name] = value

    def __getitem__(self, name: str) -> Any:
        return self._data[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self.__setattr__(name, value)

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def get(self, name: str, default: Any = None) -> Any:
        return self._data.get(name, default)

    # -- freeze / clone ------------------------------------------------------
    def freeze(self) -> "ConfigTree":
        object.__setattr__(self, "_frozen", True)
        for v in self._data.values():
            if isinstance(v, ConfigTree):
                v.freeze()
        return self

    def defrost(self) -> "ConfigTree":
        object.__setattr__(self, "_frozen", False)
        for v in self._data.values():
            if isinstance(v, ConfigTree):
                v.defrost()
        return self

    @property
    def is_frozen(self) -> bool:
        return self._frozen

    def clone(self) -> "ConfigTree":
        out = ConfigTree()
        for k, v in self._data.items():
            out._data[k] = v.clone() if isinstance(v, ConfigTree) else copy.deepcopy(v)
        return out

    # -- merging -------------------------------------------------------------
    def merge_dict(self, other: Dict[str, Any], allow_new: bool = True) -> None:
        """Recursively merge a plain dict into this tree."""
        if self._frozen:
            raise AttributeError("Cannot merge into a frozen config")
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self._data.get(k), ConfigTree):
                self._data[k].merge_dict(v, allow_new=allow_new)
            else:
                if not allow_new and k not in self._data:
                    raise KeyError(f"Unknown config key {k!r}")
                self._data[k] = ConfigTree(v) if isinstance(v, dict) else v

    def merge_from_file(self, path: str) -> None:
        import yaml

        with open(path, "r") as f:
            loaded = yaml.safe_load(f) or {}
        self.merge_dict(loaded)

    def merge_from_list(self, opts: List[Any]) -> None:
        """Merge ['A.B.C', value, ...] pairs (the CLI trailing-opts idiom,
        reference run.py:31-36)."""
        if len(opts) % 2 != 0:
            raise ValueError(f"Override list must be key/value pairs, got {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = getattr(node, p)
            leaf = parts[-1]
            if isinstance(value, str):
                value = _coerce(value, node._data.get(leaf))
            node._data[parts[-1]] = value

    # -- export --------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            k: (v.to_dict() if isinstance(v, ConfigTree) else v)
            for k, v in self._data.items()
        }

    def __repr__(self) -> str:
        return f"ConfigTree({self.to_dict()!r})"

    def dump_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)


def _coerce(value: str, reference: Any) -> Any:
    """Coerce a CLI string to the type of the existing value if possible."""
    if isinstance(reference, bool):
        return value.lower() in ("1", "true", "yes", "on")
    for cast in (int, float):
        if isinstance(reference, cast):
            try:
                return cast(value)
            except ValueError:
                pass
    import yaml

    if reference is None or isinstance(reference, str):
        try:
            return yaml.safe_load(value)
        except Exception:
            return value
    if isinstance(reference, (list, tuple)):
        loaded = yaml.safe_load(value)
        return list(loaded) if isinstance(loaded, (list, tuple)) else [loaded]
    return value


Config = ConfigTree  # alias used across the package
