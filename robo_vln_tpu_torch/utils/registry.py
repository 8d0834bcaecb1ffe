"""Minimal component registry (baseline_registry equivalent); the port's own
copy of robo_vln_tpu/utils/registry.py.

The reference resolves trainers by name through habitat's baseline_registry
(run.py:66, robo_vln_trainer.py:294).  Same contract: register under a string
key, look up at dispatch time.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

_REGISTRIES: Dict[str, Dict[str, Callable]] = {}


def _get(kind: str) -> Dict[str, Callable]:
    return _REGISTRIES.setdefault(kind, {})


def register(kind: str, name: Optional[str] = None):
    def deco(cls):
        _get(kind)[name or cls.__name__] = cls
        return cls

    return deco


def lookup(kind: str, name: str):
    reg = _get(kind)
    if name not in reg:
        raise KeyError(f"No {kind} registered under {name!r}; have {sorted(reg)}")
    return reg[name]


def register_trainer(name: str):
    return register("trainer", name)


def get_trainer(name: str):
    return lookup("trainer", name)
