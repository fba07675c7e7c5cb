"""Name → constructor registry (the port's copy of
`fac_fake_tpu/core/registry.py`).

The reference grows a model zoo by copy-pasting the whole CViT skeleton into
~30 files (SURVEY.md §2.2). Here every variant is a registered *assembly of
blocks*; one skeleton, many configs.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

_REGISTRIES: Dict[str, Dict[str, Callable[..., Any]]] = {}


def register(kind: str, name: str):
    def deco(fn):
        _REGISTRIES.setdefault(kind, {})
        if name in _REGISTRIES[kind]:
            raise KeyError(f"duplicate {kind} registration: {name}")
        _REGISTRIES[kind][name] = fn
        return fn
    return deco


def get(kind: str, name: str):
    try:
        return _REGISTRIES[kind][name]
    except KeyError:
        avail = sorted(_REGISTRIES.get(kind, {}))
        raise KeyError(f"unknown {kind} '{name}'; available: {avail}") from None


def available(kind: str):
    return sorted(_REGISTRIES.get(kind, {}))
