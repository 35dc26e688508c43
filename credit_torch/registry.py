"""Extension registries (port of credit_tpu/registry.py): plain dict
registries filled by a decorator, looked up by config name."""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict

_REGISTRIES: Dict[str, Dict[str, Any]] = {
    "model": {},
    "dataset": {},
    "loss": {},
    "preblock": {},
    "postblock": {},
    "trainer": {},
    "scheduler": {},
    "skebs_net": {},
}


def register(kind: str, name: str) -> Callable:
    """Decorator: register a class/function under `kind` registry as `name`."""
    reg = _REGISTRIES[kind]

    def deco(obj):
        reg[name] = obj
        return obj

    return deco


def get(kind: str, name: str) -> Any:
    reg = _REGISTRIES[kind]
    if name not in reg:
        raise KeyError(
            f"Unknown {kind} '{name}'. Registered: {sorted(reg)}. "
            f"Register custom objects via config `custom_objects.{kind}`.")
    return reg[name]


def available(kind: str):
    return sorted(_REGISTRIES[kind])


def import_string(path: str) -> Any:
    """Import `pkg.mod:attr` or `pkg.mod.attr`."""
    if ":" in path:
        mod, attr = path.split(":", 1)
    else:
        mod, _, attr = path.rpartition(".")
    return getattr(importlib.import_module(mod), attr)


def load_custom_objects(conf: dict) -> None:
    """Import and register user classes declared in the config under
    `custom_objects: {registry: {name: "pkg.mod:Class"}}`."""
    custom = (conf or {}).get("custom_objects") or {}
    for kind, entries in custom.items():
        if kind not in _REGISTRIES:
            raise KeyError(f"custom_objects: unknown registry '{kind}'")
        for name, path in (entries or {}).items():
            _REGISTRIES[kind][name] = import_string(path)
