"""Architecture registry of the port. Only ``ternary-paper`` is registered
so far; ``get_config(name, reduced=True)`` gives the CPU-test reduction."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = ["ternary_paper"]


def _registry() -> Dict[str, ModelConfig]:
    out = {}
    for mod in _ARCH_MODULES:
        cfg = importlib.import_module(f"repro_torch.configs.{mod}").CONFIG
        out[cfg.name] = cfg
    return out


def get_config(name: str, reduced: bool = False, **overrides) -> ModelConfig:
    registry = _registry()
    name = name.replace("_", "-")
    if name not in registry:
        raise KeyError(f"unknown arch {name!r}; the port registers "
                       f"{sorted(registry)}")
    cfg = registry[name]
    if reduced:
        cfg = cfg.reduced()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


__all__ = ["get_config", "ModelConfig"]
