"""Architecture registry of the port: one module per architecture, the
same eleven as ``repro.configs``. ``get_config(name)`` returns the full
published config; ``get_config(name, reduced=True)`` the CPU-test
reduction."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

_ARCH_MODULES = [
    "seamless_m4t_large_v2",
    "mistral_nemo_12b",
    "command_r_35b",
    "granite_3_8b",
    "deepseek_coder_33b",
    "jamba_v0_1_52b",
    "kimi_k2_1t_a32b",
    "mixtral_8x22b",
    "mamba2_130m",
    "internvl2_76b",
    "ternary_paper",
]

REGISTRY: Dict[str, ModelConfig] = {}


def _load() -> None:
    if REGISTRY:
        return
    for mod in _ARCH_MODULES:
        cfg = importlib.import_module(f"repro_torch.configs.{mod}").CONFIG
        REGISTRY[cfg.name] = cfg


def list_archs() -> List[str]:
    _load()
    return sorted(REGISTRY)


def get_config(name: str, reduced: bool = False, **overrides) -> ModelConfig:
    _load()
    name = name.replace("_", "-")
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; registered: "
                       f"{sorted(REGISTRY)}")
    cfg = REGISTRY[name]
    if reduced:
        cfg = cfg.reduced()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


__all__ = ["get_config", "list_archs", "REGISTRY", "SHAPES", "ModelConfig",
           "ShapeConfig"]
