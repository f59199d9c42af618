"""Config registry: ``get_config(name)``, ``get_smoke_config(name)``.

Only llama2-7b is registered so far; the other architectures of the JAX
package arrive with the slices that port their layers (ROADMAP.md,
queue 1, slice C).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "llama2-7b": "repro_torch.configs.llama2_7b",
}

# the JAX package's other architectures, ported with their layers
_LATER = ("internvl2-1b", "recurrentgemma-9b", "glm4-9b", "qwen1.5-32b",
          "gemma-2b", "qwen3-14b", "mamba2-370m", "olmoe-1b-7b",
          "dbrx-132b", "whisper-medium")


def _module(name: str):
    if name in _LATER:
        raise NotImplementedError(
            f"arch {name!r} is ported with its layers (ROADMAP queue 1, "
            f"items 11-14)")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


__all__ = ["ModelConfig", "get_config", "get_smoke_config"]
