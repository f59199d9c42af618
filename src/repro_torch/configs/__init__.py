"""Config registry: ``get_config(name)``, ``get_smoke_config(name)``.

Every architecture of the JAX package: the dense decoders (llama2-7b,
gemma-2b, glm4-9b, qwen3-14b, qwen1.5-32b), the MoE decoders olmoe-1b-7b
and dbrx-132b, the vision-language internvl2-1b, the sub-quadratic
mamba2-370m and recurrentgemma-9b, and the encoder-decoder
whisper-medium. ``ASSIGNED_ARCHS`` (every one but llama2-7b, the paper's
own subject, in the JAX package's order) and ``SHAPES`` span the dry
run's cells; ``shape_applicable`` drops the full-attention ones at
``long_500k``.
"""
from __future__ import annotations

import importlib

from typing import Dict, List

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      get_shape)

_MODULES = {
    "llama2-7b": "repro_torch.configs.llama2_7b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "qwen1.5-32b": "repro_torch.configs.qwen15_32b",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
}


ASSIGNED_ARCHS: List[str] = [
    "internvl2-1b", "recurrentgemma-9b", "glm4-9b", "qwen1.5-32b", "gemma-2b",
    "qwen3-14b", "mamba2-370m", "olmoe-1b-7b", "dbrx-132b", "whisper-medium"]


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {k: get_config(k) for k in _MODULES}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Cell-applicability rules of the dry run."""
    if shape.name == "long_500k" and not cfg.sub_quadratic():
        return False  # pure full-attention archs skip long-context decode
    return True


__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "get_shape", "get_config",
    "get_smoke_config", "all_configs", "ASSIGNED_ARCHS", "shape_applicable",
]
