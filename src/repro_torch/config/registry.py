"""Architecture registry: model id -> ``ModelConfig``.

Each module in ``repro_torch/configs/`` registers its configs at import
time; ``get_arch`` imports the package first, so callers just pass the id.
Every id of the reference resolves: the paper's CNN zoo and the dense
(qwen3-1.7b, qwen3-8b, glm4-9b, deepseek-67b), MoE (dbrx-132b,
kimi-k2-1t-a32b), hybrid (hymba-1.5b), SSM (xlstm-350m), audio
(musicgen-medium) and VLM (paligemma-3b) language models.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List

from repro_torch.config.base import ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register_arch(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def _ensure_loaded() -> None:
    importlib.import_module("repro_torch.configs")


def get_arch(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> List[str]:
    """Every registered id, sorted (the reference's list)."""
    _ensure_loaded()
    return sorted(_REGISTRY)
