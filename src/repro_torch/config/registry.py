"""Architecture registry: model id -> ``ModelConfig``.

Each module in ``repro_torch/configs/`` registers its configs at import
time; ``get_arch`` imports the package first, so callers just pass the id.
The reference's language-model ids are known but not ported: they raise
``NotImplementedError`` naming ROADMAP module 10, never ``KeyError``.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List

from repro_torch.config.base import ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}

#: The reference's LLM zoo (``repro/configs/<arch>.py``), ROADMAP module 10.
LLM_ARCHS = ("qwen3-1.7b", "qwen3-8b", "deepseek-67b", "glm4-9b",
             "musicgen-medium", "dbrx-132b", "kimi-k2-1t-a32b", "hymba-1.5b",
             "xlstm-350m", "paligemma-3b")


def register_arch(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def _ensure_loaded() -> None:
    importlib.import_module("repro_torch.configs")


def get_arch(name: str) -> ModelConfig:
    _ensure_loaded()
    if name in LLM_ARCHS:
        raise NotImplementedError(
            f"arch {name!r}: the language-model zoo is ROADMAP module 10, "
            "not ported yet")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> List[str]:
    """The ids ``get_arch`` resolves (the ported ones)."""
    _ensure_loaded()
    return sorted(_REGISTRY)
