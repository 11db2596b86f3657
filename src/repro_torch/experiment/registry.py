"""Decorator-based component registries for the experiment layer.

Two axes are pluggable today — schedulers and runtimes — and both use the
same ``Registry``: a component module decorates its class/factory at import
time, and ``ExperimentSpec.build`` resolves names lazily. This replaces the
hand-maintained ``_SCHEDULERS`` dict that used to live in
``repro/core/schedulers/__init__.py`` and opens the runtime axis the same
way (``synthetic`` vs ``real_fl``; future: async fleets, trace replay).

This module is intentionally dependency-free (stdlib only) so the scheduler
modules in ``repro_torch.core`` can import it without a cycle: registration flows
core -> here, resolution flows experiment.spec -> here -> (lazy import of
the providing package).
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Optional


class Registry:
    """Name -> factory mapping with decorator registration.

    ``ensure``: dotted module whose import triggers registration of the
    built-in components .
    """

    def __init__(self, kind: str, ensure: Optional[str] = None):
        self.kind = kind
        self._ensure = ensure
        self._factories: Dict[str, Callable] = {}

    def register(self, name: str) -> Callable:
        def deco(factory: Callable) -> Callable:
            if name in self._factories and self._factories[name] is not factory:
                raise ValueError(
                    f"duplicate {self.kind} registration {name!r} "
                    f"({self._factories[name]!r} vs {factory!r})")
            self._factories[name] = factory
            return factory

        return deco

    def _load_builtins(self) -> None:
        if self._ensure is not None:
            importlib.import_module(self._ensure)

    def get(self, name: str) -> Callable:
        self._load_builtins()
        if name not in self._factories:
            raise KeyError(
                f"unknown {self.kind} {name!r}; known: {self.names()}")
        return self._factories[name]

    def create(self, name: str, *args, **kwargs):
        return self.get(name)(*args, **kwargs)

    def names(self) -> List[str]:
        self._load_builtins()
        return sorted(self._factories)

    def __contains__(self, name: str) -> bool:
        self._load_builtins()
        return name in self._factories


SCHEDULERS = Registry("scheduler", ensure="repro_torch.core.schedulers")
RUNTIMES = Registry("runtime", ensure="repro_torch.experiment.runtimes")

register_scheduler = SCHEDULERS.register
register_runtime = RUNTIMES.register
