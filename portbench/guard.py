"""The import guard: no module of JAX or of the JAX package may be loaded.

Modules are compared by their top-level name, the part before the first
dot, whole: ``repro_torch`` is the port, ``repro`` the JAX package.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def check(where: str) -> None:
    """Raise naming what was found, if anything forbidden is loaded."""
    found = forbidden_loaded()
    if found:
        raise ImportError(f"{where}: forbidden modules loaded: "
                          + ", ".join(found[:20]))
