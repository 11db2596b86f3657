"""Kernel dispatch: ``impl="ref"`` (plain PyTorch) or ``impl="cuda"``.

Mirrors the reference's dispatch (``ref | pallas | interpret``) for the
kernels this port has. ``cuda`` launches the hand-written kernel on CUDA
tensors; on CPU tensors its wrapper runs the plain version, and that only
because the tensors lie on the CPU. There is no ``emulate`` mode: a PyTorch
restatement of the kernel's tiling would prove nothing about the CUDA code.
"""

from __future__ import annotations

from repro_torch.kernels import sched_score
from repro_torch.kernels import scatter_add as _scatter

VALID = ("ref", "cuda")


def _check(impl: str) -> None:
    if impl not in VALID:
        raise ValueError(f"impl {impl!r} not in {VALID}")


def sched_plan_stats(times, weights, plans, impl: str = "ref"):
    """Per-plan scoring stats for the scheduler core (see core/scoring.py)."""
    _check(impl)
    if impl == "ref":
        return sched_score.plan_stats_ref(times, weights, plans)
    return sched_score.plan_stats(times, weights, plans)


def scatter_add(vals, idx, weights, size: int, impl: str = "cuda"):
    """Weighted sparse accumulation (compressed-FedAvg server
    decompression): (n, k) vals/idx + (n,) weights -> (size,) f32; see
    kernels/scatter_add.py for the semantics (negative idx = padding)."""
    _check(impl)
    if impl == "ref":
        return _scatter.scatter_add_ref(vals, idx, weights, size)
    return _scatter.scatter_add(vals, idx, weights, size)
