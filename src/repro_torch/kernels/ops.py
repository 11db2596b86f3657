"""Kernel dispatch: ``impl="ref"`` (plain PyTorch) or ``impl="cuda"``.

Mirrors the reference's dispatch (``ref | pallas | interpret``) for the
kernels this port has. ``cuda`` launches the hand-written kernel on CUDA
tensors; on CPU tensors its wrapper runs the plain version, and that only
because the tensors lie on the CPU. There is no ``emulate`` mode: a PyTorch
restatement of the kernel's tiling would prove nothing about the CUDA code.

``set_default_impl`` flips the LLM zoo's attention (``attention``,
``decode_attention``) between the kernels (``cuda``, the default) and the
plain versions (``ref``), so a whole model can be checked against itself on
the card; a call's own ``impl=`` wins.
"""

from __future__ import annotations

import threading
from typing import Optional

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import sched_score
from repro_torch.kernels import scatter_add as _scatter

VALID = ("ref", "cuda")
_state = threading.local()


def _check(impl: str) -> None:
    if impl not in VALID:
        raise ValueError(f"impl {impl!r} not in {VALID}")


def set_default_impl(impl: str) -> None:
    _check(impl)
    _state.impl = impl


def get_default_impl() -> str:
    return getattr(_state, "impl", "cuda")


def _resolve(impl: Optional[str]) -> str:
    impl = get_default_impl() if impl is None else impl
    _check(impl)
    return impl


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


def attention(q, k, v, causal: bool = True, window: Optional[int] = None,
              impl: Optional[str] = None):
    """GQA prefill attention, (B,S,H,D) x (B,S,KV,D) -> (B,S,H,D); see
    kernels/flash_attention.py."""
    if _resolve(impl) == "ref":
        return _flash.attention_ref(q, k, v, causal=causal, window=window)
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, length, impl: Optional[str] = None):
    """One query token per sequence against its KV cache, (B,H,D) x
    (B,T,KV,D) with (B,) lengths -> (B,H,D); see
    kernels/decode_attention.py."""
    if _resolve(impl) == "ref":
        return _decode.decode_attention_ref(q, k_cache, v_cache, length)
    return _decode.decode_attention(q, k_cache, v_cache, length)
