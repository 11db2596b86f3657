"""Kernel dispatch: ``impl="ref"`` (plain PyTorch) or ``impl="cuda"``.

Mirrors the reference's dispatch (``ref | pallas | interpret``) for the
kernels this port has. ``cuda`` launches the hand-written kernel on CUDA
tensors; on CPU tensors its wrapper runs the plain version, and that only
because the tensors lie on the CPU. There is no ``emulate`` mode: a PyTorch
restatement of the kernel's tiling would prove nothing about the CUDA code.

``set_default_impl`` flips the LLM zoo's kernels (``attention``,
``decode_attention``, ``moe_gmm``, ``linear_scan``, ``rmsnorm``) between
the kernels (``cuda``, the default) and the plain versions (``ref``), so a
whole model can be checked against itself on the card; a call's own
``impl=`` wins. ``linear_scan_step`` (one decode step) has no kernel, as in
the reference.

Under autograd only ``attention`` launches its kernel: flash attention's
backward is the autograd of its plain version, as the reference's
``custom_vjp`` is the VJP of its oracle. ``moe_gmm`` and ``linear_scan``
have no VJP in the reference and no backward pass here; asked for a
gradient on the card they raise ``NoKernelGradError``, so a MoE, hybrid or
SSM model trains on the card under ``impl="ref"``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels import sched_score
from repro_torch.kernels import scatter_add as _scatter
from repro_torch.kernels import ssm_scan as _scan

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


@contextlib.contextmanager
def default_impl(impl: str):
    """``set_default_impl(impl)`` for the body, the previous one after."""
    prev = get_default_impl()
    set_default_impl(impl)
    try:
        yield
    finally:
        set_default_impl(prev)


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


def moe_gmm(xg, wg, impl: Optional[str] = None):
    """Grouped expert matmul, (E, C, din) x (E, din, dout) -> (E, C, dout);
    see kernels/moe_gmm.py."""
    if _resolve(impl) == "ref":
        return _gmm.moe_gmm_ref(xg, wg)
    return _gmm.moe_gmm(xg, wg)


def linear_scan(q, k, v, decay, init_state=None, impl: Optional[str] = None,
                want_final_state: bool = True):
    """Gated linear recurrence over a sequence -> (y, (S, n) or None); see
    kernels/ssm_scan.py. ``ref`` is the chunked plain form from a zero
    state and the sequential oracle from ``init_state``; the kernel starts
    from a zero state (prefill) and forms the final state only when
    ``want_final_state``."""
    if _resolve(impl) == "ref":
        if init_state is not None:
            return _scan.linear_scan_ref(q, k, v, decay, init_state)
        y, state = _scan.linear_scan_chunked_ref(q, k, v, decay)
        return y, (state if want_final_state else None)
    if init_state is not None:
        raise ValueError("the linear_scan kernel starts from a zero state "
                         "(prefill); decode steps use linear_scan_step")
    return _scan.linear_scan(q, k, v, decay, want_final_state)


def linear_scan_step(q, k, v, decay, state):
    """One decode step of linear_scan (plain only: O(1) work, no kernel)."""
    return _scan.linear_scan_step(q, k, v, decay, state)


def rmsnorm(x, scale, eps: float = 1e-6, impl: Optional[str] = None):
    """Row-wise RMSNorm of x (..., d) by scale (d,); see
    kernels/rmsnorm.py."""
    if _resolve(impl) == "ref":
        return _rmsnorm.rmsnorm_ref(x, scale, eps)
    return _rmsnorm.rmsnorm(x, scale, eps)
