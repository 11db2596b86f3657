"""Flash attention (prefill): the CUDA kernel's wrapper and its plain
versions.

GQA self-attention over a whole sequence with causal and/or sliding-window
masks: q (B, S, H, D), k and v (B, S, KV, D) -> (B, S, H, D) in q's dtype,
query head h reading kv-head h // (H // KV). Logits and softmax are
float32; masked logits are -1e30.

``flash_attention`` is a ``torch.autograd.Function``: its forward launches
``csrc/flash_attention.cu`` for CUDA tensors (counted in ``launches`` and,
by the variant ``kernel_variant`` names, in ``launches_by_variant``) and
runs ``attention_ref`` for CPU tensors; its backward is the autograd of
``attention_ref``, as the reference's ``custom_vjp`` is the VJP of its
oracle. There is no fallback: a CUDA tensor launches the named variant or
raises. In bfloat16 ``wgmma`` (TMA and wgmma) serves D in 64, 112, 128 and
256 (every model's prefill) and ``mma`` (mma.sync) D in 16 and 32; float32
takes ``simt``. ``launch_variant`` runs a named variant through the C entry
without counting, e.g. ``mma`` at D = 256 beside ``wgmma``.
``attention_ref`` is the reference's q-chunked oracle (``ref.attention``)
and ``attention_dense_ref`` its dense one (``ref.attention_dense``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.decode_attention import NEG_INF, softmax_scale

#: Forward calls that launched the kernel since the last reset (one per
#: call; the plain version and the backward do not count).
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
#: The kernel's variants, by the number the C entry takes.
VARIANTS = ("simt", "mma", "wgmma")
#: Head dims the wgmma variant serves (D = 112 as D = 128, zero-padded;
#: D = 256 with tiles of 64 keys).
WGMMA_HEAD_DIMS = (64, 112, 128, 256)
#: Head dims the mma variant serves; ``kernel_variant`` names it at 16 and
#: 32, and at 256 it runs only through ``launch_variant``.
MMA_HEAD_DIMS = (16, 32, 256)
#: The same launches split by variant.
launches_by_variant = dict.fromkeys(VARIANTS, 0)


def kernel_variant(dtype: torch.dtype, B: int, S: int, H: int, KV: int,
                   D: int, window: Optional[int]) -> str:
    """The variant of ``csrc/flash_attention.cu`` that serves this call:
    ``"simt"`` for float32; for bfloat16 ``"wgmma"`` (TMA and wgmma) at D in
    ``WGMMA_HEAD_DIMS`` (64, 112, 128 and 256) and ``"mma"`` (mma.sync) at
    the other head dims (16 and 32).
    TMA describes every B, S, H, KV and window at those head dims, so the
    rest of the shape does not enter the rule."""
    if dtype != torch.bfloat16:
        return "simt"
    return "wgmma" if D in WGMMA_HEAD_DIMS else "mma"


def serves(variant: str, dtype: torch.dtype, D: int) -> bool:
    """Whether the C entry takes ``variant`` for ``dtype`` at head dim
    ``D``: ``simt`` float32 at every head dim, ``mma`` bfloat16 at
    ``MMA_HEAD_DIMS``, ``wgmma`` bfloat16 at ``WGMMA_HEAD_DIMS``."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if variant == "simt":
        return dtype == torch.float32 and D in HEAD_DIMS
    dims = MMA_HEAD_DIMS if variant == "mma" else WGMMA_HEAD_DIMS
    return dtype == torch.bfloat16 and D in dims


def attention_dense_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Plain dense version (materialises the S x S logits), with the
    reference's cast points: logits in q's dtype cast to float32 and
    scaled, softmax in float32, probabilities cast to q's dtype."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    logits = logits * softmax_scale(D)
    idx = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= idx[:, None] >= idx[None, :]
    if window is not None:
        mask &= idx[:, None] - idx[None, :] < window
    logits = torch.where(mask[None, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", p, v)
    return out.reshape(B, S, H, D)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  q_chunk: int = 512, max_chunks: int = 16) -> torch.Tensor:
    """Plain q-chunked version (``ref.attention``): the same math as the
    dense one, chunk by chunk over the queries, each chunk over the key
    span its masks leave; k and v are repeated to the H query heads."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    qc = min(q_chunk, S)
    while S % qc:
        qc //= 2
    qc = max(qc, S // max_chunks if S % max_chunks == 0 else qc)
    scale = softmax_scale(D)
    outs = []
    for i in range(S // qc):
        q_lo = i * qc
        k_hi = (i + 1) * qc if causal else S
        k_lo = max(0, q_lo - (window - 1)) if window is not None else 0
        k_lo = (k_lo // qc) * qc
        logits = torch.einsum("bqhd,bkhd->bhqk", q[:, q_lo:q_lo + qc],
                              k[:, k_lo:k_hi]).float() * scale
        qpos = q_lo + torch.arange(qc, device=q.device)
        kpos = k_lo + torch.arange(k_hi - k_lo, device=q.device)
        mask = torch.ones((qc, k_hi - k_lo), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= qpos[:, None] - kpos[None, :] < window
        logits = torch.where(mask[None, None], logits, NEG_INF)
        p = torch.softmax(logits, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p, v[:, k_lo:k_hi]))
    return torch.cat(outs, dim=1)


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4:
        raise TypeError(f"q must be (B, S, H, D) and k, v (B, S, KV, D), got "
                        f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, S, H, D = q.shape
    if (tuple(k.shape) != tuple(v.shape) or k.shape[:2] != (B, S)
            or k.shape[3] != D):
        raise TypeError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                        f"match q {tuple(q.shape)}")
    if k.shape[2] < 1 or H % k.shape[2]:
        raise ValueError(f"H = {H} is not a multiple of KV = {k.shape[2]}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one of {list(DTYPES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def _entry():
    """The kernel's C entry point, built and typed at first use."""
    from repro_torch.kernels import build

    fn = build.load("flash_attention").attn_flash_fwd
    if fn.argtypes is None:  # ints would pass as 32-bit, cutting pointers
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _forward_cuda(q, k, v, causal: bool, window: Optional[int]):
    global launches
    B, S, H, D = q.shape
    KV = k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes D in {HEAD_DIMS}, got {D}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    variant = kernel_variant(q.dtype, B, S, H, KV, D, window)
    launch_variant(variant, q, k, v, out, causal, window)
    launches += 1
    launches_by_variant[variant] += 1
    return out


def launch_variant(variant: str, q, k, v, out, causal: bool,
                   window: Optional[int]) -> None:
    """One launch of ``variant`` through the C entry into ``out`` on
    checked, contiguous, 16-byte aligned CUDA inputs of one dtype; counts
    nothing (``flash_attention`` does). Refuses an unknown variant, a
    tensor off the card and a variant that does not serve the dtype and
    head dim (``serves``)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    if not serves(variant, q.dtype, D):
        raise ValueError(f"the {variant} variant does not serve {q.dtype} "
                         f"at D = {D}")
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        if x.device.type != "cuda":
            raise ValueError(f"launch_variant takes CUDA tensors; {name} is "
                             f"on {x.device}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  DTYPES[q.dtype], VARIANTS.index(variant), B, S, H, KV, D,
                  int(causal), 0 if window is None else int(window), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel ({variant}) launch "
                           f"failed: CUDA error {rc} at (B, S, H, KV, D) = "
                           f"({B}, {S}, {H}, {KV}, {D})")


class _Flash(torch.autograd.Function):
    """Forward: the kernel on the card, ``attention_ref`` on the CPU.
    Backward: the autograd of ``attention_ref`` on the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        if q.device.type == "cpu":
            return attention_ref(q, k, v, causal=causal, window=window)
        if q.device.type != "cuda":
            raise ValueError(f"flash_attention has no kernel for {q.device}")
        return _forward_cuda(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attention_ref(*leaves, causal=ctx.causal,
                                window=ctx.window)
            grads = torch.autograd.grad(out, leaves, grad)
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B, S, H, D), k and v (B, S, KV, D) -> (B, S, H, D) (see the
    module docstring); differentiable. CUDA tensors launch the kernel, CPU
    tensors take ``attention_ref``; a mix raises."""
    _check(q, k, v, window)
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"flash_attention inputs on several devices: "
                         f"{devices}")
    return _Flash.apply(q, k, v, bool(causal), window)
