"""Decode attention: the CUDA kernel's wrapper and its plain version.

One new query token per sequence against its KV cache, masked by each
sequence's valid length (the serving loop's inner product):

    out[b, h] = softmax_t(q[b, h] . k[b, t, h // G] / sqrt(D)) v[b, t, h // G]

over t < length[b]; q (B, H, D), caches (B, T, KV, D), length (B,) ->
(B, H, D) in q's dtype, G = H // KV. Logits and softmax are float32. A row
with length <= 0 masks every logit to -1e30, so its softmax is uniform over
all T rows (the mean of v), as in the reference oracle.

``decode_attention`` launches ``csrc/decode_attention.cu`` for CUDA tensors
and counts each call that launched in ``launches`` and, by the variant
``kernel_variant`` names, in ``launches_by_variant``; for CPU tensors it is
``decode_attention_ref``, the plain PyTorch version. There is no fallback:
a CUDA tensor launches the named variant or raises. The kernel reads only
each row's valid prefix (all T rows when length <= 0), so rows past the
length never touch the result, whatever they hold.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30

#: Wrapper calls that launched the kernel since the last reset (one per
#: call; the plain version does not count).
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
MAX_GROUP = 32          # query heads per kv-head the kernel takes
TMA_MAX_GROUP = 16      # ... and its tma variant (one 16-row mma tile)
TMA_HEAD_DIMS = (64, 112, 128, 256)  # whole 64-column boxes of a tensor map
TILE = 64               # cache rows per tile (chunks are multiples of it)
MIN_CHUNK = 256         # smallest split of a prefix
#: Blocks each variant's split plan aims for: the tma variant keeps 2
#: blocks an SM busy for about two waves; the simt plan is the one that
#: variant had before the tma variant existed.
TARGET_BLOCKS = {"tma": 512, "simt": 2048}
#: The kernel's variants, by the number the C entry takes.
VARIANTS = ("simt", "tma")
#: The same launches split by variant.
launches_by_variant = dict.fromkeys(VARIANTS, 0)


def kernel_variant(dtype: torch.dtype, B: int, H: int, KV: int, D: int,
                   T: int) -> str:
    """The variant of ``csrc/decode_attention.cu`` that serves this call:
    ``"tma"`` (a TMA ring of K/V tiles and mma.sync) for bfloat16 at D in
    ``TMA_HEAD_DIMS`` (every model's) with at most ``TMA_MAX_GROUP`` query
    heads per kv-head, ``"simt"`` otherwise (float32, and bfloat16 at
    larger groups or D < 64). Every B and T are served by both, so they do
    not enter the rule."""
    if (dtype == torch.bfloat16 and D in TMA_HEAD_DIMS
            and H // max(KV, 1) <= TMA_MAX_GROUP):
        return "tma"
    return "simt"


def softmax_scale(d: int) -> float:
    """1 / sqrt(d) rounded to float32, as the reference computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         length: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, with the reference oracle's cast points
    (``repro/kernels/ref.py::decode_attention``): logits in q's dtype cast
    to float32 and scaled, softmax in float32, probabilities cast back to
    q's dtype before the PV product."""
    B, H, D = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, D)
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k_cache).float()
    logits = logits * softmax_scale(D)
    valid = (torch.arange(T, device=q.device)[None, :]
             < length.to(q.device)[:, None])
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", p, v_cache)
    return out.reshape(B, H, D)


def split_plan(B: int, KV: int, T: int, variant: str = "tma",
               target: Optional[int] = None, min_chunk: int = MIN_CHUNK):
    """(nsplit, chunk): how ``variant`` cuts each sequence's cache. One
    block per (sequence, kv-head, chunk); chunks multiply until the blocks
    reach ``target`` (``TARGET_BLOCKS[variant]``), but stay at least
    ``min_chunk`` rows. The tma plan was tuned on the H100 by
    ``scripts/tune_decode_scan.py``, which sweeps both: 4 splits at qwen3's
    and hymba's 16 slots, 1 at the decode_32k layer."""
    target = TARGET_BLOCKS[variant] if target is None else target
    want = -(-target // max(B * KV, 1))
    nsplit = max(1, min(want, -(-T // min_chunk)))
    chunk = -(-T // nsplit)
    chunk = -(-chunk // TILE) * TILE
    return -(-T // chunk), chunk


def _check(q, k_cache, v_cache, length):
    if q.dim() != 3 or k_cache.dim() != 4:
        raise TypeError(f"q must be (B, H, D) and the caches (B, T, KV, D), "
                        f"got {tuple(q.shape)} and {tuple(k_cache.shape)}")
    B, H, D = q.shape
    if (tuple(k_cache.shape) != tuple(v_cache.shape)
            or k_cache.shape[0] != B or k_cache.shape[3] != D):
        raise TypeError(f"caches {tuple(k_cache.shape)} and "
                        f"{tuple(v_cache.shape)} do not match q "
                        f"{tuple(q.shape)}")
    KV = k_cache.shape[2]
    if KV < 1 or H % KV:
        raise ValueError(f"H = {H} is not a multiple of KV = {KV}")
    if q.dtype not in DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"q and the caches must share one of {list(DTYPES)},"
                        f" got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if tuple(length.shape) != (B,) or length.dtype.is_floating_point:
        raise TypeError(f"length must be a ({B},) integer tensor, got "
                        f"{tuple(length.shape)} {length.dtype}")


def _entry():
    """The kernel's C entry point, built and typed at first use."""
    from repro_torch.kernels import build

    fn = build.load("decode_attention").attn_decode
    if fn.argtypes is None:  # ints would pass as 32-bit, cutting pointers
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """q (B, H, D), caches (B, T, KV, D), length (B,) -> (B, H, D) (see the
    module docstring). CUDA tensors launch the kernel (length int32 on the
    same card); CPU tensors take ``decode_attention_ref``; a mix raises."""
    global launches
    _check(q, k_cache, v_cache, length)
    devices = {q.device, k_cache.device, v_cache.device, length.device}
    if len(devices) != 1:
        raise ValueError(f"decode_attention inputs on several devices: "
                         f"{devices}")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, length)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention has no kernel for {q.device}")
    B, H, D = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    if D not in HEAD_DIMS or H // KV > MAX_GROUP:
        raise ValueError(f"the kernel takes D in {HEAD_DIMS} and at most "
                         f"{MAX_GROUP} query heads per kv-head, got D = {D}, "
                         f"G = {H // KV}")
    if length.dtype != torch.int32:
        raise TypeError(f"length must be int32 on the card, got "
                        f"{length.dtype}")
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("length", length)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if T == 0:
        raise ValueError("decode_attention needs a cache of T >= 1 rows")
    out = torch.empty_like(q)
    if B * H == 0:
        return out
    variant = kernel_variant(q.dtype, B, H, KV, D, T)
    launch_variant(variant, q, k_cache, v_cache, length, out)
    launches += 1
    launches_by_variant[variant] += 1
    return out


def launch_variant(variant: str, q, k_cache, v_cache, length, out,
                   plan=None) -> None:
    """One launch of ``variant`` through the C entry on checked CUDA
    inputs, with ``plan`` = (nsplit, chunk) from ``split_plan`` (its
    defaults where None; other targets when the plan is tuned); counts
    nothing (``decode_attention`` does)."""
    B, H, D = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    nsplit, chunk = plan or split_plan(B, KV, T, variant)
    part = (torch.empty(B * H * nsplit * (D + 2), dtype=torch.float32,
                        device=q.device) if nsplit > 1 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _entry()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  length.data_ptr(), out.data_ptr(),
                  part.data_ptr() if part is not None else None,
                  DTYPES[q.dtype], VARIANTS.index(variant), B, H, KV, T, D,
                  nsplit, chunk, stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel ({variant}) launch "
                           f"failed: CUDA error {rc} at (B, H, KV, T, D) = "
                           f"({B}, {H}, {KV}, {T}, {D})")
