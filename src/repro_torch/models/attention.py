"""GQA attention block: init, prefill apply, and KV-cache decode.

Routes the inner product through ``kernels/ops.py``, so the same module
runs the hand-written kernels (``cuda``, the default: flash attention for
prefill, decode attention for one-token steps) or their plain versions
(``ref``). Params follow the reference's layout (``repro/models/
attention.py``).

``attention_decode`` writes the new token's k and v into the cache IN
PLACE and returns the same cache (the reference returns updated copies,
and its serving step donates the old ones); a write at a position >= T is
dropped, as JAX drops an out-of-bounds scatter.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.config.base import AttentionKind, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import normal, ones, param_dtype, rope, \
    use_param

QK_NORM_EPS = 1e-6  # the reference hard-codes it (not cfg.norm_eps)


def attention_init(cfg: ModelConfig, rng: np.random.Generator):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = 1.0 / np.sqrt(d)
    pd = param_dtype(cfg)
    p = {
        "wq": normal(rng, (d, h * hd), s, pd),
        "wk": normal(rng, (d, kv * hd), s, pd),
        "wv": normal(rng, (d, kv * hd), s, pd),
        "wo": normal(rng, (h * hd, d), 1.0 / np.sqrt(h * hd), pd),
    }
    if cfg.qk_norm:
        p["q_norm"] = ones((hd,), pd)
        p["k_norm"] = ones((hd,), pd)
    return p


def _qk_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = QK_NORM_EPS) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _project_qkv(cfg: ModelConfig, p, x: torch.Tensor,
                 positions: torch.Tensor):
    B, S, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    q = (x @ use_param(p["wq"], dt)).reshape(B, S, h, hd)
    k = (x @ use_param(p["wk"], dt)).reshape(B, S, kv, hd)
    v = (x @ use_param(p["wv"], dt)).reshape(B, S, kv, hd)
    if cfg.qk_norm:
        q = _qk_norm(q, p["q_norm"])
        k = _qk_norm(k, p["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_apply(cfg: ModelConfig, p, x: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """Causal self-attention over the full sequence (prefill)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions)
    window = (cfg.sliding_window if cfg.attention == AttentionKind.SLIDING
              else None)
    out = ops.attention(q, k, v, causal=True, window=window)
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    return out @ use_param(p["wo"], x.dtype)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """Zero k and v caches for every layer, stacked: (L, B, T, kv, hd),
    with T = min(max_len, sliding_window) for sliding-window archs."""
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    if cfg.attention == AttentionKind.SLIDING:
        max_len = min(max_len, cfg.sliding_window)
    shape = (cfg.num_layers, batch, max_len, kv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _write_row(cache: torch.Tensor, slot: torch.Tensor,
               row: torch.Tensor) -> None:
    """cache[b, slot[b]] = row[b] where 0 <= slot[b] < T; other rows are
    dropped. Sync-free: a dropped row writes back what its clamped slot
    held."""
    T = cache.shape[1]
    bidx = torch.arange(cache.shape[0], device=cache.device)
    keep = (slot >= 0) & (slot < T)
    at = slot.clamp(0, T - 1).long()
    cache[bidx, at] = torch.where(keep[:, None, None], row, cache[bidx, at])


def attention_decode(cfg: ModelConfig, p, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], length: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: (B,1,d); cache k/v: (B,T,kv,hd); length: (B,)
    int32. Sliding-window archs use a ring buffer of size
    ``sliding_window`` (the cache position is length % window); full
    attention writes at ``length``."""
    B = x.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    positions = length[:, None]  # (B,1) absolute position of the new token
    q, k, v = _project_qkv(cfg, p, x, positions)
    T = cache["k"].shape[1]
    slot = length % T if cfg.attention == AttentionKind.SLIDING else length
    _write_row(cache["k"], slot, k[:, 0])
    _write_row(cache["v"], slot, v[:, 0])
    eff_len = torch.clamp(length + 1, max=T).to(torch.int32)
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], eff_len)
    y = out.reshape(B, 1, h * hd) @ use_param(p["wo"], x.dtype)
    return y, cache
