"""GQA attention block: init, prefill apply, and KV-cache decode.

Routes the inner product through ``kernels/ops.py``, so the same module
runs the hand-written kernels (``cuda``, the default: flash attention for
prefill, decode attention for one-token steps) or their plain versions
(``ref``). Params follow the reference's layout (``repro/models/
attention.py``).

Per layer (``attention_apply``'s ``layer``): a model whose
``global_attn_every_n`` is set attends over a window on most layers and
over the whole prefix on every n-th (``ModelConfig.layer_is_full``), with
no RoPE on those full layers. ``attn_out_gate`` adds
a sigmoid gate on the heads' output, ``o * sigmoid(x Wg)``, before Wo
(Trinity's AFMoE). Serving such a mixed model is not ported:
``init_kv_cache`` refuses it.

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
from repro_torch.launch.sharding import (is_dtensor, local_apply,
                                         merge_dims, resolve_spec, shard,
                                         split_dim)
from repro_torch.models.layers import normal, ones, param_dtype, rope, \
    use_param



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
    if cfg.attn_out_gate:
        p["wg"] = normal(rng, (d, h * hd), s, pd)
    if cfg.qk_norm:
        p["q_norm"] = ones((hd,), pd)
        p["k_norm"] = ones((hd,), pd)
    return p


def attention_axes(cfg: ModelConfig):
    # GQA (kv < h): the small kv projections keep their columns whole on
    # every model shard; MHA shards them as it shards wq.
    kv_ax = (("embed", "qkv") if cfg.num_kv_heads == cfg.num_heads
             else ("embed", None))
    a = {"wq": ("embed", "qkv"), "wk": kv_ax, "wv": kv_ax,
         "wo": ("qkv", "embed")}
    if cfg.attn_out_gate:
        a["wg"] = ("embed", "qkv")
    if cfg.qk_norm:
        a["q_norm"] = (None,)
        a["k_norm"] = (None,)
    return a


def _qk_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _project_qkv(cfg: ModelConfig, p, x: torch.Tensor,
                 positions: torch.Tensor, use_rope: bool = True):
    B, S, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    q = split_dim(x @ use_param(p["wq"], dt, "embed", "qkv"), 2, (h, hd))
    k = split_dim(x @ use_param(p["wk"], dt, "embed", "qkv"), 2, (kv, hd))
    v = split_dim(x @ use_param(p["wv"], dt, "embed", "qkv"), 2, (kv, hd))
    if cfg.qk_norm:
        q = _qk_norm(q, p["q_norm"], cfg.qk_norm_eps)
        k = _qk_norm(k, p["k_norm"], cfg.qk_norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if S > 1:
        # prefill: the head axis sharded (unevenly if need be); decode's
        # one-token projections keep the cache's layout
        q = shard(q, "batch", None, "act_heads", None)
        k = shard(k, "batch", None, "act_heads", None)
        v = shard(v, "batch", None, "act_heads", None)
    return q, k, v


def _attend(q, k, v, window):
    """``ops.attention``. On DTensors every (batch row, head) is
    independent: k and v are repeated to the query heads and each shard
    runs the attention on its local rows and heads (``local_apply``)."""
    if not is_dtensor(q):
        return ops.attention(q, k, v, causal=True, window=window)
    G = q.shape[2] // k.shape[2]
    k, v = (torch.repeat_interleave(t, G, dim=2) for t in (k, v))
    ax = ("batch", None, "act_heads", None)
    return local_apply(lambda a, b, c: ops.attention(
        a, b, c, causal=True, window=window), (ax, ax, ax), q, k, v)


def _attend_cache(cfg, q, k_cache, v_cache, lengths):
    """``ops.decode_attention``. On DTensors each shard runs it on its
    local cache rows and kv heads (``local_apply``), q's heads split as
    the cache's kv heads are: whole where those are whole."""
    if not is_dtensor(q):
        return ops.decode_attention(q, k_cache, v_cache, lengths)
    cache_ax = kv_cache_axes(cfg)["k"]
    kv_split = resolve_spec(k_cache.shape, cache_ax, q.device_mesh)[2]
    q_ax = ("cache_batch", cache_ax[2] if kv_split else None, None)
    return local_apply(ops.decode_attention,
                       (q_ax, cache_ax, cache_ax, ("cache_batch",)),
                       q, k_cache, v_cache, lengths)


def _output(p, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The heads' output (B, S, h * hd), gated where the layer has a gate,
    through Wo."""
    if "wg" in p:
        out = out * torch.sigmoid(
            x @ use_param(p["wg"], x.dtype, "embed", "qkv"))
    return out @ use_param(p["wo"], x.dtype, "qkv", "embed")


def attention_apply(cfg: ModelConfig, p, x: torch.Tensor,
                    positions: torch.Tensor, layer: int = 0) -> torch.Tensor:
    """Causal self-attention over the full sequence (prefill), windowed or
    not as ``layer`` is (``ModelConfig.layer_is_full``)."""
    full = cfg.layer_is_full(layer)
    q, k, v = _project_qkv(cfg, p, x, positions,
                           use_rope=not (full and cfg.global_attn_every_n))
    window = (cfg.sliding_window if cfg.attention == AttentionKind.SLIDING
              and not full else None)
    out = _attend(q, k, v, window)
    out = shard(merge_dims(out, 2), "batch", None, "act_mlp")
    return _output(p, x, out)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """Zero k and v caches for every layer, stacked: (L, B, T, kv, hd),
    with T = min(max_len, sliding_window) for sliding-window archs. A model
    that mixes windowed and full layers has no cache here."""
    if cfg.global_attn_every_n:
        raise NotImplementedError(
            f"{cfg.name}: serving a model that mixes windowed and full "
            "attention layers is not ported (no per-layer cache length)")
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    if cfg.attention == AttentionKind.SLIDING:
        max_len = min(max_len, cfg.sliding_window)
    shape = (cfg.num_layers, batch, max_len, kv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kv_cache_axes(cfg: ModelConfig):
    """Logical axes of one layer's k and v caches (B, T, kv, hd)."""
    ax = ("cache_batch", "cache_seq", "cache_heads", None)
    return {"k": ax, "v": ax}


def _write_row(cache: torch.Tensor, slot: torch.Tensor,
               row: torch.Tensor) -> torch.Tensor:
    """cache[b, slot[b]] = row[b] where 0 <= slot[b] < T; other rows are
    dropped. Sync-free: a dropped row writes back what its clamped slot
    held. Written in place and returned. A DTensor cache (the dry run) is
    written out of place by a select over the (B, T) positions, which
    keeps each shard's rows local: DTensor would gather a batch-sharded
    cache for a scatter with replicated indices."""
    T = cache.shape[1]
    keep = (slot >= 0) & (slot < T)
    if is_dtensor(cache):
        hit = (torch.arange(T, device=cache.device)[None, :]
               == slot[:, None]) & keep[:, None]
        return torch.where(hit[:, :, None, None], row[:, None], cache)
    bidx = torch.arange(cache.shape[0], device=cache.device)
    at = slot.clamp(0, T - 1).long()
    cache[bidx, at] = torch.where(keep[:, None, None], row, cache[bidx, at])
    return cache


def attention_decode(cfg: ModelConfig, p, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], length: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: (B,1,d); cache k/v: (B,T,kv,hd); length: (B,)
    int32. Sliding-window archs use a ring buffer of size
    ``sliding_window`` (the cache position is length % window); full
    attention writes at ``length``."""
    positions = length[:, None]  # (B,1) absolute position of the new token
    q, k, v = _project_qkv(cfg, p, x, positions)
    T = cache["k"].shape[1]
    slot = length % T if cfg.attention == AttentionKind.SLIDING else length
    cache = {"k": _write_row(cache["k"], slot, k[:, 0]),
             "v": _write_row(cache["v"], slot, v[:, 0])}
    eff_len = torch.clamp(length + 1, max=T).to(torch.int32)
    out = _attend_cache(cfg, q[:, 0], cache["k"], cache["v"], eff_len)
    return _output(p, x, merge_dims(out[:, None], 2)), cache
