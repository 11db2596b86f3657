"""Serving step builders and input specs for the LLM zoo.

``make_prefill_step``: the full-sequence forward (serving prefill).
``make_serve_step``: one-token decode against the KV cache.
``input_specs``: the shapes and dtypes of a cell's inputs, for the dense
family (tokens for prefill; state, tokens and lengths for decode).

Training steps are ROADMAP module 10, a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.config.base import (ArchFamily, AttentionKind, ModelConfig,
                                     ShapeConfig)
from repro_torch.models.layers import compute_dtype
from repro_torch.models.transformer import lm_apply, lm_decode_step

#: An input's (shape, dtype), the stand-in for jax.ShapeDtypeStruct.
Spec = Tuple[Tuple[int, ...], torch.dtype]


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """prefill: ``{"tokens": spec}``; decode: ``{"state": {"kv": {"k",
    "v"}}, "tokens", "length"}`` (one new token against a cache of
    ``shape.seq_len``)."""
    if cfg.family != ArchFamily.DENSE:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family.value} family is ROADMAP module "
            "10, not ported yet")
    B, S = shape.global_batch, shape.seq_len
    if shape.mode == "prefill":
        return {"tokens": ((B, S), torch.int32)}
    if shape.mode != "decode":
        raise NotImplementedError(
            f"mode {shape.mode!r}: training is ROADMAP module 10, not "
            "ported yet")
    T = S
    if cfg.attention == AttentionKind.SLIDING:
        T = min(S, cfg.sliding_window)
    cache = ((cfg.num_layers, B, T, cfg.num_kv_heads, cfg.head_dim),
             compute_dtype(cfg))
    return {"state": {"kv": {"k": cache, "v": cache}},
            "tokens": ((B,), torch.int32), "length": ((B,), torch.int32)}


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return lm_apply(cfg, params, batch["tokens"])
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, state, tokens, length):
        return lm_decode_step(cfg, params, state, tokens, length)
    return serve_step
