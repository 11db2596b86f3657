"""Serving step builders and input specs for the LLM zoo.

``make_prefill_step``: the full-sequence forward (serving prefill).
``make_serve_step``: one-token decode against the KV and recurrent state.
``input_specs``: the shapes and dtypes of a cell's inputs (tokens for
prefill; state, tokens and lengths for decode).

Training steps are ROADMAP module 10, a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.config.base import ModelConfig, ShapeConfig
from repro_torch.models.transformer import (FAMILIES, init_decode_state,
                                            lm_apply, lm_decode_step)


class Spec(NamedTuple):
    """An input's shape and dtype, the stand-in for jax.ShapeDtypeStruct."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _specs(tree):
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_specs(v) for v in tree)
    return Spec(tuple(tree.shape), tree.dtype)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """prefill: ``{"tokens": spec}``; decode: ``{"state": ..., "tokens",
    "length"}``, the state as ``init_decode_state`` lays it out (one new
    token against a cache of ``shape.seq_len``; a sliding window keeps
    ``min(seq_len, window)`` rows)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family.value} family is ROADMAP module "
            "10, not ported yet")
    B, S = shape.global_batch, shape.seq_len
    if shape.mode == "prefill":
        return {"tokens": Spec((B, S), torch.int32)}
    if shape.mode != "decode":
        raise NotImplementedError(
            f"mode {shape.mode!r}: training is ROADMAP module 10, not "
            "ported yet")
    state = init_decode_state(cfg, B, S, device="meta")
    return {"state": _specs(state), "tokens": Spec((B,), torch.int32),
            "length": Spec((B,), torch.int32)}


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return lm_apply(cfg, params, batch["tokens"])
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, state, tokens, length):
        return lm_decode_step(cfg, params, state, tokens, length)
    return serve_step
