"""Mixture-of-Experts block: a top-k router and local expert dispatch.

The reference (``repro/models/moe.py``) runs ``_moe_local`` with every
expert local when no mesh is active, and under ``shard_map`` over expert
shards otherwise (bitwise the same math). The port has the local path:
route every token, bucket its k picks by expert into a capacity of
``C = ceil(T k / E * 1.25)`` slots each (T = B S tokens, idle serving slots
included; overflow picks are dropped and weigh 0), run the grouped matmul
(``kernels/ops.moe_gmm``) three times, and combine the weighted expert
outputs per token in float32. The expert-parallel mesh path comes with
``launch/{mesh,sharding}.py`` (ROADMAP module 10.d).

Routing follows ``lax.top_k``: the k largest softmax probabilities, the
lower expert id first among equal ones (a stable descending sort; a plain
``torch.topk`` promises no order among ties). The scatter into the buckets
drops overflow picks without a host sync: they write to one spare row past
the buckets.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import normal, param_dtype, use_param

CAPACITY_FACTOR = 1.25


def moe_init(cfg: ModelConfig, rng: np.random.Generator):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    s_in, s_out = 1.0 / np.sqrt(d), 1.0 / np.sqrt(f)
    pd = param_dtype(cfg)
    return {
        "router": normal(rng, (d, E), s_in, pd),
        "w_gate": normal(rng, (E, d, f), s_in, pd),
        "w_up": normal(rng, (E, d, f), s_in, pd),
        "w_down": normal(rng, (E, f, d), s_out, pd),
    }


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` routed tokens."""
    return int(math.ceil(tokens * cfg.experts_per_token / cfg.num_experts
                         * CAPACITY_FACTOR))


def route(cfg: ModelConfig, p, xf: torch.Tensor):
    """xf (T, d) -> (weights (T, k) float32, summing to 1 per token; expert
    ids (T, k), the largest probability first)."""
    logits = (xf @ use_param(p["router"], xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    weights, ids = top[:, :k], ids[:, :k]
    return weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9), ids


def moe_apply(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d) in x's dtype."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    C = capacity(cfg, T)
    dt = x.dtype
    xf = x.reshape(T, d)
    weights, ids = route(cfg, p, xf)

    flat_e = ids.reshape(-1)
    flat_tok = torch.arange(T, device=x.device)[:, None].expand(T, k)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    tok_sorted = flat_tok.reshape(-1)[order]
    # bincount, without the host sync torch.bincount makes on the card
    counts = torch.zeros(E, dtype=torch.long, device=x.device).index_add_(
        0, e_sorted, torch.ones_like(e_sorted))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=x.device) - starts[e_sorted]
    ok = pos < C

    # Buckets (E, C, d), a prefix of one buffer with a spare row for the
    # dropped picks.
    slot = torch.where(ok, e_sorted * C + pos, E * C)
    buf = torch.zeros((E * C + 1, d), dtype=dt, device=x.device)
    buf[slot] = xf[tok_sorted]
    xg = buf[:E * C].view(E, C, d)

    h = torch.nn.functional.silu(ops.moe_gmm(xg, use_param(p["w_gate"], dt))) \
        * ops.moe_gmm(xg, use_param(p["w_up"], dt))
    yg = ops.moe_gmm(h, use_param(p["w_down"], dt))

    w_eff = torch.where(ok, weights.reshape(-1)[order], 0.0)
    picked = yg.reshape(E * C, d)[e_sorted * C + torch.clamp(pos, max=C - 1)]
    # multiply in the compute dtype, add in float32 (the reference's casts)
    contrib = (picked * w_eff[:, None].to(dt)).float()
    yf = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    yf.index_add_(0, tok_sorted, contrib)
    return yf.reshape(B, S, d).to(dt)
