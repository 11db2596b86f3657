"""Decoder-only LM backbone: the dense family (``ArchFamily.DENSE``).

    x += attn(norm(x)); x += mlp(norm(x))

Params keep the reference's layout (``repro/models/transformer.py``):
``{"embed", "head", "final_norm", "blocks"}`` with every block leaf STACKED
on a leading layer axis; the reference's ``lax.scan`` over the stack is a
loop over layers here, each layer a view of the stack. The decode state is
stacked the same way (``{"kv": {"k", "v"}}``, each (L, B, T, KV, D)) and is
updated in place.

``compute_params`` makes the compute copy once: every weight the
reference casts to the compute dtype on each call (projections, MLP,
embedding, head) cast ahead; norm scales stay as they are, since the
reference reads them in f32. The numbers are identical to casting per call.

The MoE, hybrid, SSM, audio and VLM families raise ``NotImplementedError``
naming ROADMAP module 10.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.config.base import ArchFamily, ModelConfig
from repro_torch.models.attention import (attention_apply, attention_decode,
                                          attention_init, init_kv_cache)
from repro_torch.models.layers import (compute_dtype, embed_apply,
                                       embed_init, head_init, mlp_apply,
                                       mlp_init, rmsnorm, rmsnorm_init,
                                       unembed_apply)

#: Leaves that keep their stored dtype in a compute copy (read in f32).
NORM_LEAVES = ("scale", "q_norm", "k_norm")


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != ArchFamily.DENSE:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family.value} family is ROADMAP module "
            "10, not ported yet (the port runs the dense LLMs)")


def _block_init(cfg: ModelConfig, rng: np.random.Generator):
    return {"attn": attention_init(cfg, rng), "mlp": mlp_init(cfg, rng),
            "norm1": rmsnorm_init(cfg, cfg.d_model),
            "norm2": rmsnorm_init(cfg, cfg.d_model)}


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _map(fn, tree, name=""):
    if isinstance(tree, dict):
        return {k: _map(fn, v, k) for k, v in tree.items()}
    return fn(name, tree)


def lm_init(cfg: ModelConfig, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Params with the reference's draws (``np.random.default_rng(seed)``,
    the same calls in the same order), on ``device``."""
    _dense_only(cfg)
    rng = np.random.default_rng(seed)
    params = {"embed": embed_init(cfg, rng), "head": head_init(cfg, rng),
              "final_norm": rmsnorm_init(cfg, cfg.d_model)}
    params["blocks"] = _stack([_block_init(cfg, rng)
                               for _ in range(cfg.num_layers)])
    return _map(lambda _n, t: t.to(device), params)


def compute_params(cfg: ModelConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """The compute copy of ``params`` (see the module docstring)."""
    dt = compute_dtype(cfg)
    return _map(lambda n, t: t if n in NORM_LEAVES else t.to(dt), params)


def _block_apply(cfg: ModelConfig, p, x, positions):
    x = x + attention_apply(cfg, p["attn"], rmsnorm(p["norm1"], x, cfg.norm_eps),
                            positions)
    return x + mlp_apply(cfg, p["mlp"], rmsnorm(p["norm2"], x, cfg.norm_eps))


def _embed(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    x = embed_apply(cfg, params["embed"], tokens)
    # sqrt(d_model) rounded to the compute dtype, as jnp.asarray(., dt); a
    # 0-d tensor, so the product stays in that dtype.
    return x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype,
                            device=x.device)


def lm_apply(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab) in the compute dtype."""
    _dense_only(cfg)
    x = _embed(cfg, params, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    for i in range(cfg.num_layers):
        x = _block_apply(cfg, _layer(params["blocks"], i), x, positions)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed_apply(cfg, params["embed"], params["head"], x)


# ---------------- decode (serving) ----------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda") -> Dict[str, Any]:
    """Stacked per-layer KV caches, zeros in the compute dtype."""
    _dense_only(cfg)
    return {"kv": init_kv_cache(cfg, batch, max_len, compute_dtype(cfg),
                                device)}


def _block_decode(cfg: ModelConfig, p, x, state, length):
    y, kv = attention_decode(cfg, p["attn"], rmsnorm(p["norm1"], x, cfg.norm_eps),
                             state["kv"], length)
    x = x + y
    x = x + mlp_apply(cfg, p["mlp"], rmsnorm(p["norm2"], x, cfg.norm_eps))
    return x, {"kv": kv}


def lm_decode_step(cfg: ModelConfig, params, state, tokens: torch.Tensor,
                   length: torch.Tensor) -> Tuple[torch.Tensor, Any]:
    """One decode step. tokens (B,) int; length (B,) int32, the current
    sequence lengths. Returns (logits (B, vocab), state), the state updated
    in place."""
    _dense_only(cfg)
    x = _embed(cfg, params, tokens[:, None])
    for i in range(cfg.num_layers):
        x, _ = _block_decode(cfg, _layer(params["blocks"], i), x,
                             _layer(state, i), length)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed_apply(cfg, params["embed"], params["head"], x)
    return logits[:, 0], state
