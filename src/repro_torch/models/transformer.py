"""Decoder-only LM backbone: the dense, MoE, hybrid and SSM families.

  dense         : x += attn(norm(x)); x += mlp(norm(x))
  moe           : x += attn(norm(x)); x += moe(norm(x))
  hybrid (hymba): h = norm(x); x += 0.5 (attn(h) + ssd(h)); x += mlp(norm(x))
  ssm (xlstm)   : x += mlstm(norm(x)); x += slstm(norm(x))     [a pair]

Params keep the reference's layout (``repro/models/transformer.py``):
``{"embed", "head", "final_norm", "blocks"}`` with every block leaf STACKED
on a leading axis, one entry per layer (per mLSTM/sLSTM pair for xLSTM);
the reference's ``lax.scan`` over the stack is a loop here, each block a
view of the stack. The decode state is stacked the same way: ``{"kv":
{"k", "v"}}`` (L, B, T, KV, D), plus ``"ssd": (S, n)`` for the hybrid, or
``{"mlstm": (S, n), "slstm": (h, c, n)}`` for xLSTM. ``lm_decode_step``
updates it in place.

``compute_params`` makes the compute copy once: every weight the
reference casts to the compute dtype on each call cast ahead; the leaves
it reads in f32 (norm scales, the SSD decay base ``a_log``, the sLSTM
recurrence ``r_h``) stay as they are. The numbers are identical to casting
per call.

Training: ``lm_loss`` is the reference's next-token cross-entropy
(``cross_entropy``, an optional ``loss_mask``) on ``lm_apply(...,
drop_last_logit=True)``, which slices before the unembed. With grad
enabled, ``cfg.remat`` checkpoints every block
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of the
scanned block): only block inputs are kept, and each block runs again in
the backward pass.

The audio and VLM families (``frontend`` inputs) raise
``NotImplementedError`` naming ROADMAP module 10.c.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config.base import ArchFamily, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (attention_apply, attention_decode,
                                          attention_init, init_kv_cache)
from repro_torch.models.layers import (abstract_init, compute_dtype,
                                       embed_apply, embed_init, head_init,
                                       is_abstract, mlp_apply, mlp_init,
                                       rmsnorm, rmsnorm_init, unembed_apply)
from repro_torch.models.moe import moe_apply, moe_init

#: Leaves that keep their stored dtype in a compute copy (read in f32).
F32_LEAVES = ("scale", "q_norm", "k_norm", "a_log", "r_h")
FAMILIES = (ArchFamily.DENSE, ArchFamily.MOE, ArchFamily.HYBRID,
            ArchFamily.SSM)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family.value} family is ROADMAP module "
            "10, not ported yet (the port runs the dense, MoE, hybrid and "
            "SSM LLMs)")


def _block_init(cfg: ModelConfig, rng: np.random.Generator):
    fam = cfg.family
    if fam == ArchFamily.SSM:  # xLSTM pair
        p = {"mlstm": ssm_mod.mlstm_init(cfg, rng),
             "slstm": ssm_mod.slstm_init(cfg, rng)}
    else:
        p = {"attn": attention_init(cfg, rng)}
        if fam == ArchFamily.MOE:
            p["moe"] = moe_init(cfg, rng)
        else:
            if fam == ArchFamily.HYBRID:
                p["ssd"] = ssm_mod.ssd_init(cfg, rng)
            p["mlp"] = mlp_init(cfg, rng)
    p["norm1"] = rmsnorm_init(cfg, cfg.d_model)
    p["norm2"] = rmsnorm_init(cfg, cfg.d_model)
    return p


def num_blocks(cfg: ModelConfig) -> int:
    """Entries of the block stack: layers, or mLSTM/sLSTM pairs."""
    if cfg.family == ArchFamily.SSM:
        if cfg.num_layers % 2:
            raise ValueError("xLSTM pairs need an even num_layers")
        return cfg.num_layers // 2
    return cfg.num_layers


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_layer(v, i) for v in tree)
    return tree[i]


def _unstack(tree, n: int):
    """The ``n`` per-block views of a stacked tree, one ``unbind`` per
    leaf: under autograd its backward stacks the blocks' gradients in one
    pass (indexing each block would add a stack-sized buffer per block)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _map(fn, tree, name=""):
    if isinstance(tree, dict):
        return {k: _map(fn, v, k) for k, v in tree.items()}
    return fn(name, tree)


def lm_init(cfg: ModelConfig, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Params with the reference's draws (``np.random.default_rng(seed)``,
    the same calls in the same order), on ``device``. Inside
    ``abstract_init()`` every leaf is a ``meta`` tensor and nothing is
    drawn."""
    _check_family(cfg)
    rng = np.random.default_rng(seed)
    params = {"embed": embed_init(cfg, rng), "head": head_init(cfg, rng),
              "final_norm": rmsnorm_init(cfg, cfg.d_model)}
    params["blocks"] = _stack([_block_init(cfg, rng)
                               for _ in range(num_blocks(cfg))])
    if is_abstract():
        return params
    return _map(lambda _n, t: t.to(device), params)


def lm_param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """``lm_init``'s tree as ``meta`` tensors (shapes and dtypes), with no
    draws and no allocation."""
    with abstract_init():
        return lm_init(cfg)


def compute_params(cfg: ModelConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """The compute copy of ``params`` (see the module docstring)."""
    dt = compute_dtype(cfg)
    return _map(lambda n, t: t if n in F32_LEAVES else t.to(dt), params)


def _block_apply(cfg: ModelConfig, p, x, positions):
    fam = cfg.family
    eps = cfg.norm_eps
    if fam == ArchFamily.SSM:
        x = x + ssm_mod.mlstm_apply(cfg, p["mlstm"],
                                    rmsnorm(p["norm1"], x, eps))
        return x + ssm_mod.slstm_apply(cfg, p["slstm"],
                                       rmsnorm(p["norm2"], x, eps))
    h = rmsnorm(p["norm1"], x, eps)
    if fam == ArchFamily.HYBRID:
        x = x + 0.5 * (attention_apply(cfg, p["attn"], h, positions)
                       + ssm_mod.ssd_apply(cfg, p["ssd"], h))
    else:
        x = x + attention_apply(cfg, p["attn"], h, positions)
    if fam == ArchFamily.MOE:
        return x + moe_apply(cfg, p["moe"], rmsnorm(p["norm2"], x, eps))
    return x + mlp_apply(cfg, p["mlp"], rmsnorm(p["norm2"], x, eps))


def _remat_block(impl: str, cfg: ModelConfig, p, x, positions):
    """A checkpointed block under the caller's default kernel impl: the
    backward pass recomputes it on autograd's own thread (on the card),
    where the thread-local default is not the caller's."""
    with ops.default_impl(impl):
        return _block_apply(cfg, p, x, positions)


def _embed(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    x = embed_apply(cfg, params["embed"], tokens)
    # sqrt(d_model) rounded to the compute dtype, as jnp.asarray(., dt); a
    # 0-d tensor, so the product stays in that dtype.
    return x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype,
                            device=x.device)


def lm_apply(cfg: ModelConfig, params, tokens: torch.Tensor,
             drop_last_logit: bool = False) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab) in the compute dtype
    ((B, S - 1, vocab) with ``drop_last_logit``, sliced before the
    unembed)."""
    _check_family(cfg)
    x = _embed(cfg, params, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    remat = cfg.remat and torch.is_grad_enabled()
    for p in _unstack(params["blocks"], num_blocks(cfg)):
        if remat:
            x = checkpoint(_remat_block, ops.get_default_impl(), cfg, p, x,
                           positions, use_reentrant=False)
        else:
            x = _block_apply(cfg, p, x, positions)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if drop_last_logit:
        x = x[:, :-1]
    return unembed_apply(cfg, params["embed"], params["head"], x)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """(B, S) nll in float32: logsumexp minus the label's logit. The
    reference sums a one-hot mask over the vocabulary for the label logit
    (sharding-friendly); a gather picks the same number."""
    lg = logits.float()
    label = lg.gather(-1, targets[..., None].long())[..., 0]
    return torch.logsumexp(lg, dim=-1) - label


def lm_loss(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """Next-token cross-entropy, a float32 scalar. batch: {tokens, labels,
    loss_mask?}; a ``frontend`` (audio, VLM) is module 10.c."""
    if batch.get("frontend") is not None:
        raise NotImplementedError(
            "frontend inputs (audio and VLM) are ROADMAP module 10.c, not "
            "ported yet")
    logits = lm_apply(cfg, params, batch["tokens"], drop_last_logit=True)
    labels = batch["labels"]
    S_lab = labels.shape[1] - 1
    nll = cross_entropy(logits[:, -S_lab:, :], labels[:, 1:])
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask[:, 1:].float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


# ---------------- decode (serving) ----------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda") -> Dict[str, Any]:
    """Stacked per-layer decode state, zeros: KV caches in the compute
    dtype (attention families), recurrent states in f32 (the sLSTM's h in
    the compute dtype)."""
    _check_family(cfg)
    dt = compute_dtype(cfg)
    n = num_blocks(cfg)

    def stack(tree):
        return tuple(torch.zeros((n,) + tuple(t.shape), dtype=t.dtype,
                                 device=device) for t in tree)

    fam = cfg.family
    if fam == ArchFamily.SSM:
        return {"mlstm": stack(ssm_mod.mlstm_decode_state(cfg, batch, "meta")),
                "slstm": stack(ssm_mod.slstm_decode_state(cfg, batch, dt,
                                                          "meta"))}
    state = {"kv": init_kv_cache(cfg, batch, max_len, dt, device)}
    if fam == ArchFamily.HYBRID:
        state["ssd"] = stack(ssm_mod.ssd_decode_state(cfg, batch, "meta"))
    return state


def _block_decode(cfg: ModelConfig, p, x, state, length):
    """One block's decode step. The KV cache is written in place; the
    recurrent states come back new."""
    fam = cfg.family
    eps = cfg.norm_eps
    if fam == ArchFamily.SSM:
        y, ms = ssm_mod.mlstm_decode(cfg, p["mlstm"],
                                     rmsnorm(p["norm1"], x, eps),
                                     state["mlstm"])
        x = x + y
        y, ss = ssm_mod.slstm_decode(cfg, p["slstm"],
                                     rmsnorm(p["norm2"], x, eps),
                                     state["slstm"])
        return x + y, {"mlstm": ms, "slstm": ss}
    h = rmsnorm(p["norm1"], x, eps)
    y, kv = attention_decode(cfg, p["attn"], h, state["kv"], length)
    new = {"kv": kv}
    if fam == ArchFamily.HYBRID:
        ys, new["ssd"] = ssm_mod.ssd_decode(cfg, p["ssd"], h, state["ssd"])
        x = x + 0.5 * (y + ys)
    else:
        x = x + y
    if fam == ArchFamily.MOE:
        return x + moe_apply(cfg, p["moe"], rmsnorm(p["norm2"], x, eps)), new
    return x + mlp_apply(cfg, p["mlp"], rmsnorm(p["norm2"], x, eps)), new


def _store(dst, src) -> None:
    """Write a block's new recurrent state into its view of the stack."""
    if isinstance(dst, dict):
        for k in src:
            _store(dst[k], src[k])
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _store(d, s)
    elif dst is not src:
        dst.copy_(src)


def lm_decode_step(cfg: ModelConfig, params, state, tokens: torch.Tensor,
                   length: torch.Tensor) -> Tuple[torch.Tensor, Any]:
    """One decode step. tokens (B,) int; length (B,) int32, the current
    sequence lengths. Returns (logits (B, vocab), state), the state updated
    in place."""
    _check_family(cfg)
    x = _embed(cfg, params, tokens[:, None])
    for i in range(num_blocks(cfg)):
        st = _layer(state, i)
        x, new = _block_decode(cfg, _layer(params["blocks"], i), x, st,
                               length)
        _store(st, new)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed_apply(cfg, params["embed"], params["head"], x)
    return logits[:, 0], state
