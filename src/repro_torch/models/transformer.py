"""Decoder-only LM backbone: every family of the reference.

  dense / audio / vlm : x += attn(norm(x)); x += mlp(norm(x))
  moe                 : x += attn(norm(x)); x += moe(norm(x))
                        (+ shared(norm(x)) with a shared expert; the
                        first ``moe_dense_first_n`` layers take an MLP of
                        ``dense_d_ff``; ``sandwich_norm`` norms each
                        sublayer's output before the add: Trinity)
  hybrid (hymba)      : h = norm(x); x += 0.5 (attn(h) + ssd(h)); x += mlp(norm(x))
  ssm (xlstm)         : x += mlstm(norm(x)); x += slstm(norm(x))     [a pair]

The modality frontends are stubs, as in the reference: the VLM prepends
precomputed patch embeddings (B, F, d) to the embedded text tokens; the
audio model's precomputed frame embeddings (B, S, d) are the sequence
itself, and its decode step takes a (B, d) frame (or a codebook token).
The whole sequence, prefix included, is cast to the compute dtype and
scaled by sqrt(d_model) in that dtype.

Params keep the reference's layout (``repro/models/transformer.py``):
``{"embed", "head", "final_norm", "blocks"}`` with every block leaf STACKED
on a leading axis, one entry per layer (per mLSTM/sLSTM pair for xLSTM;
a MoE model's leading dense layers stack apart, as ``"dense_blocks"``,
and ``"blocks"`` holds the MoE layers after them);
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
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config.base import ArchFamily, ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch.sharding import is_dtensor, shard
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (attention_apply, attention_axes,
                                          attention_decode, attention_init,
                                          init_kv_cache, kv_cache_axes)
from repro_torch.models.layers import (abstract_init, compute_dtype,
                                       embed_apply, embed_axes, embed_init,
                                       head_axes, head_init, is_abstract,
                                       mlp_apply, mlp_axes, mlp_init, rmsnorm,
                                       rmsnorm_axes, rmsnorm_init,
                                       unembed_apply)
from repro_torch.models.moe import moe_apply, moe_axes, moe_init

#: Leaves that keep their stored dtype in a compute copy (read in f32).
F32_LEAVES = ("scale", "q_norm", "k_norm", "a_log", "r_h")
FAMILIES = (ArchFamily.DENSE, ArchFamily.MOE, ArchFamily.HYBRID,
            ArchFamily.SSM, ArchFamily.AUDIO, ArchFamily.VLM)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: the {cfg.family.value} family is not "
                         "a language model")


#: A sandwich-normed block's norms of its sublayers' outputs.
POST_NORMS = ("post_attn_norm", "post_mlp_norm")


def _block_init(cfg: ModelConfig, rng: np.random.Generator,
                dense: bool = False):
    fam = cfg.family
    if fam == ArchFamily.SSM:  # xLSTM pair
        p = {"mlstm": ssm_mod.mlstm_init(cfg, rng),
             "slstm": ssm_mod.slstm_init(cfg, rng)}
    else:
        p = {"attn": attention_init(cfg, rng)}
        if fam == ArchFamily.MOE and not dense:
            p["moe"] = moe_init(cfg, rng)
        else:
            if fam == ArchFamily.HYBRID:
                p["ssd"] = ssm_mod.ssd_init(cfg, rng)
            p["mlp"] = mlp_init(cfg, rng, cfg.dense_d_ff if dense else 0)
    p["norm1"] = rmsnorm_init(cfg, cfg.d_model)
    p["norm2"] = rmsnorm_init(cfg, cfg.d_model)
    if cfg.sandwich_norm:
        for n in POST_NORMS:
            p[n] = rmsnorm_init(cfg, cfg.d_model)
    return p


def _block_axes(cfg: ModelConfig, dense: bool = False):
    fam = cfg.family
    if fam == ArchFamily.SSM:
        a = {"mlstm": ssm_mod.mlstm_axes(), "slstm": ssm_mod.slstm_axes()}
    else:
        a = {"attn": attention_axes(cfg)}
        if fam == ArchFamily.MOE and not dense:
            a["moe"] = moe_axes(cfg)
        else:
            if fam == ArchFamily.HYBRID:
                a["ssd"] = ssm_mod.ssd_axes()
            a["mlp"] = mlp_axes(cfg)
    a["norm1"] = rmsnorm_axes()
    a["norm2"] = rmsnorm_axes()
    if cfg.sandwich_norm:
        for n in POST_NORMS:
            a[n] = rmsnorm_axes()
    return a


def num_blocks(cfg: ModelConfig) -> int:
    """Entries of the block stacks: layers, or mLSTM/sLSTM pairs."""
    if cfg.family == ArchFamily.SSM:
        if cfg.num_layers % 2:
            raise ValueError("xLSTM pairs need an even num_layers")
        return cfg.num_layers // 2
    return cfg.num_layers


def num_dense_blocks(cfg: ModelConfig) -> int:
    """A MoE model's leading dense layers (the ``"dense_blocks"`` stack)."""
    return cfg.moe_dense_first_n if cfg.family == ArchFamily.MOE else 0


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
    n_dense = num_dense_blocks(cfg)
    if n_dense:
        params["dense_blocks"] = _stack([_block_init(cfg, rng, dense=True)
                                         for _ in range(n_dense)])
    params["blocks"] = _stack([_block_init(cfg, rng)
                               for _ in range(num_blocks(cfg) - n_dense)])
    if is_abstract():
        return params
    return _map(lambda _n, t: t.to(device), params)


def _layers(tree):
    """Every axes tuple of ``tree`` with the stacked "layers" axis first."""
    if isinstance(tree, dict):
        return {k: _layers(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and tree and isinstance(tree[0], tuple):
        return tuple(_layers(v) for v in tree)
    return ("layers",) + tree


def lm_param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of ``lm_init``'s tree, with no draws: the tree the
    reference's ``lm_init`` returns second (``launch/sharding.py`` resolves
    it)."""
    _check_family(cfg)
    axes = {"embed": embed_axes(), "head": head_axes(cfg),
            "final_norm": rmsnorm_axes(),
            "blocks": _layers(_block_axes(cfg))}
    if num_dense_blocks(cfg):
        axes["dense_blocks"] = _layers(_block_axes(cfg, dense=True))
    return axes


def lm_param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """``lm_init``'s tree as ``meta`` tensors (shapes and dtypes), with no
    draws and no allocation."""
    with abstract_init():
        return lm_init(cfg)


def compute_params(cfg: ModelConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """The compute copy of ``params`` (see the module docstring)."""
    dt = compute_dtype(cfg)
    return _map(lambda n, t: t if n in F32_LEAVES else t.to(dt), params)


def _post(cfg: ModelConfig, p, name: str, y: torch.Tensor) -> torch.Tensor:
    """A sublayer's output, normed where the block has ``name``."""
    return rmsnorm(p[name], y, cfg.norm_eps) if name in p else y


def _ffn(cfg: ModelConfig, p, x, layer: int) -> torch.Tensor:
    """The block's second half: x + (MLP, or routed experts plus the
    shared one)(norm(x))."""
    h = rmsnorm(p["norm2"], x, cfg.norm_eps)
    if "moe" in p:
        y = moe_apply(cfg, p["moe"], h, layer)
        if "shared" in p["moe"]:
            y = y + mlp_apply(cfg, p["moe"]["shared"], h)
    else:
        y = mlp_apply(cfg, p["mlp"], h)
    return x + _post(cfg, p, "post_mlp_norm", y)


def _block_apply(cfg: ModelConfig, p, x, positions, layer: int = 0):
    fam = cfg.family
    eps = cfg.norm_eps
    x = shard(x, "batch", None, "act_embed")
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
        x = x + _post(cfg, p, "post_attn_norm",
                      attention_apply(cfg, p["attn"], h, positions, layer))
    return _ffn(cfg, p, x, layer)


def _remat_block(impl: str, cfg: ModelConfig, p, x, positions, layer):
    """A checkpointed block under the caller's default kernel impl: the
    backward pass recomputes it on autograd's own thread (on the card),
    where the thread-local default is not the caller's."""
    with ops.default_impl(impl):
        return _block_apply(cfg, p, x, positions, layer)


def _block_views(cfg: ModelConfig, params):
    """Every layer's block params in order: the leading dense stack's
    views, then the main stack's."""
    n_dense = num_dense_blocks(cfg)
    views = _unstack(params["dense_blocks"], n_dense) if n_dense else []
    return views + _unstack(params["blocks"], num_blocks(cfg) - n_dense)


def _block_at(cfg: ModelConfig, params, i: int):
    """Layer ``i``'s block params (a view of its stack)."""
    n_dense = num_dense_blocks(cfg)
    if i < n_dense:
        return _layer(params["dense_blocks"], i)
    return _layer(params["blocks"], i - n_dense)


def _scaled(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    # sqrt(d_model) rounded to the compute dtype, as jnp.asarray(., dt); a
    # 0-d tensor, so the product stays in that dtype.
    return x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype,
                            device=x.device)


def lm_apply(cfg: ModelConfig, params, tokens: Optional[torch.Tensor] = None,
             frontend: Optional[torch.Tensor] = None,
             drop_last_logit: bool = False) -> torch.Tensor:
    """Logits (B, S_total, vocab) in the compute dtype ((B, S_total - 1,
    vocab) with ``drop_last_logit``, sliced before the unembed).

    dense, MoE, hybrid, SSM: ``tokens`` (B, S) int.
    audio (musicgen): ``frontend`` (B, S, d) frame embeddings; no tokens.
    VLM (paligemma): ``frontend`` (B, F, d) patch embeddings, then
    ``tokens`` (B, S_text); S_total = F + S_text.
    """
    _check_family(cfg)
    dt = compute_dtype(cfg)
    if cfg.family == ArchFamily.AUDIO:
        x = frontend.to(dt)
    elif cfg.family == ArchFamily.VLM:
        x = torch.cat([frontend.to(dt),
                       embed_apply(cfg, params["embed"], tokens)], dim=1)
    else:
        x = embed_apply(cfg, params["embed"], tokens)
    x = shard(_scaled(cfg, x), "batch", None, "act_embed")
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, p in enumerate(_block_views(cfg, params)):
        if remat:
            x = checkpoint(_remat_block, ops.get_default_impl(), cfg, p, x,
                           positions, i, use_reentrant=False)
        else:
            x = _block_apply(cfg, p, x, positions, i)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if drop_last_logit:
        x = x[:, :-1]
    return unembed_apply(cfg, params["embed"], params["head"], x)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """(B, S) nll in float32: logsumexp minus the label's logit. The
    reference sums a one-hot mask over the vocabulary for the label logit
    (sharding-friendly); a gather picks the same number without another
    (B, S, vocab) buffer. A DTensor (vocab-sharded logits) takes the
    reference's masked sum, which reduces each shard first."""
    lg = logits.float()
    if is_dtensor(lg):
        vocab = torch.arange(lg.shape[-1], device=lg.device)
        label = torch.where(vocab == targets[..., None].long(), lg,
                            0.0).sum(-1)
    else:
        label = lg.gather(-1, targets[..., None].long())[..., 0]
    return torch.logsumexp(lg, dim=-1) - label


def lm_loss(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """Next-token cross-entropy, a float32 scalar. batch: {tokens?,
    frontend?, labels, loss_mask?}. The logits are aligned to the labels
    from the end: a frontend prefix carries no labels."""
    logits = lm_apply(cfg, params, tokens=batch.get("tokens"),
                      frontend=batch.get("frontend"), drop_last_logit=True)
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


def decode_state_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical axes of ``init_decode_state``'s tree (the reference's)."""
    _check_family(cfg)
    fam = cfg.family
    cache = ("layers", "cache_batch", "cache_heads")
    if fam == ArchFamily.SSM:
        return {"mlstm": (cache + (None, None), cache + (None,)),
                "slstm": (("layers", "cache_batch", "inner"),) * 3}
    state = {"kv": _layers(kv_cache_axes(cfg))}
    if fam == ArchFamily.HYBRID:
        state["ssd"] = (cache + (None, None), cache + (None,))
    return state


def _block_decode(cfg: ModelConfig, p, x, state, length, layer: int = 0):
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
        x = x + _post(cfg, p, "post_attn_norm", y)
    return _ffn(cfg, p, x, layer), new


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
    """One decode step. tokens (B,) int, or for the audio family a (B, d)
    frame embedding; length (B,) int32, the current sequence lengths.
    Returns (logits (B, vocab), state), the state updated in place."""
    _check_family(cfg)
    if cfg.family == ArchFamily.AUDIO and tokens.dim() == 2:
        x = tokens.to(compute_dtype(cfg))[:, None]
    else:
        x = embed_apply(cfg, params["embed"], tokens[:, None])
    x = _scaled(cfg, x)
    for i in range(num_blocks(cfg)):
        st = _layer(state, i)
        x, new = _block_decode(cfg, _block_at(cfg, params, i), x, st,
                               length, i)
        _store(st, new)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed_apply(cfg, params["embed"], params["head"], x)
    return logits[:, 0], state
