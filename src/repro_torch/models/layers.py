"""Shared transformer layers: RMSNorm, RoPE, MLP variants, embeddings.

Params are plain dicts of tensors. Initialisers take a numpy Generator and
make the reference's draws in the reference's order, rounded to the param
dtype once, so ``lm_init`` is bit-identical to ``repro.models``'.

Inside ``abstract_init()`` the initialisers draw nothing and return
tensors on the ``meta`` device (shape and dtype only), as the reference's
return ``ShapeDtypeStruct``s: ``lm_param_shapes`` builds a model's tree
that way, with no host allocation.

``use_param`` casts a weight to the compute dtype, as the reference does on
every call. Where the weight is already in that dtype the cast is a no-op,
so a model may be handed a compute copy made once (``compute_params`` in
``models/transformer.py``): the numbers are identical and each step skips
re-casting every f32 weight.

Each ``*_axes`` function beside an initialiser returns the logical axes of
its params (the tuples the reference's ``*_init`` returns second), which
``launch/sharding.py`` resolves to mesh axes. ``use_param``'s
``logical_axes`` and the ``shard`` calls sit where the reference's do;
on plain tensors they change nothing.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.launch.sharding import active_mesh, gather_storage, shard

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_abstract = threading.local()


@contextlib.contextmanager
def abstract_init():
    """Inside this context every initialiser returns a ``meta`` tensor and
    draws nothing from its generator."""
    _abstract.on = True
    try:
        yield
    finally:
        _abstract.on = False


def is_abstract() -> bool:
    return getattr(_abstract, "on", False)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


def normal(rng: np.random.Generator, shape, scale, dtype) -> torch.Tensor:
    if is_abstract():
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.as_tensor(rng.normal(0.0, scale, shape)).to(dtype)


def ones(shape, dtype) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype,
                      device="meta" if is_abstract() else None)


def zeros(shape, dtype) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype,
                       device="meta" if is_abstract() else None)


def use_param(w: torch.Tensor, dtype: torch.dtype,
              *logical_axes) -> torch.Tensor:
    """The weight in the compute dtype (a no-op on a compute copy), pinned
    to ``logical_axes`` after the cast when they are given (so a sharded
    weight's collectives move the compute dtype), then with its ZeRO
    storage dims gathered for use (``gather_storage``)."""
    y = w if w.dtype == dtype else w.to(dtype)
    if not logical_axes or active_mesh() is None:
        return y
    return gather_storage(shard(y, *logical_axes), *logical_axes)


# ---- RMSNorm ----

def rmsnorm_init(cfg: ModelConfig, dim: int):
    return {"scale": ones((dim,), param_dtype(cfg))}


def rmsnorm_axes():
    return {"scale": ("embed",)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# ---- RoPE ----

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, D) rotated by positions (..., S). Angles in f32, cos
    and sin cast to x's dtype before the rotation, as in the reference."""
    d = x.shape[-1]
    half = d // 2
    base = torch.tensor(1.0 / theta, dtype=torch.float32, device=x.device)
    freq = base ** (torch.arange(half, dtype=torch.float32,
                                 device=x.device) / half)
    ang = positions[..., None].float() * freq          # (..., S, half)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)     # broadcast over heads
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---- MLP (SwiGLU / GeGLU / GELU) ----

def mlp_init(cfg: ModelConfig, rng: np.random.Generator, width: int = 0):
    """The MLP's weights, ``width`` (default ``d_ff``) wide."""
    d, f = cfg.d_model, width or cfg.d_ff
    s_in = 1.0 / np.sqrt(d)
    s_out = 1.0 / np.sqrt(f)
    pd = param_dtype(cfg)
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return {"w_gate": normal(rng, (d, f), s_in, pd),
                "w_up": normal(rng, (d, f), s_in, pd),
                "w_down": normal(rng, (f, d), s_out, pd)}
    return {"w_up": normal(rng, (d, f), s_in, pd),
            "w_down": normal(rng, (f, d), s_out, pd)}


def mlp_axes(cfg: ModelConfig):
    gate = ({"w_gate": ("embed", "mlp")}
            if cfg.mlp_kind in ("swiglu", "geglu") else {})
    return {**gate, "w_up": ("embed", "mlp"), "w_down": ("mlp", "embed")}


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def mlp_apply(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    if cfg.mlp_kind in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp_kind == "swiglu" else _gelu
        h = act(x @ use_param(p["w_gate"], dt, "embed", "mlp")) * (
            x @ use_param(p["w_up"], dt, "embed", "mlp"))
    else:
        h = _gelu(x @ use_param(p["w_up"], dt, "embed", "mlp"))
    h = shard(h, "batch", None, "act_mlp")
    return h @ use_param(p["w_down"], dt, "mlp", "embed")


# ---- Embeddings ----

def embed_init(cfg: ModelConfig, rng: np.random.Generator):
    return {"embedding": normal(rng, (cfg.vocab_size, cfg.d_model),
                                1.0 / np.sqrt(cfg.d_model), param_dtype(cfg))}


def embed_axes():
    return {"embedding": ("vocab", "embed")}


def embed_apply(cfg: ModelConfig, p, tokens: torch.Tensor) -> torch.Tensor:
    # Gather, then cast: the same numbers as casting the table first.
    return use_param(p["embedding"][tokens], compute_dtype(cfg))


def unembed_apply(cfg: ModelConfig, emb_p, head_p,
                  x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = use_param(emb_p["embedding"], x.dtype).t()
    else:
        w = use_param(head_p["w"], x.dtype)
    # pinned (batch, seq, vocab shard), as the reference pins it
    return shard(x @ w, "batch", None, "act_vocab")


def head_init(cfg: ModelConfig, rng: np.random.Generator):
    if cfg.tie_embeddings:
        return {}
    return {"w": normal(rng, (cfg.d_model, cfg.vocab_size),
                        1.0 / np.sqrt(cfg.d_model), param_dtype(cfg))}


def head_axes(cfg: ModelConfig):
    # vocab-only: a d_model shard would make every logit a partial sum
    return {} if cfg.tie_embeddings else {"w": (None, "vocab")}
