"""Step builders and input specs for the LLM zoo.

``make_train_step``: the microbatched (gradient accumulation in float32),
grad-clipped train step with the configured optimizer, remat as the model
config asks (``models/transformer.py``).
``make_prefill_step``: the full-sequence forward (serving prefill).
``make_serve_step``: one-token decode against the KV and recurrent state.
``input_specs``: the shapes and dtypes of a cell's inputs (tokens and
labels for train; tokens for prefill; state, tokens and lengths for
decode; the audio and VLM families' frontend embeddings in the compute
dtype). ``synth_batch`` fills them with the reference's numpy draws.
``batch_axes`` and ``opt_state_axes`` are the logical axes of a cell's
inputs and of an optimizer's state (``launch/sharding.py``).

The train step runs under ``torch.profiler.record_function`` ranges
(``train/forward_backward``, ``train/clip``, ``train/optimizer``), which
cost nothing measurable when no profiler is on.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.config.base import (ArchFamily, ModelConfig,
                                     OptimizerConfig, ShapeConfig,
                                     TrainConfig)
from repro_torch.models.layers import compute_dtype
from repro_torch.models.transformer import (decode_state_axes,
                                            init_decode_state, lm_apply,
                                            lm_decode_step, lm_loss)
from repro_torch.optim import clip_by_global_norm, make_optimizer
from repro_torch.tree import tree_leaves, tree_unflatten


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
    """The reference's model inputs of one cell. train: ``{"tokens",
    "labels"}``; the audio family ``{"frontend" (B, S, d), "labels"}``; the
    VLM ``{"frontend" (B, F, d), "tokens" and "labels" (B, S - F)}``.
    prefill: the same without labels. decode: ``{"state": ..., "tokens",
    "length"}``, the state as ``init_decode_state`` lays it out (one new
    token against a cache of ``shape.seq_len``; a sliding window keeps
    ``min(seq_len, window)`` rows), the audio family's token a (B, d)
    frame. Frontends are in the compute dtype."""
    B, S = shape.global_batch, shape.seq_len
    dt, i32 = compute_dtype(cfg), torch.int32
    if shape.mode in ("train", "prefill"):
        batch: Dict[str, Any] = {}
        if cfg.family == ArchFamily.AUDIO:
            batch["frontend"] = Spec((B, S, cfg.d_model), dt)
        elif cfg.family == ArchFamily.VLM:
            F = cfg.frontend_tokens
            batch["frontend"] = Spec((B, F, cfg.d_model), dt)
            S = S - F
        if cfg.family != ArchFamily.AUDIO:
            batch["tokens"] = Spec((B, S), i32)
        if shape.mode == "train":
            batch["labels"] = Spec((B, S), i32)
        return batch
    if shape.mode != "decode":
        raise ValueError(f"unknown mode {shape.mode!r}")
    state = init_decode_state(cfg, B, S, device="meta")
    tokens = (Spec((B, cfg.d_model), dt) if cfg.family == ArchFamily.AUDIO
              else Spec((B,), i32))
    return {"state": _specs(state), "tokens": tokens,
            "length": Spec((B,), i32)}


def batch_axes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Logical axes matching ``input_specs``."""
    if shape.mode in ("train", "prefill"):
        axes: Dict[str, Any] = {}
        if cfg.family in (ArchFamily.AUDIO, ArchFamily.VLM):
            axes["frontend"] = ("batch", "seq", None)
        if cfg.family != ArchFamily.AUDIO:
            axes["tokens"] = ("batch", "seq")
        if shape.mode == "train":
            axes["labels"] = ("batch", "seq")
        return axes
    tok_ax = (("cache_batch", None) if cfg.family == ArchFamily.AUDIO
              else ("cache_batch",))
    return {"state": decode_state_axes(cfg), "tokens": tok_ax,
            "length": ("cache_batch",)}


def _map_axes(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    return fn(tree)


def opt_state_axes(cfg: ModelConfig, params_axes, opt: OptimizerConfig):
    """Logical axes of the optimizer state (``OptState(step, inner)``),
    mirroring the params' (adafactor's row accumulator drops the last
    dim, its column accumulator the one before)."""
    if opt.name in ("adam", "adamw"):
        inner = (params_axes, params_axes)
    elif opt.name == "momentum":
        inner = params_axes
    elif opt.name == "adafactor":
        inner = _map_axes(lambda a: (a[:-1], a[:-2] + a[-1:]) if len(a) >= 2
                          else (a, None), params_axes)
    else:  # sgd
        inner = ()
    return {"step": (), "inner": inner}


def _grads(cfg: ModelConfig, params, batch) -> Tuple[torch.Tensor, list]:
    """(loss, d loss / d leaf for each leaf of ``params``, in
    ``tree_leaves`` order); a leaf the loss does not reach gets zeros, as
    under ``jax.grad``."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = lm_loss(cfg, tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


def make_train_step(cfg: ModelConfig, train_cfg: TrainConfig):
    """(train_step, opt_init): ``train_step(params, opt_state, batch) ->
    (params, opt_state, {"loss", "grad_norm"})``, new trees (the inputs
    are left as they are), as ``repro/launch/steps.py:122-157``: the batch
    split into ``microbatches`` slices along axis 0, their losses and
    gradients summed in float32 and divided by the count; the gradient
    clipped to ``grad_clip`` by its global norm; the update added in
    float32, ``p = (p.f32 + u.f32).to(p.dtype)``."""
    opt_init, opt_update = make_optimizer(train_cfg.optimizer)
    M = train_cfg.microbatches

    def train_step(params, opt_state, batch):
        with record_function("train/forward_backward"):
            if M > 1:
                loss, grads = None, None
                for i in range(M):
                    mb = {k: v.reshape((M, v.shape[0] // M) + v.shape[1:])[i]
                          for k, v in batch.items()}
                    l, g = _grads(cfg, params, mb)
                    if grads is None:  # 0 + g, exactly
                        loss, grads = l, [x.float() for x in g]
                    else:
                        loss = loss + l
                        for a, x in zip(grads, g):
                            a.add_(x.float())
                    del g
                loss = loss / M
                for a in grads:
                    a.div_(M)
            else:
                loss, grads = _grads(cfg, params, batch)
        with torch.no_grad():
            with record_function("train/clip"):
                # the reference's bf16 gradient times its f32 scale is f32
                grads, gnorm = clip_by_global_norm(
                    [g.float() for g in grads],
                    train_cfg.optimizer.grad_clip)
            with record_function("train/optimizer"):
                updates, opt_state = opt_update(
                    tree_unflatten(params, grads), opt_state, params)
                del grads
                params = tree_unflatten(params, [
                    (p.float() + u.float()).to(p.dtype) for p, u in zip(
                        tree_leaves(params), tree_leaves(updates))])
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step, opt_init


def synth_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """``input_specs`` filled with the reference's draws
    (``np.random.default_rng(seed)``; integers in [0, max(vocab, 2)),
    floats standard normal), leaf by leaf in JAX's order (dict keys
    sorted), as tensors on ``device``."""
    rng = np.random.default_rng(seed)

    def materialize(s):
        if isinstance(s, dict):
            out = {k: materialize(s[k]) for k in sorted(s)}
            return {k: out[k] for k in s}
        if not isinstance(s, Spec):
            return type(s)(materialize(x) for x in s)
        if s.dtype.is_floating_point:
            a = rng.normal(0, 1, s.shape)
        else:
            a = rng.integers(0, max(cfg.vocab_size, 2), s.shape)
        return torch.as_tensor(a).to(device=device, dtype=s.dtype)

    return materialize(input_specs(cfg, shape))


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return lm_apply(cfg, params, tokens=batch.get("tokens"),
                        frontend=batch.get("frontend"))
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, state, tokens, length):
        return lm_decode_step(cfg, params, state, tokens, length)
    return serve_step
