"""Step builders and input specs for the LLM zoo.

``make_train_step``: the microbatched (gradient accumulation in float32),
grad-clipped train step with the configured optimizer, remat as the model
config asks (``models/transformer.py``).
``make_prefill_step``: the full-sequence forward (serving prefill).
``make_serve_step``: one-token decode against the KV and recurrent state.
``input_specs``: the shapes and dtypes of a cell's inputs (tokens and
labels for train; tokens for prefill; state, tokens and lengths for
decode). ``synth_batch`` fills them with the reference's numpy draws.

The train step runs under ``torch.profiler.record_function`` ranges
(``train/forward_backward``, ``train/clip``, ``train/optimizer``), which
cost nothing measurable when no profiler is on.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.config.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.models.transformer import (FAMILIES, init_decode_state,
                                            lm_apply, lm_decode_step, lm_loss)
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
    """train: ``{"tokens", "labels"}``; prefill: ``{"tokens": spec}``;
    decode: ``{"state": ..., "tokens", "length"}``, the state as
    ``init_decode_state`` lays it out (one new token against a cache of
    ``shape.seq_len``; a sliding window keeps ``min(seq_len, window)``
    rows)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family.value} family is ROADMAP module "
            "10.c, not ported yet")
    B, S = shape.global_batch, shape.seq_len
    if shape.mode == "train":
        return {"tokens": Spec((B, S), torch.int32),
                "labels": Spec((B, S), torch.int32)}
    if shape.mode == "prefill":
        return {"tokens": Spec((B, S), torch.int32)}
    if shape.mode != "decode":
        raise ValueError(f"unknown mode {shape.mode!r}")
    state = init_decode_state(cfg, B, S, device="meta")
    return {"state": _specs(state), "tokens": Spec((B,), torch.int32),
            "length": Spec((B,), torch.int32)}


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
        return lm_apply(cfg, params, batch["tokens"])
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, state, tokens, length):
        return lm_decode_step(cfg, params, state, tokens, length)
    return serve_step
