"""Optimizers as (init_fn, update_fn) pairs over trees of tensors.

update_fn(grads, state, params) -> (updates, new_state); the caller applies
``params + updates``. The state is ``OptState(step, inner)`` with the
reference's layout (``adamw``: ``inner = (m, v)``, trees shaped like the
params), so a state crosses between the packages leaf for leaf
(``repro_torch.convert``). ``torch.optim`` is not used: its Adam rounds the
update in another order, and its state would not map onto this layout.

``adafactor``, ``make_optimizer`` and the learning-rate schedules wait for
the LM train path (ROADMAP module 10.a).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

Tree = Any


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    inner: Tree


def _step0(params: Tree) -> torch.Tensor:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``;
    returns (clipped grads, the norm before clipping)."""
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in leaves))
    scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), gnorm


def sgd(lr: float):
    def init(params):
        return OptState(_step0(params), ())

    def update(grads, state, params=None):
        updates = tree_map(lambda g: -lr * g, grads)
        return updates, OptState(state.step + 1, ())

    return init, update


def momentum(lr: float, beta: float = 0.9):
    def init(params):
        return OptState(_step0(params), tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        m = tree_map(lambda mm, g: beta * mm + g, state.inner, grads)
        updates = tree_map(lambda mm: -lr * mm, m)
        return updates, OptState(state.step + 1, m)

    return init, update


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0):
    return adamw(lr, b1, b2, eps, weight_decay)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0,
          lr_schedule: Optional[Callable[[torch.Tensor], Any]] = None):
    """AdamW, f32 moments, bias correction from the int32 step; the update
    is formed as the reference forms it (``-lr * (m / bc1) / (sqrt(v /
    bc2) + eps)``, decoupled decay on top)."""

    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)

        return OptState(_step0(params),
                        (tree_map(zeros, params), tree_map(zeros, params)))

    def update(grads, state, params):
        step = state.step + 1
        cur_lr = lr if lr_schedule is None else lr * lr_schedule(step)
        m, v = state.inner
        m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g.float(), m, grads)
        v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * torch.square(g.float()),
                     v, grads)
        t = step.to(torch.float32)
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)

        def upd(mm, vv, p):
            u = -cur_lr * (mm / bc1) / (torch.sqrt(vv / bc2) + eps)
            if weight_decay:
                u = u - cur_lr * weight_decay * p.float()
            return u.to(p.dtype)

        updates = tree_map(upd, m, v, params)
        return updates, OptState(step, (m, v))

    return init, update
