"""Plain reference of an LM training step's optimizer: the gradient
clipped to a global norm, then AdamW, in float32.

    g  <- g * min(1, clip / (|g| + 1e-12))        |g| over every leaf
    m  <- b1 m + (1 - b1) g
    v  <- b2 v + (1 - b2) g^2
    p  <- p - lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)
            - lr wd p

``step`` takes an architecture's reference module (``loss_and_grads``)
and trains one batch; parameters and moments are flat dicts ``{path:
tensor}``, updated in place. ``loss_and_norm`` reads a batch's loss and
global gradient norm at given parameters, training nothing. Nothing here imports the program, JAX or the
JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch


@dataclasses.dataclass
class StepResult:
    loss: float
    grad_norm: float                 # the global norm before clipping
    grad_norms: Dict[str, float]     # each leaf's, after clipping


def no_tf32() -> None:
    """Full float32 matmuls on the card: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def leaf_norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t, dtype=torch.float64))


def global_norm(grads: Dict[str, torch.Tensor]) -> float:
    return math.sqrt(sum(leaf_norm(g) ** 2 for g in grads.values()))


def loss_and_norm(arch, model: dict, params: Dict[str, torch.Tensor],
                  tokens: torch.Tensor, precision: str = "float32"
                  ) -> Tuple[float, float]:
    """The loss of ``tokens`` at ``params`` and its global gradient norm
    before clipping."""
    loss, grads = arch.loss_and_grads(model, params, tokens, precision)
    return loss, global_norm(grads)


def step(arch, model: dict, opt: dict, params: Dict[str, torch.Tensor],
         m: Dict[str, torch.Tensor], v: Dict[str, torch.Tensor], t: int,
         tokens: torch.Tensor, precision: str = "float32") -> StepResult:
    """Train ``tokens`` once from ``params`` and the moments after ``t - 1``
    steps: step ``t``. ``params``, ``m`` and ``v`` are updated in place."""
    loss, grads = arch.loss_and_grads(model, params, tokens, precision)
    gnorm = global_norm(grads)
    scale = min(1.0, opt["grad_clip"] / (gnorm + 1e-12))
    b1, b2, lr, eps = opt["b1"], opt["b2"], opt["lr"], opt["eps"]
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    norms = {}
    for k, g in grads.items():
        g.mul_(scale)
        norms[k] = leaf_norm(g)
        m[k].mul_(b1).add_(g, alpha=1.0 - b1)
        v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
        u = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
        if opt["weight_decay"]:
            u.add_(params[k], alpha=opt["weight_decay"])
        params[k].sub_(lr * u)
        del u
    del grads
    return StepResult(loss, gnorm, norms)
