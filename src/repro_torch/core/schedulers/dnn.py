"""DNN-based scheduling baseline (paper appendix: Zang et al. 2019).

A small MLP regresses realized cost from plan features; each round the
scheduler picks the argmin predicted cost among sampled candidates
(exploitation) with epsilon-greedy random exploration. The paper reports this
class of method underperforms BODS/RLDS — included to reproduce that
comparison.

The MLP's weights are drawn from the scheduler's numpy ``rng`` (so they
match the reference's bit for bit) and live on the cost model's device; it
trains online by SGD (autograd) on (features, realized cost) pairs from a
fixed-size ring buffer.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.plans import random_plans
from repro_torch.core.schedulers.base import SchedulerBase, SchedulingContext
from repro_torch.core.schedulers.bods import NUM_FEATURES, BODSScheduler
from repro_torch.core.scoring import h2d, resolve_device
from repro_torch.experiment.registry import register_scheduler
from repro_torch.tree import as_tensor

BUF = 256
HIDDEN = 32


def _init_mlp(rng: np.random.Generator, device) -> Dict[str, torch.Tensor]:
    def g(shape):
        w = rng.normal(0, np.sqrt(2.0 / sum(shape)), shape)
        return torch.as_tensor(w.astype(np.float32), device=device)

    def z(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    return {"w1": g((NUM_FEATURES, HIDDEN)), "b1": z(HIDDEN),
            "w2": g((HIDDEN, HIDDEN)), "b2": z(HIDDEN),
            "w3": g((HIDDEN, 1)), "b3": z(1)}


def _mlp(params, f):
    h = torch.relu(f @ params["w1"] + params["b1"])
    h = torch.relu(h @ params["w2"] + params["b2"])
    return (h @ params["w3"] + params["b3"])[..., 0]


def _sgd_step(params, feats, targets, valid, lr: float):
    """One SGD step on the masked mean squared error over the ring."""
    with torch.enable_grad():
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        pred = _mlp(p, feats)
        loss = torch.sum(torch.square(pred - targets) * valid) / torch.clamp(
            valid.sum(), min=1.0)
        grads = torch.autograd.grad(loss, list(p.values()))
    return {k: (v - lr * g_).detach()
            for (k, v), g_ in zip(params.items(), grads)}


@register_scheduler("dnn")
class DNNScheduler(SchedulerBase):
    name = "dnn"

    def __init__(self, cost_model, seed: int = 0, num_candidates: int = 256,
                 epsilon: float = 0.1, lr: float = 1e-2, train_steps: int = 4,
                 search_backend: str = "fused"):
        # search_backend accepted (and ignored) for a uniform scheduler
        # constructor contract: DNN has one candidate-scoring path.
        super().__init__(cost_model, seed, search_backend=search_backend)
        self.num_candidates = num_candidates
        self.epsilon = epsilon
        self.lr = lr
        self.train_steps = train_steps
        self.device = resolve_device(cost_model.device)
        self.params = _init_mlp(self.rng, self.device)
        self._F = np.zeros((BUF, NUM_FEATURES), np.float32)
        self._y = np.zeros(BUF, np.float32)
        self._valid = np.zeros(BUF, np.float32)
        self._head = 0

    # ---- persistence (policy zoo) ----

    def state_dict(self):
        return {"params": self.params, "F": self._F, "y": self._y,
                "valid": self._valid, "head": np.asarray(self._head, np.int64)}

    def load_state_dict(self, tree) -> None:
        """Restore from a state whose ``params`` leaves are tensors or
        numpy arrays (the reference's, through ``repro_torch.convert``)."""
        F = np.array(tree["F"], np.float32)
        if F.shape != self._F.shape:
            raise ValueError(
                f"DNN replay-ring shape {F.shape} does not match this "
                f"scheduler's {self._F.shape} (BUF/feature-count mismatch)")
        self.params = {k: as_tensor(v, self.device, torch.float32)
                       for k, v in tree["params"].items()}
        self._F = F
        self._y = np.array(tree["y"], np.float32)
        self._valid = np.array(tree["valid"], np.float32)
        self._head = int(np.asarray(tree["head"]))

    def _featurize(self, ctx, plans):
        return BODSScheduler._featurize(self, ctx, plans)  # shared feature map

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return h2d(np.asarray(a, np.float32), self.device)

    def schedule(self, ctx: SchedulingContext) -> np.ndarray:
        cands = random_plans(self.rng, ctx.available, ctx.n_sel, self.num_candidates)
        if self.rng.random() < self.epsilon or self._valid.sum() < 8:
            return self._score_plan(ctx, cands[self.rng.integers(0, len(cands))])
        feats = self._featurize(ctx, cands)
        with torch.no_grad():
            pred = _mlp(self.params, self._t(feats)).cpu().numpy()
        return self._score_plan(ctx, cands[int(np.argmin(pred))])

    def observe(self, ctx: SchedulingContext, plan: np.ndarray, realized_cost: float) -> None:
        f = self._featurize(ctx, plan[None])[0]
        i = self._head % BUF
        self._F[i] = f
        self._y[i] = realized_cost
        self._valid[i] = 1.0
        self._head += 1
        F, y, valid = self._t(self._F), self._t(self._y), self._t(self._valid)
        for _ in range(self.train_steps):
            self.params = _sgd_step(self.params, F, y, valid, self.lr)
