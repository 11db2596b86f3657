"""Mixture-of-Experts block: a top-k router and expert dispatch, local or
expert-parallel (``repro/models/moe.py``).

``_moe_local(cfg, p, x, e_start, E_local)`` routes every token of ``x``
over all E experts, buckets the picks that fall on the E_local experts
``[e_start, e_start + E_local)`` into a capacity of ``C = ceil(T k / E *
1.25)`` slots each (T = B S tokens of ``x``, idle serving slots included;
overflow picks and picks of other experts are dropped and weigh 0), runs
the grouped matmul (``kernels/ops.moe_gmm``, kernel 2.5) three times on
(E_local, C, .) and combines the weighted expert outputs per token into a
float32 PARTIAL (B, S, d). With no mesh, ``moe_apply`` runs it on every
expert at once.

Under a mesh (``launch/sharding.use_mesh``) whose ``experts`` axes give
n_model > 1 shards dividing E, ``moe_apply`` is expert-parallel: experts
are sharded over "model", tokens over the batch axes ("pod", "data").
The (data i, model j) block routes ITS batch shard only, so its capacity
comes from its own T_local tokens, runs ``_moe_local(..., j E_local,
E_local)`` (three ``moe_gmm`` launches on its E_local experts), and the
float32 partials are summed over j. The input picks the executor:

- ``mesh``, for a DTensor ``x`` on a ``DeviceMesh``: one rank per device
  (NCCL on the cards, gloo on the CPU). Each rank takes its batch shard
  and its experts' weights as local tensors; where the weights are stored
  ZeRO-sharded over "data" (d_model and d_ff divisible by its size) it
  all-gathers them over "data", and the gradient of the gathered weights
  is reduce-scattered back; it all-reduces the partials over "model"
  with functional collectives and returns a DTensor sharded as the input.
  The local tensors' gradients are partial sums over the ranks that
  shared their value (the batch shards, the model shards of ``x`` and
  the router), which DTensor sums on the way back.
- ``emulate``, for a plain tensor: every (i, j) block in turn on ``x``'s
  device, the partials summed over j in float32 in order, no collective:
  the mesh path's numbers on one card.

Routing follows ``lax.top_k``: the k largest softmax probabilities, the
lower expert id first among equal ones (a stable descending sort; a plain
``torch.topk`` promises no order among ties). The scatter into the buckets
drops picks without a host sync: they write to one spare row past the
buckets (the reference's spare bucket E_local).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch import sharding
from repro_torch.models.layers import normal, param_dtype, use_param

CAPACITY_FACTOR = 1.25
EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")


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


def moe_axes():
    # Storage: experts over "model" (EP) and the contraction dim over
    # "data" (ZeRO-3); the EP path gathers the local experts' weights.
    return {"router": (None, None),
            "w_gate": ("experts", "embed", None),
            "w_up": ("experts", "embed", None),
            "w_down": ("experts", "mlp_zero", None)}


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


def ep_layout(cfg: ModelConfig, mesh):
    """(n_model, model axis, batch axes, ZeRO axis) of the expert-parallel
    path on ``mesh``, or None where it does not apply (no mesh, one
    expert shard, or E not a multiple of the shards)."""
    if mesh is None:
        return None
    rules = sharding.current_rules()
    sizes = sharding.axis_sizes(mesh)
    model_axes = [a for a in rules.get("experts", ()) if a in sizes]
    n_model = math.prod(sizes[a] for a in model_axes)
    if n_model == 1 or cfg.num_experts % n_model:
        return None
    batch_axes = tuple(a for a in rules.get("batch", ()) if a in sizes)
    zaxis = ("data" if "data" in sizes and cfg.d_model % sizes["data"] == 0
             and cfg.d_ff % sizes["data"] == 0 else None)
    return n_model, model_axes[0], batch_axes, zaxis


def moe_apply(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d) in x's dtype."""
    mesh = sharding.active_mesh()
    layout = ep_layout(cfg, mesh)
    if layout is None:
        return _moe_local(cfg, p, x, 0, cfg.num_experts).to(x.dtype)
    run = _moe_mesh if sharding.is_dtensor(x) else _moe_emulate
    return run(cfg, p, x, mesh, *layout)


def _moe_emulate(cfg, p, x, mesh, n_model, maxis, batch_axes, zaxis):
    sizes = sharding.axis_sizes(mesh)
    n_batch = math.prod(sizes[a] for a in batch_axes)
    B = x.shape[0]
    if B % n_batch:
        raise ValueError(f"a batch of {B} does not split over the {n_batch} "
                         f"shards of {batch_axes}")
    E_local = cfg.num_experts // n_model
    outs = []
    for xi in torch.split(x, B // n_batch, dim=0):
        acc = None
        for j in range(n_model):
            lo = j * E_local
            pj = {"router": p["router"],
                  **{n: p[n][lo:lo + E_local] for n in EXPERT_WEIGHTS}}
            part = _moe_local(cfg, pj, xi, lo, E_local)
            acc = part if acc is None else acc + part
        outs.append(acc)
    return torch.cat(outs, 0).to(x.dtype)


class _SumOverModel(torch.autograd.Function):
    """All-reduce of the partials over the model axis; its gradient is the
    output's (each partial adds into the replicated sum once)."""

    @staticmethod
    def forward(ctx, partial, group):
        import torch.distributed._functional_collectives as fc

        return fc.wait_tensor(fc.all_reduce(partial, "sum", group))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherStorage(torch.autograd.Function):
    """All-gather of a weight's ZeRO shards along ``dim``; its gradient is
    reduce-scattered back: each rank's gradient of the whole weight holds
    its own tokens' share, and each shard takes the sum of its rows."""

    @staticmethod
    def forward(ctx, w, dim, group):
        import torch.distributed._functional_collectives as fc

        ctx.dim, ctx.group = dim, group
        # ``*_single`` are the newer names of ``*_tensor``, which newer
        # torch releases deprecate; both take the same arguments
        gather = getattr(fc, "all_gather_single", fc.all_gather_tensor)
        return fc.wait_tensor(gather(w.contiguous(), dim, group))

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed._functional_collectives as fc

        scatter = getattr(fc, "reduce_scatter_single",
                          fc.reduce_scatter_tensor)
        return fc.wait_tensor(scatter(grad.contiguous(), "sum", ctx.dim,
                                      ctx.group)), None, None


def _moe_mesh(cfg, p, x, mesh, n_model, maxis, batch_axes, zaxis):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    names = list(sharding.axis_sizes(mesh))
    x_pl = tuple(Shard(0) if a in batch_axes else Replicate() for a in names)
    w_pl = tuple(Shard(0) if a == maxis else
                 Shard(1) if a == zaxis else Replicate() for a in names)
    # The gradients of the local tensors: a partial sum over every mesh
    # axis whose ranks hold the same value but see other tokens (the batch
    # axes) or other experts (the model axis, for x and the router).
    x_grad = tuple(Partial() if a == maxis else pl
                   for a, pl in zip(names, x_pl))
    w_grad = tuple(Partial() if a in batch_axes and a != zaxis else pl
                   for a, pl in zip(names, w_pl))
    r_grad = tuple(Partial() if a in batch_axes or a == maxis
                   else Replicate() for a in names)
    E_local = cfg.num_experts // n_model
    j = mesh.get_local_rank(maxis)
    lo = j * E_local

    def local(w, pl, grad_pl):
        if not isinstance(w, DTensor):
            return w if pl is None else w[lo:lo + E_local]
        return w.redistribute(mesh, pl or (Replicate(),) * len(names)
                              ).to_local(grad_placements=grad_pl)

    pl_local = {"router": local(p["router"], None, r_grad)}
    for n in EXPERT_WEIGHTS:
        w = local(p[n], w_pl, w_grad)
        if zaxis is not None and isinstance(p[n], DTensor):
            # ZeRO-3: this layer's local experts' whole weights
            w = _GatherStorage.apply(w, 1, (mesh, names.index(zaxis)))
        pl_local[n] = w.contiguous()          # the kernel takes dense rows
    xl = x.redistribute(mesh, x_pl).to_local(grad_placements=x_grad
                                             ).contiguous()
    partial = _moe_local(cfg, pl_local, xl, lo, E_local)
    y = _SumOverModel.apply(partial, (mesh, names.index(maxis))
                            ).to(x.dtype)
    return DTensor.from_local(y, mesh, x_pl, shape=x.shape,
                              stride=x.stride(), run_check=False)


def _moe_local(cfg: ModelConfig, p, x: torch.Tensor, e_start: int,
               E_local: int) -> torch.Tensor:
    """Route ``x``'s tokens, bucket the picks of experts [e_start, e_start
    + E_local) and run them; ``p``'s expert weights hold those E_local
    experts. Returns the float32 partial (B, S, d)."""
    B, S, d = x.shape
    k = cfg.experts_per_token
    T = B * S
    C = capacity(cfg, T)
    dt = x.dtype
    xf = x.reshape(T, d)
    weights, ids = route(cfg, p, xf)

    flat_e = ids.reshape(-1)
    flat_tok = torch.arange(T, device=x.device)[:, None].expand(T, k)
    hit = (flat_e >= e_start) & (flat_e < e_start + E_local)
    e_rel = torch.where(hit, flat_e - e_start, E_local)   # spare bucket
    order = torch.argsort(e_rel, stable=True)
    e_sorted = e_rel[order]
    tok_sorted = flat_tok.reshape(-1)[order]
    # bincount, without the host sync torch.bincount makes on the card
    counts = torch.zeros(E_local + 1, dtype=torch.long,
                         device=x.device).index_add_(
        0, e_sorted, torch.ones_like(e_sorted))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=x.device) - starts[e_sorted]
    ok = (e_sorted < E_local) & (pos < C)

    # Buckets (E_local, C, d), a prefix of one buffer with a spare row for
    # the dropped picks.
    slot = torch.where(ok, e_sorted * C + pos, E_local * C)
    buf = torch.zeros((E_local * C + 1, d), dtype=dt, device=x.device)
    buf[slot] = xf[tok_sorted]
    xg = buf[:E_local * C].view(E_local, C, d)

    h = torch.nn.functional.silu(ops.moe_gmm(xg, use_param(p["w_gate"], dt))) \
        * ops.moe_gmm(xg, use_param(p["w_up"], dt))
    yg = ops.moe_gmm(h, use_param(p["w_down"], dt))

    w_eff = torch.where(ok, weights.reshape(-1)[order], 0.0)
    picked = yg.reshape(E_local * C, d)[
        torch.clamp(e_sorted, max=E_local - 1) * C + torch.clamp(pos, max=C - 1)]
    # multiply in the compute dtype, add in float32 (the reference's casts)
    contrib = (picked * w_eff[:, None].to(dt)).float()
    yf = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    yf.index_add_(0, tok_sorted, contrib)
    return yf.reshape(B, S, d)
