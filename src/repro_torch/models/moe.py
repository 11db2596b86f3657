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

Trinity's AFMoE (``router_score="sigmoid"``): scores ``sigmoid(x W_r)`` in
float32, the k largest picked as above, their weights ``s / (sum s +
1e-20) * route_scale``; a shared SwiGLU expert (``p["shared"]``, which
``models/transformer.py`` adds to the routed part); and dropless routing
(``moe_dropless``): the picks are counted per expert on the device and
read to the host once per layer and forward (``load_reads``); each held
expert's picks fill a segment of one (R, d) buffer, rounded up to the
grouped form's ``GROUP_ROWS`` with zero rows, and the three grouped
matmuls (``ops.moe_gmm_grouped``, kernel 2.5's grouped form) run each row
tile against its expert's weights: the work follows the held picks, not
the largest expert's load. ``experts_held`` < E makes
the layer hold experts [0, experts_held) with no mesh: it routes over all
E and returns its own experts' part, as one chip of an expert-parallel
deployment would before the exchange.

Tracing (``monitoring/trace.py``, free when off): device spans
``moe_route``, ``moe_experts`` and ``moe_combine`` (arg ``layer``) around
the three stages, and counter events ``moe_rows_launched`` (rows run,
padding included) and ``moe_load_reads`` (host reads so far, 0 on the
capacity path), with ``moe_rows_routed`` and ``moe_max_load`` where the
load is read.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.kernels import moe_gmm as gmm_kernel
from repro_torch.kernels import ops
from repro_torch.launch import sharding
from repro_torch.models.layers import (mlp_axes, mlp_init, normal,
                                       param_dtype, use_param)
from repro_torch.monitoring.trace import counter, device_span

CAPACITY_FACTOR = 1.25
EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")
#: Host reads of a layer's expert load since import (dropless routing).
load_reads = 0


def moe_init(cfg: ModelConfig, rng: np.random.Generator):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    held = cfg.experts_here
    s_in, s_out = 1.0 / np.sqrt(d), 1.0 / np.sqrt(f)
    pd = param_dtype(cfg)
    p = {
        "router": normal(rng, (d, E), s_in, pd),
        "w_gate": normal(rng, (held, d, f), s_in, pd),
        "w_up": normal(rng, (held, d, f), s_in, pd),
        "w_down": normal(rng, (held, f, d), s_out, pd),
    }
    if cfg.num_shared_experts:
        p["shared"] = mlp_init(cfg, rng)
    return p


def moe_axes(cfg: ModelConfig = None):
    # Storage: experts over "model" (EP) and the contraction dim over
    # "data" (ZeRO-3); the EP path gathers the local experts' weights.
    a = {"router": (None, None),
         "w_gate": ("experts", "embed", None),
         "w_up": ("experts", "embed", None),
         "w_down": ("experts", "mlp_zero", None)}
    if cfg is not None and cfg.num_shared_experts:
        a["shared"] = mlp_axes(cfg)
    return a


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` routed tokens."""
    return int(math.ceil(tokens * cfg.experts_per_token / cfg.num_experts
                         * CAPACITY_FACTOR))


def route(cfg: ModelConfig, p, xf: torch.Tensor):
    """xf (T, d) -> (weights (T, k) float32, summing to 1 per token, or to
    ``route_scale`` under sigmoid scores; expert ids (T, k), the largest
    score first)."""
    logits = (xf @ use_param(p["router"], xf.dtype)).float()
    sigmoid = cfg.router_score == "sigmoid"
    scores = torch.sigmoid(logits) if sigmoid else \
        torch.softmax(logits, dim=-1)
    top, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    weights, ids = top[:, :k], ids[:, :k]
    if sigmoid:
        return (weights / (weights.sum(-1, keepdim=True) + 1e-20)
                * cfg.route_scale), ids
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


def moe_apply(cfg: ModelConfig, p, x: torch.Tensor,
              layer: int = 0) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d) in x's dtype: the routed experts' part
    (the shared expert is the caller's). ``layer`` tags the trace."""
    mesh = sharding.active_mesh()
    layout = ep_layout(cfg, mesh)
    if layout is None:
        return _moe_local(cfg, p, x, 0, cfg.experts_here,
                          layer).to(x.dtype)
    if cfg.experts_held:
        raise ValueError(f"{cfg.name}: a layer that holds {cfg.experts_held} "
                         "of its experts runs with no mesh")
    run = _moe_mesh if sharding.is_dtensor(x) else _moe_emulate
    return run(cfg, p, x, mesh, *layout, layer)


def _moe_emulate(cfg, p, x, mesh, n_model, maxis, batch_axes, zaxis,
                 layer):
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
            part = _moe_local(cfg, pj, xi, lo, E_local, layer)
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


def _moe_mesh(cfg, p, x, mesh, n_model, maxis, batch_axes, zaxis, layer):
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
    partial = _moe_local(cfg, pl_local, xl, lo, E_local, layer)
    y = _SumOverModel.apply(partial, (mesh, names.index(maxis))
                            ).to(x.dtype)
    return DTensor.from_local(y, mesh, x_pl, shape=x.shape,
                              stride=x.stride(), run_check=False)


def _moe_local(cfg: ModelConfig, p, x: torch.Tensor, e_start: int,
               E_local: int, layer: int = 0) -> torch.Tensor:
    """Route ``x``'s tokens, bucket the picks of experts [e_start, e_start
    + E_local) and run them; ``p``'s expert weights hold those E_local
    experts. Returns the float32 partial (B, S, d)."""
    B, S, d = x.shape
    k = cfg.experts_per_token
    T = B * S
    dt = x.dtype
    xf = x.reshape(T, d)
    with device_span("moe_route", layer=layer):
        weights, ids = route(cfg, p, xf)
        flat_e = ids.reshape(-1)
        flat_tok = torch.arange(T, device=x.device)[:, None].expand(T, k)
        hit = (flat_e >= e_start) & (flat_e < e_start + E_local)
        e_rel = torch.where(hit, flat_e - e_start, E_local)  # spare bucket
        order = torch.argsort(e_rel, stable=True)
        e_sorted = e_rel[order]
        tok_sorted = flat_tok.reshape(-1)[order]
        # bincount, without the host sync torch.bincount makes on the card
        counts = torch.zeros(E_local + 1, dtype=torch.long,
                             device=x.device).index_add_(
            0, e_sorted, torch.ones_like(e_sorted))
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.arange(T * k, device=x.device) - starts[e_sorted]
    if cfg.moe_dropless:
        return _dropless(p, xf, weights.reshape(-1)[order], e_sorted,
                         tok_sorted, pos, counts, E_local, layer
                         ).reshape(B, S, d)
    C = capacity(cfg, T)
    ok = (e_sorted < E_local) & (pos < C)
    counter("moe_rows_launched", E_local * C, layer=layer)
    counter("moe_load_reads", load_reads, layer=layer)

    with device_span("moe_experts", layer=layer):
        # Buckets (E_local, C, d), a prefix of one buffer with a spare row
        # for the dropped picks.
        slot = torch.where(ok, e_sorted * C + pos, E_local * C)
        buf = torch.zeros((E_local * C + 1, d), dtype=dt, device=x.device)
        buf[slot] = xf[tok_sorted]
        yg = _experts(p, buf[:E_local * C].view(E_local, C, d))

    with device_span("moe_combine", layer=layer):
        w_eff = torch.where(ok, weights.reshape(-1)[order], 0.0)
        picked = yg.reshape(E_local * C, d)[
            torch.clamp(e_sorted, max=E_local - 1) * C
            + torch.clamp(pos, max=C - 1)]
        # multiply in the compute dtype, add in float32 (the reference's
        # casts)
        contrib = (picked * w_eff[:, None].to(dt)).float()
        yf = torch.zeros((T, d), dtype=torch.float32, device=x.device)
        yf.index_add_(0, tok_sorted, contrib)
    return yf.reshape(B, S, d)


def _experts(p, xg: torch.Tensor, segments=None) -> torch.Tensor:
    """The held experts' SwiGLU (three grouped matmuls, kernel 2.5): on
    buckets (E_local, C, d), or given ``segments`` (offsets, tile_expert)
    on rows (R, d) in expert segments."""
    dt = xg.dtype

    def gmm(x, name):
        w = use_param(p[name], dt)
        return ops.moe_gmm(x, w) if segments is None else \
            ops.moe_gmm_grouped(x, w, *segments)

    h = torch.nn.functional.silu(gmm(xg, "w_gate")) * gmm(xg, "w_up")
    return gmm(h, "w_down")


def _dropless(p, xf, w_sorted, e_sorted, tok_sorted, pos, counts,
              E_local: int, layer: int) -> torch.Tensor:
    """Every held pick runs: one host read of the load ``counts`` sizes
    the segments (each held expert's load rounded up to ``GROUP_ROWS``),
    and only the held picks (the sorted order's first) are gathered.
    Returns the float32 partial (T, d)."""
    global load_reads
    load = counts.tolist()
    load_reads += 1
    held, top = sum(load[:E_local]), max(load[:E_local])
    rows = gmm_kernel.GROUP_ROWS
    R = sum(-(-n // rows) for n in load[:E_local]) * rows
    T, d = xf.shape
    dt = xf.dtype
    counter("moe_rows_routed", held, layer=layer)
    counter("moe_rows_launched", R, layer=layer)
    counter("moe_max_load", top, layer=layer)
    counter("moe_load_reads", load_reads, layer=layer)
    yf = torch.zeros((T, d), dtype=torch.float32, device=xf.device)
    if not R:
        return yf
    tok = tok_sorted[:held]
    tiles = torch.div(counts[:E_local] + rows - 1, rows, rounding_mode="floor")
    offsets = torch.cat([tiles.new_zeros(1), torch.cumsum(tiles, 0) * rows])
    tile_expert = torch.repeat_interleave(
        torch.arange(E_local, device=xf.device), tiles, output_size=R // rows)
    slot = offsets[e_sorted[:held]] + pos[:held]
    with device_span("moe_experts", layer=layer):
        buf = torch.zeros((R, d), dtype=dt, device=xf.device)
        buf[slot] = xf[tok]
        yg = _experts(p, buf, (offsets.to(torch.int32),
                               tile_expert.to(torch.int32)))
    with device_span("moe_combine", layer=layer):
        picked = yg[slot]
        contrib = (picked * w_sorted[:held, None].to(dt)).float()
        yf.index_add_(0, tok, contrib)
    return yf
