"""Plain reference of Trinity's AFMoE decoder LM (Arcee, Trinity-Mini:
https://huggingface.co/arcee-ai/Trinity-Mini/blob/main/config.json), for
``lm_train`` cells, in plain ``torch``.

The math, written again from the model's description (``L`` the layer
index; a layer is full when ``(L + 1) % global_attn_every_n == 0``, else
sliding with window ``W``):

    x0 = E[tokens] * sqrt(d)                       (mup_enabled)
    a  = rmsnorm_in(x)
    q  = rmsnorm_q(a Wq), k = rmsnorm_k(a Wk)      (per head; GQA)
    v  = a Wv
    q, k = RoPE(q), RoPE(k)                        (sliding layers only)
    o  = softmax(q k^T / sqrt(D) + causal mask [and i - j < W]) v
    o  = o * sigmoid(a Wg)                         (the output gate)
    x  = x + rmsnorm_post_attn(o Wo)
    b  = rmsnorm_pre_mlp(x)
    m  = SwiGLU_dense(b)                           (leading dense layers)
    m  = SwiGLU_shared(b) + sum_{e in top-k, e held} w_e SwiGLU_e(b)
         s = sigmoid(b W_r) over all E experts; top-k: the k largest,
         the lower id first among equal ones;
         w = s[top-k] / (sum s[top-k] + 1e-20) * route_scale
    x  = x + rmsnorm_post_mlp(m)
    logits = rmsnorm_final(x) W_head
    loss   = mean next-token cross-entropy over the batch.

Every norm is RMSNorm with eps ``norm_eps`` (1e-5), q and k per head with
``qk_norm_eps``. ``config.json`` gives the widths, the layer pattern, the
window, the router's ``score_func``, ``route_norm`` and ``route_scale``,
the shared expert and the leading dense layers. Where the gate sits, the
four norms a layer, RoPE on the sliding layers alone and the weights'
normalisation before their scale rest on the description of Hugging
Face's ``modeling_afmoe.py``, which is not read here. Departures: the
published selection adds an expert bias that starts at zero and moves
only by an aux-loss-free balancing rule outside the gradient
(``load_balance_coeff``); it is left at zero and the rule left out. The
norm gains start at ones. A layer that holds experts [0, held) of E
(``experts_held``) routes over all E and adds only its own experts' part,
as the program's share does.

Such a cut stands for one chip of an expert-parallel node only while its
held experts take about their share of the picks: on the node, the
exchange returns the other chips' experts' outputs, while here they add
nothing, so training can teach the router to send the picks elsewhere
(with the balancing rule left out). ``loss_and_grads`` counts the held
picks of its forward over the batch and the MoE layers and raises
``RoutingDrift`` where their ratio to the expectation (``expected_picks``)
leaves ``HELD_BAND``: the run then exits with the reason instead of
reading a load the deployment never sees.

Everything runs in float32 (the caller turns TF32 off), or, for the
control, in ``float8_e4m3fn`` at ``lm_dense``'s rounding points (every
matmul's inputs and output, the expert products and the router's among
them, the logits, the residual stream after each add and the scaled
embedding) and the gradients through them; each tensor's scale is per
batch row here.

Memory: the gradient is taken one batch row at a time (rows do not
interact once routing drops nothing; each row's loss weighs 1/B), and
layer by layer: the forward keeps only each layer's input, and the
backward recomputes one layer at a time under autograd.

The parameters are a flat dict ``{path: tensor}`` in the program's layout
(``param_shapes``): the leading dense layers stacked under
``dense_blocks/``, the MoE layers under ``blocks/``. Nothing here imports
the program, JAX or the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import lm_dense

_mm, _rmsnorm, _rope, rounded = (lm_dense._mm, lm_dense._rmsnorm,
                                 lm_dense._rope, lm_dense.rounded)
init_std = lm_dense.init_std
STACKS = ("dense_blocks", "blocks")
#: Held picks over their expectation that ``loss_and_grads`` accepts, for
#: a model that holds part of its experts. trinity-mini's cell read
#: 0.855-1.056 over its batches and seeds (a batch's ids alone move it by
#: about 0.05), and 0.03 within 15 steps where the router starved the held
#: experts (lr 3e-4).
HELD_BAND = (0.6, 1.4)


class RoutingDrift(ValueError):
    """The held experts' picks left ``HELD_BAND``: their number
    (``picks``) and ``held_share``'s reading of it (``share``)."""

    def __init__(self, message: str, picks: int, share: float):
        super().__init__(message)
        self.picks, self.share = picks, share


def _check(model: dict) -> None:
    want = dict(family="moe", qk_norm=True, sandwich_norm=True,
                attn_out_gate=True, router_score="sigmoid",
                moe_dropless=True, num_shared_experts=1, mlp_kind="swiglu",
                tie_embeddings=False, attention="sliding")
    bad = {k: model.get(k) for k, v in want.items() if model.get(k) != v}
    if bad:
        raise ValueError(f"{model['name']}: lm_afmoe covers Trinity's AFMoE "
                         f"block; this model has {bad}")


def _held(model: dict) -> int:
    return model["experts_held"] or model["num_experts"]


def param_shapes(model: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's path and shape, in the program's layout."""
    _check(model)
    L, d, f, V = (model["num_layers"], model["d_model"], model["d_ff"],
                  model["vocab_size"])
    h, kv, D = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    fd, E, n_dense = (model["dense_d_ff"] or f, model["num_experts"],
                      model["moe_dense_first_n"])
    out = {"embed/embedding": (V, d), "final_norm/scale": (d,),
           "head/w": (d, V)}
    for stack, n in zip(STACKS, (n_dense, L - n_dense)):
        if not n:
            continue
        s = {"attn/wq": (d, h * D), "attn/wk": (d, kv * D),
             "attn/wv": (d, kv * D), "attn/wo": (h * D, d),
             "attn/wg": (d, h * D), "attn/q_norm": (D,),
             "attn/k_norm": (D,), "norm1/scale": (d,), "norm2/scale": (d,),
             "post_attn_norm/scale": (d,), "post_mlp_norm/scale": (d,)}
        if stack == "dense_blocks":
            s.update({"mlp/w_gate": (d, fd), "mlp/w_up": (d, fd),
                      "mlp/w_down": (fd, d)})
        else:
            held = _held(model)
            s.update({"moe/router": (d, E), "moe/w_gate": (held, d, f),
                      "moe/w_up": (held, d, f), "moe/w_down": (held, f, d),
                      "moe/shared/w_gate": (d, f), "moe/shared/w_up": (d, f),
                      "moe/shared/w_down": (f, d)})
        out.update({f"{stack}/{k}": (n,) + v for k, v in s.items()})
    return dict(sorted(out.items()))


def _attn_pairs(model: dict, seq_len: int, layer: int) -> int:
    """(query, key) pairs a row attends in ``layer``: the lower triangle,
    cut to the window on sliding layers."""
    S, W = seq_len, model["sliding_window"]
    if _is_full(model, layer) or W >= S:
        return S * (S + 1) // 2
    return W * (W + 1) // 2 + (S - W) * W


def _is_full(model: dict, layer: int) -> bool:
    n = model["global_attn_every_n"]
    return n > 0 and (layer + 1) % n == 0


def expected_picks(model: dict, tokens: int) -> int:
    """Picks that fall on the held experts a MoE layer, as their
    expectation: tokens x k x held / E."""
    return tokens * model["experts_per_token"] * _held(model) \
        // model["num_experts"]


def expert_flops(model: dict, batch: int, seq_len: int,
                 remat: Optional[bool] = None) -> int:
    """FLOPs of one step's expert products on the held picks (their
    expectation; padding rows left out): each SwiGLU's three products
    forward, again where blocks are recomputed (``remat``, default the
    model's), and twice backward (input and weight gradients)."""
    remat = model["remat"] if remat is None else remat
    n_moe = model["num_layers"] - model["moe_dense_first_n"]
    forward = 2 * 3 * model["d_model"] * model["d_ff"] \
        * expected_picks(model, batch * seq_len)
    return (4 if remat else 3) * n_moe * forward


def step_flops(model: dict, batch: int, seq_len: int) -> int:
    """Matmul FLOPs of one training step (forward, and twice the forward
    for the input and weight gradients), as the model needs them: causal
    attention over the lower triangle, cut to the window on sliding
    layers; the routed experts at their expected picks; the unembedding
    over the S - 1 positions that carry a label; no recomputation
    counted."""
    d, f, V, L = (model["d_model"], model["d_ff"], model["vocab_size"],
                  model["num_layers"])
    h, kv, D = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    fd, E, n_dense = (model["dense_d_ff"] or f, model["num_experts"],
                      model["moe_dense_first_n"])
    T = batch * seq_len
    proj = 2 * d * h * D + 2 * d * kv * D + h * D * d   # q, gate, k, v, o
    total = 0
    for layer in range(L):
        total += T * proj + 2 * batch * h * D * _attn_pairs(model, seq_len,
                                                            layer)
        if layer < n_dense:
            total += T * 3 * d * fd
        else:
            total += T * (d * E + 3 * d * f) \
                + expected_picks(model, T) * 3 * d * f
    forward = 2 * (total + batch * (seq_len - 1) * d * V)
    return 3 * forward


def _swiglu(x, w_gate, w_up, w_down, precision):
    return _mm(F.silu(_mm(x, w_gate, precision)) * _mm(x, w_up, precision),
               w_down, precision)


def _experts(model: dict, p: Dict[str, torch.Tensor], b: torch.Tensor,
             precision: str, tally: Optional[list] = None) -> torch.Tensor:
    """The held experts' part of the routed sum, (T, d); appends the
    number of held picks to ``tally`` where given."""
    k = model["experts_per_token"]
    s = torch.sigmoid(_mm(b, p["moe/router"], precision))
    top, ids = torch.sort(s, dim=-1, descending=True, stable=True)
    top, ids = top[:, :k], ids[:, :k]
    w = top / (top.sum(-1, keepdim=True) + 1e-20) * model["route_scale"]
    if tally is not None:
        tally.append(int((ids < _held(model)).sum()))
    out = torch.zeros_like(b)
    for e in range(_held(model)):
        hit = ids == e
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        y = _swiglu(b[rows], p["moe/w_gate"][e], p["moe/w_up"][e],
                    p["moe/w_down"][e], precision)
        out = out.index_add(0, rows, y * (w * hit).sum(-1)[rows, None])
    return out


def block(model: dict, p: Dict[str, torch.Tensor], x: torch.Tensor,
          layer: int, precision: str = "float32",
          tally: Optional[list] = None) -> torch.Tensor:
    """Layer ``layer``; ``p`` maps ``attn/wq``, ... to its tensors; a MoE
    layer appends its held picks to ``tally`` where given."""
    B, S, d = x.shape
    h, kv, D = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    eps, qk_eps = model["norm_eps"], model["qk_norm_eps"]
    full = _is_full(model, layer)
    a = _rmsnorm(x, p["norm1/scale"], eps)
    q = _rmsnorm(_mm(a, p["attn/wq"], precision).view(B, S, h, D),
                 p["attn/q_norm"], qk_eps)
    k = _rmsnorm(_mm(a, p["attn/wk"], precision).view(B, S, kv, D),
                 p["attn/k_norm"], qk_eps)
    v = _mm(a, p["attn/wv"], precision).view(B, S, kv, D)
    if not full:
        q, k = _rope(q, model["rope_theta"]), _rope(k, model["rope_theta"])
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # (B, h, S, D)
    scores = _mm(q, k.transpose(-1, -2), precision) / math.sqrt(D)
    i = torch.arange(S, device=x.device)
    keep = i[:, None] >= i[None, :]
    if not full:
        keep &= i[:, None] - i[None, :] < model["sliding_window"]
    probs = torch.softmax(scores.masked_fill(~keep, -math.inf), dim=-1)
    o = _mm(probs, v, precision).transpose(1, 2).reshape(B, S, h * D)
    o = o * torch.sigmoid(_mm(a, p["attn/wg"], precision))
    x = rounded(x + _rmsnorm(_mm(o, p["attn/wo"], precision),
                             p["post_attn_norm/scale"], eps), precision)
    b = _rmsnorm(x, p["norm2/scale"], eps)
    if "mlp/w_up" in p:
        m = _swiglu(b, p["mlp/w_gate"], p["mlp/w_up"], p["mlp/w_down"],
                    precision)
    else:
        m = _swiglu(b, p["moe/shared/w_gate"], p["moe/shared/w_up"],
                    p["moe/shared/w_down"], precision) \
            + _experts(model, p, b.reshape(B * S, d), precision,
                       tally).view(B, S, d)
    return rounded(x + _rmsnorm(m, p["post_mlp_norm/scale"], eps),
                   precision)


def _where(model: dict, layer: int) -> Tuple[str, int]:
    """(stack, index in it) of ``layer``."""
    n_dense = model["moe_dense_first_n"]
    return (STACKS[0], layer) if layer < n_dense else \
        (STACKS[1], layer - n_dense)


def _layer_params(params: Dict[str, torch.Tensor], stack: str, i: int
                  ) -> Dict[str, torch.Tensor]:
    return {k[len(stack) + 1:]: v[i] for k, v in params.items()
            if k.startswith(stack + "/")}


def logits(model: dict, params: Dict[str, torch.Tensor],
           tokens: torch.Tensor) -> torch.Tensor:
    """The float32 logits (B, S, V) of ``tokens``, with no gradient."""
    _check(model)
    with torch.no_grad():
        x = params["embed/embedding"][tokens.long()] \
            * math.sqrt(model["d_model"])
        for layer in range(model["num_layers"]):
            stack, i = _where(model, layer)
            x = block(model, _layer_params(params, stack, i), x, layer)
        return _rmsnorm(x, params["final_norm/scale"],
                        model["norm_eps"]) @ params["head/w"]


def _row(model: dict, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
         grads: Dict[str, torch.Tensor], weight: float, precision: str,
         tally: list) -> float:
    """One batch row (1, S): its mean next-token loss; adds ``weight``
    times its gradient into ``grads`` and its held picks to ``tally``."""
    L, d = model["num_layers"], model["d_model"]
    emb = params["embed/embedding"]
    with torch.no_grad():
        xs = [rounded(emb[tokens.long()] * math.sqrt(d), precision)]
        for layer in range(L):
            stack, i = _where(model, layer)
            xs.append(block(model, _layer_params(params, stack, i), xs[-1],
                            layer, precision, tally))

    top = xs.pop().requires_grad_()
    head = {k: params[k].detach().requires_grad_()
            for k in ("final_norm/scale", "head/w")}
    with torch.enable_grad():
        y = _rmsnorm(top, head["final_norm/scale"], model["norm_eps"])[:, :-1]
        logits = _mm(y, head["head/w"], precision)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               tokens[:, 1:].reshape(-1).long())
        out = torch.autograd.grad(loss * weight,
                                  [top] + list(head.values()))
    gx = out[0]
    for k, g in zip(head, out[1:]):
        grads[k] += g
    del logits, y, out

    for layer in reversed(range(L)):
        stack, i = _where(model, layer)
        x = xs.pop().requires_grad_()
        names = [k for k in params if k.startswith(stack + "/")]
        p = {k[len(stack) + 1:]: params[k][i].detach().requires_grad_()
             for k in names}
        with torch.enable_grad():
            y = block(model, p, x, layer, precision)
            # an expert that no token of this row picked gets no gradient
            out = torch.autograd.grad(y, [x] + list(p.values()), gx,
                                      allow_unused=True)
        gx = out[0]
        for k, g in zip(names, out[1:]):
            if g is not None:
                grads[k][i] += g
        del y, out
    # The embedding's gather: d x0 / d E[t] = sqrt(d) at each position.
    if precision != "float32":
        gx = lm_dense._fp8(gx)
    grads["embed/embedding"].index_add_(
        0, tokens.reshape(-1).long(), (gx * math.sqrt(d)).reshape(-1, d))
    return float(loss.detach())


def held_share(model: dict, picks: int, tokens: int) -> float:
    """Held picks over their expectation, over ``tokens`` tokens of every
    MoE layer."""
    n_moe = model["num_layers"] - model["moe_dense_first_n"]
    return picks / (n_moe * expected_picks(model, tokens))


def loss_and_grads(model: dict, params: Dict[str, torch.Tensor],
                   tokens: torch.Tensor, precision: str = "float32",
                   band: Optional[Tuple[float, float]] = HELD_BAND
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(mean next-token loss, d loss / d leaf for every leaf of
    ``params``), row by row and layer by layer. Where the model holds part
    of its experts and ``band`` is given, raises ``RoutingDrift`` if their
    picks' ``held_share`` leaves it."""
    _check(model)
    B = tokens.shape[0]
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    loss, tally = 0.0, []
    for r in range(B):
        loss += _row(model, params, tokens[r:r + 1], grads, 1.0 / B,
                     precision, tally) / B
    if band is not None and _held(model) < model["num_experts"]:
        share = held_share(model, sum(tally), tokens.numel())
        if not band[0] <= share <= band[1]:
            raise RoutingDrift(
                f"{model['name']}: the {_held(model)} held experts took "
                f"{sum(tally)} picks, {share:.3f} of their expectation, "
                f"outside {band}: the router has drifted from the share "
                "this chip holds on its node", sum(tally), share)
    return loss, grads
