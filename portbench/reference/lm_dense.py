"""Plain reference of the port's dense decoder LM family, for ``lm_train``
cells: qwen3-1.7b's block and its siblings, in plain ``torch``.

The math is the repository's model, written again from its description:

    x = E[tokens] * sqrt(d)
    per layer:  h = rmsnorm(x)
                q, k, v = h Wq, h Wk, h Wv   (H query heads, KV key-value
                                              heads of size D; GQA)
                q, k = rmsnorm per head (eps 1e-6)        where qk_norm
                q, k = RoPE(q), RoPE(k)     (rotate-half, base rope_theta)
                x += softmax(q k^T / sqrt(D) + causal mask) v  Wo
                x += (act(g Wg) * (g Wu)) Wd, g = rmsnorm(x)
                     (SwiGLU: act = silu; GeGLU: tanh-GELU; a GELU MLP has
                      no Wg)
    logits = rmsnorm(x) E^T (tied) or rmsnorm(x) W_head
    loss   = mean next-token cross-entropy over the batch.

One departure from the published Qwen3 (and from Hugging Face's model):
the embedding is scaled by sqrt(d_model), as the repository's model does.
Everything runs in float32 (the caller turns TF32 off), or, for the
control, in ``float8_e4m3fn`` under a per-tensor scale: every matmul's
inputs and output (the logits too), the residual stream after each add
and the scaled embedding are rounded to it, and so is the gradient that
flows back through each of those points.

Memory: the gradient is taken layer by layer. The forward keeps only each
layer's input; the backward recomputes one layer at a time under
autograd, so published widths fit on one card.

The parameters are a flat dict ``{path: tensor}`` in the program's layout
(``param_shapes``): every block leaf stacked on a leading layer axis.
Nothing here imports the program, JAX or the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

QK_NORM_EPS = 1e-6
FP8_MAX = 448.0          # the largest finite float8_e4m3fn


def param_shapes(model: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's path and shape, in the program's layout."""
    if model["family"] != "dense":
        raise ValueError(f"{model['name']}: lm_dense covers the dense "
                         f"family, not {model['family']!r}")
    L, d, f, V = (model["num_layers"], model["d_model"], model["d_ff"],
                  model["vocab_size"])
    h, kv, D = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    out = {"embed/embedding": (V, d), "final_norm/scale": (d,),
           "blocks/attn/wq": (L, d, h * D), "blocks/attn/wk": (L, d, kv * D),
           "blocks/attn/wv": (L, d, kv * D), "blocks/attn/wo": (L, h * D, d),
           "blocks/mlp/w_up": (L, d, f), "blocks/mlp/w_down": (L, f, d),
           "blocks/norm1/scale": (L, d), "blocks/norm2/scale": (L, d)}
    if model["qk_norm"]:
        out["blocks/attn/q_norm"] = (L, D)
        out["blocks/attn/k_norm"] = (L, D)
    if model["mlp_kind"] in ("swiglu", "geglu"):
        out["blocks/mlp/w_gate"] = (L, d, f)
    if not model["tie_embeddings"]:
        out["head/w"] = (d, V)
    return dict(sorted(out.items()))


def init_std(path: str, shape: Tuple[int, ...]) -> Optional[float]:
    """The standard deviation a leaf is drawn with, or None for a norm
    scale (ones): 1/sqrt(fan-in), the embedding's 1/sqrt(d)."""
    if path.endswith(("scale", "q_norm", "k_norm")):
        return None
    if path == "embed/embedding":
        return 1.0 / math.sqrt(shape[-1])
    return 1.0 / math.sqrt(shape[-2])


def step_flops(model: dict, batch: int, seq_len: int) -> int:
    """Matmul FLOPs of one training step (forward, and twice the forward
    for the input and weight gradients), as the model needs them: causal
    attention over the lower triangle only, the unembedding over the
    S - 1 positions that carry a label, no recomputation counted."""
    d, f, V, L = (model["d_model"], model["d_ff"], model["vocab_size"],
                  model["num_layers"])
    h, kv, D = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    T = batch * seq_len
    mlp = (3 if model["mlp_kind"] in ("swiglu", "geglu") else 2) * d * f
    proj = d * h * D + 2 * d * kv * D + h * D * d
    attn = 2 * batch * h * D * seq_len * (seq_len + 1) // 2  # QK^T and PV
    forward = 2 * (L * (T * (proj + mlp) + attn)
                   + batch * (seq_len - 1) * d * V)
    return 3 * forward


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` cast to float8_e4m3fn under a per-tensor scale (its largest
    magnitude to 448) and back."""
    scale = FP8_MAX / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    """``_fp8`` forward, and ``_fp8`` of the gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` in ``precision``: as it is in float32, or rounded to
    float8_e4m3fn forward and backward."""
    if precision == "float32":
        return x
    if precision != "float8_e4m3fn":
        raise ValueError(f"unknown precision {precision!r}")
    return _Fp8.apply(x)


def _mm(a, b, precision):
    return rounded(rounded(a, precision) @ rounded(b, precision), precision)


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    """x (B, S, heads, D), rotated by its position along S."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    freq = (1.0 / theta) ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def block(model: dict, p: Dict[str, torch.Tensor], x: torch.Tensor,
          precision: str = "float32") -> torch.Tensor:
    """One layer; ``p`` maps ``attn/wq``, ... to this layer's tensors."""
    B, S, d = x.shape
    h, kv, D = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    eps = model["norm_eps"]
    a = _rmsnorm(x, p["norm1/scale"], eps)
    q = _mm(a, p["attn/wq"], precision).view(B, S, h, D)
    k = _mm(a, p["attn/wk"], precision).view(B, S, kv, D)
    v = _mm(a, p["attn/wv"], precision).view(B, S, kv, D)
    if model["qk_norm"]:
        q = _rmsnorm(q, p["attn/q_norm"], QK_NORM_EPS)
        k = _rmsnorm(k, p["attn/k_norm"], QK_NORM_EPS)
    q, k = _rope(q, model["rope_theta"]), _rope(k, model["rope_theta"])
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # (B, h, S, D)
    scores = _mm(q, k.transpose(-1, -2), precision) / math.sqrt(D)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, -math.inf), dim=-1)
    o = _mm(probs, v, precision).transpose(1, 2).reshape(B, S, h * D)
    x = rounded(x + _mm(o, p["attn/wo"], precision), precision)
    g = _rmsnorm(x, p["norm2/scale"], eps)
    up = _mm(g, p["mlp/w_up"], precision)
    if model["mlp_kind"] == "gelu":
        hid = F.gelu(up, approximate="tanh")
    else:
        act = F.silu if model["mlp_kind"] == "swiglu" else \
            (lambda t: F.gelu(t, approximate="tanh"))
        hid = act(_mm(g, p["mlp/w_gate"], precision)) * up
    return rounded(x + _mm(hid, p["mlp/w_down"], precision), precision)


def _layer(params: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {k[len("blocks/"):]: v[i] for k, v in params.items()
            if k.startswith("blocks/")}


def loss_and_grads(model: dict, params: Dict[str, torch.Tensor],
                   tokens: torch.Tensor, precision: str = "float32"
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(mean next-token loss, d loss / d leaf for every leaf of
    ``params``), layer by layer."""
    L, d = model["num_layers"], model["d_model"]
    emb = params["embed/embedding"]
    with torch.no_grad():
        xs = [rounded(emb[tokens.long()] * math.sqrt(d), precision)]
        for i in range(L):
            xs.append(block(model, _layer(params, i), xs[-1], precision))
    grads = {k: torch.zeros_like(v) for k, v in params.items()}

    # The head: final norm, unembedding, cross-entropy.
    top = xs.pop().requires_grad_()
    head = {k: params[k].detach().requires_grad_()
            for k in ("final_norm/scale", "embed/embedding", "head/w")
            if k in params}
    with torch.enable_grad():
        y = _rmsnorm(top, head["final_norm/scale"], model["norm_eps"])[:, :-1]
        w = head["head/w"] if "head/w" in head else \
            head["embed/embedding"].t()
        logits = _mm(y, w, precision)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               tokens[:, 1:].reshape(-1).long())
        names = list(head)
        out = torch.autograd.grad(loss, [top] + [head[k] for k in names])
    gx = out[0]
    for k, g in zip(names, out[1:]):
        grads[k] += g
    del logits, y, out

    # The blocks, last first, each recomputed from its input.
    stacked = [k for k in params if k.startswith("blocks/")]
    for i in reversed(range(L)):
        x = xs.pop().requires_grad_()
        p = {k[len("blocks/"):]: params[k][i].detach().requires_grad_()
             for k in stacked}
        with torch.enable_grad():
            y = block(model, p, x, precision)
            out = torch.autograd.grad(y, [x] + list(p.values()), gx)
        gx = out[0]
        for k, g in zip(stacked, out[1:]):
            grads[k][i] = g
        del y, out
    # The embedding's gather: d x0 / d E[t] = sqrt(d) at each position.
    if precision != "float32":
        gx = _fp8(gx)
    grads["embed/embedding"].index_add_(
        0, tokens.reshape(-1).long(),
        (gx * math.sqrt(d)).reshape(-1, d))
    return float(loss.detach()), grads
