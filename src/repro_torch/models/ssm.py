"""SSM / recurrent blocks: Mamba2-style SSD heads (Hymba's parallel SSM
branch) and xLSTM's mLSTM and sLSTM blocks (``repro/models/ssm.py``).

Sequence mixing in the SSD heads and the mLSTM goes through the gated
linear recurrence ``kernels/ops.linear_scan`` (S_t = a_t S_{t-1} + k_t
v_t^T; the prefill kernel); decode is the O(1) ``linear_scan_step``. The
sLSTM is a scalar recurrence with no kernel, in the reference or here: its
``lax.scan`` over time is a loop over time steps.

Scalars the reference forms in the compute dtype stay there: the mLSTM's
``k / sqrt(dh)`` divides by sqrt(dh) rounded to that dtype (22.625 for 512
in bf16). The prefill scans do not form the final state (the reference's
callers drop it, so its compiled program never computes it).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch.sharding import merge_dims, shard, split_dim
from repro_torch.models.layers import normal, param_dtype, use_param, zeros


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


def _state_layout(q, k, v, decay):
    """A decode step's one-token q, k, v (B, H, .) and decay (B, H), laid
    out as the recurrent state is ("cache_batch", "cache_heads"). On plain
    tensors the constraints change nothing; on DTensors they spare
    DTensor's planner a search over the layouts of the step's products."""
    qkv = tuple(shard(t[:, 0], "cache_batch", "cache_heads", None)
                for t in (q, k, v))
    return qkv + (shard(decay[:, 0], "cache_batch", "cache_heads"),)


# ---------- Mamba2-style SSD heads (Hymba's parallel SSM branch) ----------

def _ssd_dims(cfg: ModelConfig):
    H = max(cfg.num_heads, 1)
    dk = cfg.ssm_state or 16
    inner = cfg.ssm_expand * cfg.d_model
    return H, dk, inner, inner // H


def ssd_init(cfg: ModelConfig, rng: np.random.Generator):
    d = cfg.d_model
    H, dk, inner, _ = _ssd_dims(cfg)
    s = 1.0 / np.sqrt(d)
    pd = param_dtype(cfg)
    return {
        "w_in": normal(rng, (d, inner), s, pd),          # value path
        "w_qk": normal(rng, (d, 2 * H * dk), s, pd),     # B, C projections
        "w_dt": normal(rng, (d, H), s, pd),              # per-head decay
        "a_log": zeros((H,), pd),                        # state decay base
        "w_out": normal(rng, (inner, d), 1.0 / np.sqrt(inner), pd),
    }


def ssd_axes():
    return {"w_in": ("embed", "inner"), "w_qk": ("embed", "qkv"),
            "w_dt": ("embed", None), "a_log": (None,),
            "w_out": ("inner", "embed")}


def _ssd_inputs(cfg: ModelConfig, p, x: torch.Tensor):
    """x (B, S, d) -> q, k (B, S, H, dk), v (B, S, H, dv) in x's dtype and
    the decay (B, S, H) in float32."""
    B, S, _ = x.shape
    H, dk, _, dv = _ssd_dims(cfg)
    dt = x.dtype
    v = split_dim(x @ use_param(p["w_in"], dt), 2, (H, dv))
    qk = split_dim(x @ use_param(p["w_qk"], dt), 2, (H, 2 * dk))
    k, q = qk[..., :dk], qk[..., dk:]
    # decay in (0, 1): exp(-softplus(dt) * exp(a_log))
    dt_ctrl = _softplus((x @ use_param(p["w_dt"], dt)).float())
    decay = torch.exp(-dt_ctrl * torch.exp(p["a_log"].float()))
    return q, k, v, decay


def ssd_apply(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d)."""
    q, k, v, decay = _ssd_inputs(cfg, p, x)
    y, _ = ops.linear_scan(q, k, v, decay, want_final_state=False)
    y = shard(merge_dims(y, 2), "batch", None, "act_mlp")
    return y @ use_param(p["w_out"], x.dtype)


def ssd_decode_state(cfg: ModelConfig, batch: int, device="cuda"):
    H, dk, _, dv = _ssd_dims(cfg)
    return (torch.zeros((batch, H, dk, dv), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, H, dk), dtype=torch.float32, device=device))


def ssd_decode(cfg: ModelConfig, p, x: torch.Tensor, state):
    """x (B, 1, d) -> (B, 1, d), new state."""
    B = x.shape[0]
    _, _, inner, _ = _ssd_dims(cfg)
    q, k, v, decay = _state_layout(*_ssd_inputs(cfg, p, x))
    y, state = ops.linear_scan_step(q, k, v, decay, state)
    return y.reshape(B, 1, inner) @ use_param(p["w_out"], x.dtype), state


# ---------- xLSTM: mLSTM block ----------

def _xlstm_dims(cfg: ModelConfig):
    inner = cfg.ssm_expand * cfg.d_model
    return cfg.num_heads, inner, inner // cfg.num_heads


def mlstm_init(cfg: ModelConfig, rng: np.random.Generator):
    d = cfg.d_model
    H, inner, dh = _xlstm_dims(cfg)
    s = 1.0 / np.sqrt(d)
    pd = param_dtype(cfg)
    return {
        "w_up": normal(rng, (d, 2 * inner), s, pd),      # u (values), z (gate)
        "w_qk": normal(rng, (d, 2 * H * dh), s, pd),
        "w_if": normal(rng, (d, 2 * H), s, pd),          # input, forget gates
        "w_down": normal(rng, (inner, d), 1.0 / np.sqrt(inner), pd),
    }


def mlstm_axes():
    return {"w_up": ("embed", "inner"), "w_qk": ("embed", "qkv"),
            "w_if": ("embed", None), "w_down": ("inner", "embed")}


def _mlstm_qkvg(cfg: ModelConfig, p, x: torch.Tensor):
    """x (B, S, d) -> q, k (scaled by the input gate), v (B, S, H, dh), the
    output gate z (B, S, inner) and the forget gate (B, S, H) float32."""
    B, S, _ = x.shape
    H, inner, dh = _xlstm_dims(cfg)
    dt = x.dtype
    uz = x @ use_param(p["w_up"], dt)
    u, z = uz[..., :inner], uz[..., inner:]
    v = split_dim(u, 2, (H, dh))
    qk = split_dim(x @ use_param(p["w_qk"], dt), 2, (H, 2 * dh))
    q, k = qk[..., :dh], qk[..., dh:]
    k = k / torch.sqrt(torch.tensor(dh, dtype=dt, device=x.device))
    gates = (x @ use_param(p["w_if"], dt)).float()
    i_gate = torch.exp(torch.clamp(gates[..., :H], max=8.0))  # exponential
    f_gate = torch.sigmoid(gates[..., H:] + 1.0)             # forget / decay
    return q, k * i_gate[..., None].to(dt), v, z, f_gate


def mlstm_apply(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    q, k, v, z, f_gate = _mlstm_qkvg(cfg, p, x)
    y, _ = ops.linear_scan(q, k, v, f_gate, want_final_state=False)
    y = merge_dims(y, 2) * F.silu(z)
    y = shard(y, "batch", None, "act_mlp")
    return y @ use_param(p["w_down"], x.dtype)


def mlstm_decode_state(cfg: ModelConfig, batch: int, device="cuda"):
    H, _, dh = _xlstm_dims(cfg)
    return (torch.zeros((batch, H, dh, dh), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, H, dh), dtype=torch.float32, device=device))


def mlstm_decode(cfg: ModelConfig, p, x: torch.Tensor, state):
    B = x.shape[0]
    _, inner, _ = _xlstm_dims(cfg)
    q, k, v, z, f_gate = _mlstm_qkvg(cfg, p, x)
    q, k, v, f_gate = _state_layout(q, k, v, f_gate)
    y, state = ops.linear_scan_step(q, k, v, f_gate, state)
    y = y.reshape(B, 1, inner) * F.silu(z)
    return y @ use_param(p["w_down"], x.dtype), state


# ---------- xLSTM: sLSTM block (scalar recurrence, sequential) ----------

def slstm_init(cfg: ModelConfig, rng: np.random.Generator):
    d = cfg.d_model
    H, inner, dh = _xlstm_dims(cfg)
    s = 1.0 / np.sqrt(d)
    pd = param_dtype(cfg)
    return {
        "w_x": normal(rng, (d, 4 * inner), s, pd),       # z, i, f, o
        # block-diagonal recurrence: each head recurs only on itself
        "r_h": normal(rng, (H, dh, 4 * dh), 1.0 / np.sqrt(dh), pd),
        "w_down": normal(rng, (inner, d), 1.0 / np.sqrt(inner), pd),
    }


def slstm_axes():
    return {"w_x": ("embed", "inner"), "r_h": ("heads", None, None),
            "w_down": ("inner", "embed")}


def _slstm_cell(p, carry, xt: torch.Tensor):
    """One sLSTM step with exponential gating and a normaliser state. xt
    (B, 4 inner) input pre-activations; carry (h (B, inner) in xt's dtype,
    c, n (B, inner) float32)."""
    h, c, n = carry
    H, dh = p["r_h"].shape[0], p["r_h"].shape[1]
    B = h.shape[0]
    rec = torch.einsum("bhd,hdf->bhf", split_dim(h, 1, (H, dh)).float(),
                       p["r_h"].float())                 # (B, H, 4 dh)
    z, i, f, o = torch.split(rec, dh, dim=-1)
    xz, xi, xf, xo = (split_dim(t, 1, (H, dh))
                      for t in torch.chunk(xt.float(), 4, dim=-1))
    i = torch.exp(torch.clamp(xi + i, max=8.0))
    f = torch.sigmoid(xf + f + 1.0)
    c = f * split_dim(c, 1, (H, dh)) + i * torch.tanh(xz + z)
    n = f * split_dim(n, 1, (H, dh)) + i
    h_new = torch.sigmoid(xo + o) * (c / torch.clamp(n, min=1.0))
    return (h_new.reshape(B, -1).to(xt.dtype), c.reshape(B, -1),
            n.reshape(B, -1))


def slstm_apply(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    B, S, _ = x.shape
    _, inner, _ = _xlstm_dims(cfg)
    dt = x.dtype
    xs = x @ use_param(p["w_x"], dt)                     # (B, S, 4 inner)
    carry = (torch.zeros((B, inner), dtype=dt, device=x.device),
             torch.zeros((B, inner), dtype=torch.float32, device=x.device),
             torch.zeros((B, inner), dtype=torch.float32, device=x.device))
    hs = []
    for t in range(S):
        carry = _slstm_cell(p, carry, xs[:, t])
        hs.append(carry[0])
    y = shard(torch.stack(hs, 1), "batch", None, "act_mlp")
    return y @ use_param(p["w_down"], dt)


def slstm_decode_state(cfg: ModelConfig, batch: int, dtype, device="cuda"
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _, inner, _ = _xlstm_dims(cfg)
    return (torch.zeros((batch, inner), dtype=dtype, device=device),
            torch.zeros((batch, inner), dtype=torch.float32, device=device),
            torch.zeros((batch, inner), dtype=torch.float32, device=device))


def slstm_decode(cfg: ModelConfig, p, x: torch.Tensor, state):
    xt = x[:, 0] @ use_param(p["w_x"], x.dtype)
    state = _slstm_cell(p, state, xt)
    return state[0][:, None, :] @ use_param(p["w_down"], x.dtype), state
