"""Trinity-Mini [hf:arcee-ai/Trinity-Mini, config.json; Arcee AFMoE:
26B-A3B]. The port's own configuration: the JAX package has no such
model, so these ids stay out of ``ASSIGNED_ARCHS``.

32 layers at d_model 2,048; 32 query and 4 key-value heads of 128, q and
k RMS-normed per head; three layers of sliding-window attention (window
2,048, RoPE at base 10,000) then one of full attention without position
encoding, repeated (``global_attn_every_n=4``); a sigmoid gate on the
attention output; every sublayer's output RMS-normed before its residual
add (four norms a layer, eps 1e-5); 2 leading dense SwiGLU layers of 6,144,
then 30 MoE layers of 128 routed SwiGLU experts of 1,024 (top-8, sigmoid
scores, the picks' weights normalised and scaled by 2.826, no pick
dropped) beside one shared expert; untied head, vocabulary 200,192; the
embedding scaled by sqrt(d_model) (``mup_enabled``).

``trinity-mini-ep8-8l`` is one chip's share of an 8-GPU node that trains
the model with each expert layer split 8 ways and the embedding and head
split by vocabulary: 16 of each layer's 128 experts held (the router keeps
its 128 outputs and top-8), a vocabulary slice of 25,024 (an eighth), and
the first 8 layers (the 2 dense and 6 MoE layers: two whole periods of the
3:1 pattern), the head kept so that the step ends in its loss. Widths are
the published ones.
"""

import dataclasses

from repro_torch.config.base import ArchFamily, AttentionKind, ModelConfig
from repro_torch.config.registry import register_arch


@register_arch("trinity-mini")
def trinity_mini() -> ModelConfig:
    return ModelConfig(
        name="trinity-mini",
        family=ArchFamily.MOE,
        num_layers=32,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=1024,
        vocab_size=200192,
        qk_norm=True,
        mlp_kind="swiglu",
        rope_theta=10_000.0,
        tie_embeddings=False,
        norm_eps=1e-5,
        qk_norm_eps=1e-5,
        sandwich_norm=True,
        attention=AttentionKind.SLIDING,
        sliding_window=2048,
        global_attn_every_n=4,
        attn_out_gate=True,
        num_experts=128,
        experts_per_token=8,
        moe_dense_first_n=2,
        dense_d_ff=6144,
        num_shared_experts=1,
        router_score="sigmoid",
        route_scale=2.826,
        moe_dropless=True,
    )


@register_arch("trinity-mini-ep8-8l")
def trinity_mini_ep8_8l() -> ModelConfig:
    return dataclasses.replace(trinity_mini(), name="trinity-mini-ep8-8l",
                               num_layers=8, experts_held=16,
                               vocab_size=25024)


def reduced() -> ModelConfig:
    """Small same-block config for CPU tests: 2 dense and 4 MoE layers (a
    whole period of the 3:1 pattern and more, every kind of layer), 8 of
    16 experts held, top-4, a window of 8."""
    return dataclasses.replace(
        trinity_mini(), name="trinity-mini-smoke", num_layers=6,
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=32,
        dense_d_ff=96, vocab_size=256, sliding_window=8, num_experts=16,
        experts_per_token=4, experts_held=8, remat=False)
