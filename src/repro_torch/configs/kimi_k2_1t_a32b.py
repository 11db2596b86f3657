"""Kimi K2 1T-A32B [arXiv:2501.kimi2 paper table; MoE 384 experts top-8].

~1.04T total / ~31B active parameters with the assigned table values
(61L, d_model 7168, per-expert d_ff 2048, GQA kv=8, vocab 163840), params
stored in bf16. A copy of the reference's
``repro/configs/kimi_k2_1t_a32b.py``.
"""

from repro_torch.config.base import ArchFamily, AttentionKind, ModelConfig
from repro_torch.config.registry import register_arch


@register_arch("kimi-k2-1t-a32b")
def kimi_k2() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family=ArchFamily.MOE,
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        head_dim=112,
        d_ff=2048,
        vocab_size=163840,
        mlp_kind="swiglu",
        rope_theta=50_000.0,
        attention=AttentionKind.FULL,
        num_experts=384,
        experts_per_token=8,
        param_dtype="bfloat16",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-smoke",
        family=ArchFamily.MOE,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=32,
        vocab_size=256,
        attention=AttentionKind.FULL,
        num_experts=8,
        experts_per_token=2,
        remat=False,
    )
