"""DBRX-132B [hf:databricks/dbrx-base; MoE 16 experts top-4, fine-grained].
A copy of the reference's ``repro/configs/dbrx_132b.py``."""

from repro_torch.config.base import ArchFamily, AttentionKind, ModelConfig
from repro_torch.config.registry import register_arch


@register_arch("dbrx-132b")
def dbrx_132b() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        family=ArchFamily.MOE,
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=10752,
        vocab_size=100352,
        mlp_kind="swiglu",
        rope_theta=500_000.0,
        attention=AttentionKind.FULL,
        num_experts=16,
        experts_per_token=4,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b-smoke",
        family=ArchFamily.MOE,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        attention=AttentionKind.FULL,
        num_experts=4,
        experts_per_token=2,
        remat=False,
    )
