"""Qwen3-1.7B [hf:Qwen/Qwen3-8B family; dense GQA with qk_norm]. A copy of
the reference's ``repro/configs/qwen3_1p7b.py``."""

from repro_torch.config.base import ArchFamily, AttentionKind, ModelConfig
from repro_torch.config.registry import register_arch


@register_arch("qwen3-1.7b")
def qwen3_1p7b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b",
        family=ArchFamily.DENSE,
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=6144,
        vocab_size=151936,
        qk_norm=True,
        mlp_kind="swiglu",
        rope_theta=1_000_000.0,
        attention=AttentionKind.FULL,
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    """Small same-family config for CPU smoke tests."""
    return ModelConfig(
        name="qwen3-1.7b-smoke",
        family=ArchFamily.DENSE,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        qk_norm=True,
        mlp_kind="swiglu",
        attention=AttentionKind.FULL,
        tie_embeddings=True,
        remat=False,
    )
