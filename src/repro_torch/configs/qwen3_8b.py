"""Qwen3-8B [hf:Qwen/Qwen3-8B; dense GQA with qk_norm]. A copy of the
reference's ``repro/configs/qwen3_8b.py``."""

from repro_torch.config.base import ArchFamily, AttentionKind, ModelConfig
from repro_torch.config.registry import register_arch


@register_arch("qwen3-8b")
def qwen3_8b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b",
        family=ArchFamily.DENSE,
        num_layers=36,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab_size=151936,
        qk_norm=True,
        mlp_kind="swiglu",
        rope_theta=1_000_000.0,
        attention=AttentionKind.FULL,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b-smoke",
        family=ArchFamily.DENSE,
        num_layers=2,
        d_model=96,
        num_heads=6,
        num_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=256,
        qk_norm=True,
        attention=AttentionKind.FULL,
        remat=False,
    )
