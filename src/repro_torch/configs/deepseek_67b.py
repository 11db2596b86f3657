"""DeepSeek-67B [arXiv:2401.02954; llama-arch dense GQA]. A copy of the
reference's ``repro/configs/deepseek_67b.py``."""

from repro_torch.config.base import ArchFamily, AttentionKind, ModelConfig
from repro_torch.config.registry import register_arch


@register_arch("deepseek-67b")
def deepseek_67b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b",
        family=ArchFamily.DENSE,
        num_layers=95,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=22016,
        vocab_size=102400,
        mlp_kind="swiglu",
        rope_theta=10000.0,
        attention=AttentionKind.FULL,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b-smoke",
        family=ArchFamily.DENSE,
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=160,
        vocab_size=256,
        attention=AttentionKind.FULL,
        remat=False,
    )
