"""GLM4-9B [hf:THUDM/glm-4-9b; dense GQA kv=2, RoPE]. A copy of the
reference's ``repro/configs/glm4_9b.py``."""

from repro_torch.config.base import ArchFamily, AttentionKind, ModelConfig
from repro_torch.config.registry import register_arch


@register_arch("glm4-9b")
def glm4_9b() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b",
        family=ArchFamily.DENSE,
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        head_dim=128,
        d_ff=13696,
        vocab_size=151552,
        mlp_kind="swiglu",
        rope_theta=10000.0,
        attention=AttentionKind.FULL,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b-smoke",
        family=ArchFamily.DENSE,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=176,
        vocab_size=256,
        attention=AttentionKind.FULL,
        remat=False,
    )
