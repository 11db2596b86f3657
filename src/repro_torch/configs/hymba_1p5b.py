"""Hymba-1.5B [arXiv:2411.13676; hybrid parallel attention+Mamba heads].

Every block runs attention heads and SSM (Mamba-style selective-scan) heads
in PARALLEL on the same input and fuses their outputs (mean), per the paper.
Attention is sliding-window (global layers omitted for uniform scan blocks),
making the arch sub-quadratic -> long_500k runs.
A copy of the reference's ``repro/configs/hymba_1p5b.py``.
"""

from repro_torch.config.base import ArchFamily, AttentionKind, ModelConfig
from repro_torch.config.registry import register_arch


@register_arch("hymba-1.5b")
def hymba_1p5b() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family=ArchFamily.HYBRID,
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        mlp_kind="swiglu",
        attention=AttentionKind.SLIDING,
        sliding_window=1024,
        ssm_state=16,
        ssm_expand=2,
        hybrid_parallel=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b-smoke",
        family=ArchFamily.HYBRID,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attention=AttentionKind.SLIDING,
        sliding_window=32,
        ssm_state=8,
        ssm_expand=2,
        hybrid_parallel=True,
        remat=False,
    )
