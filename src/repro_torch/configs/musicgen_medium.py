"""MusicGen-medium [arXiv:2306.05284; decoder-only over EnCodec tokens].

The modality frontend (EnCodec) is a STUB: ``input_specs()`` provides
precomputed frame embeddings of shape (batch, seq, d_model); the backbone is
a plain decoder-only transformer (MHA, GELU MLP) with a 2048-way codebook head.
A copy of the reference's ``repro/configs/musicgen_medium.py``.
"""

from repro_torch.config.base import ArchFamily, AttentionKind, ModelConfig
from repro_torch.config.registry import register_arch


@register_arch("musicgen-medium")
def musicgen_medium() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family=ArchFamily.AUDIO,
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        vocab_size=2048,
        mlp_kind="gelu",
        attention=AttentionKind.FULL,
        frontend_tokens=0,   # audio frames ARE the sequence (no prefix tokens)
        frontend_dim=1536,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-smoke",
        family=ArchFamily.AUDIO,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        mlp_kind="gelu",
        attention=AttentionKind.FULL,
        frontend_dim=64,
        remat=False,
    )
