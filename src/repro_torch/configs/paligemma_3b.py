"""PaliGemma-3B [arXiv:2407.07726; SigLIP + Gemma-2B backbone].

The SigLIP vision tower is a STUB: ``input_specs()`` provides 256 precomputed
patch embeddings (batch, 256, d_model) prepended to the token sequence.
Backbone = Gemma-2B: 18L, d_model 2048, 8 heads with head_dim 256, MQA (kv=1),
GeGLU d_ff 16384, vocab 257216, tied. A copy of the reference's
``repro/configs/paligemma_3b.py``.
"""

from repro_torch.config.base import ArchFamily, AttentionKind, ModelConfig
from repro_torch.config.registry import register_arch


@register_arch("paligemma-3b")
def paligemma_3b() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b",
        family=ArchFamily.VLM,
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=257216,
        mlp_kind="geglu",
        attention=AttentionKind.FULL,
        frontend_tokens=256,
        frontend_dim=2048,
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b-smoke",
        family=ArchFamily.VLM,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=192,
        vocab_size=256,
        mlp_kind="geglu",
        attention=AttentionKind.FULL,
        frontend_tokens=16,
        frontend_dim=64,
        tie_embeddings=True,
        remat=False,
    )
