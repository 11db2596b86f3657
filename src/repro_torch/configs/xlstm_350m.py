"""xLSTM-350M [arXiv:2405.04517; sLSTM + mLSTM blocks, attention-free].

Blocks alternate mLSTM / sLSTM (scan over pairs keeps the HLO compact).
d_ff=0 per the assigned table: blocks carry their own up/down projections
(expand factor 2) instead of a separate FFN. Recurrent state -> O(1) decode,
long_500k runs.
A copy of the reference's ``repro/configs/xlstm_350m.py``.
"""

from repro_torch.config.base import ArchFamily, AttentionKind, ModelConfig
from repro_torch.config.registry import register_arch


@register_arch("xlstm-350m")
def xlstm_350m() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        family=ArchFamily.SSM,
        num_layers=24,
        d_model=1024,
        num_heads=4,
        num_kv_heads=4,
        head_dim=256,
        d_ff=0,
        vocab_size=50304,
        attention=AttentionKind.NONE,
        ssm_state=0,
        ssm_expand=2,
        slstm_every=2,
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m-smoke",
        family=ArchFamily.SSM,
        num_layers=4,
        d_model=64,
        num_heads=2,
        num_kv_heads=2,
        head_dim=32,
        d_ff=0,
        vocab_size=256,
        attention=AttentionKind.NONE,
        ssm_expand=2,
        slstm_every=2,
        remat=False,
    )
