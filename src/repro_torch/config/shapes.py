"""The assigned input-shape set (identical for all 10 LM archs); a copy of
the reference's ``repro/config/shapes.py``."""

from __future__ import annotations

from repro_torch.config.base import ModelConfig, ShapeConfig

SHAPES = {
    "train_4k": ShapeConfig("train_4k", seq_len=4096, global_batch=256, mode="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, mode="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32768, global_batch=128, mode="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524288, global_batch=1, mode="decode"),
}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k needs sub-quadratic attention: a full-attention model would
    hold a 524,288-row KV cache."""
    if shape.name == "long_500k":
        return model.subquadratic
    return True
