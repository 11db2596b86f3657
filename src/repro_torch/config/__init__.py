"""Configuration dataclasses of the port (see ``base``)."""

from repro_torch.config.base import (ArchFamily, AttentionKind, FLConfig,
                                     JobConfig, ModelConfig, OptimizerConfig,
                                     ShapeConfig, TrainConfig)

__all__ = ["ArchFamily", "AttentionKind", "FLConfig", "JobConfig",
           "ModelConfig", "OptimizerConfig", "ShapeConfig", "TrainConfig"]
