"""Configuration dataclasses of the port (see ``base``)."""

from repro_torch.config.base import (ArchFamily, AttentionKind, FLConfig,
                                     JobConfig, MeshConfig, ModelConfig,
                                     OptimizerConfig, ShapeConfig,
                                     TrainConfig)
from repro_torch.config.shapes import SHAPES, shape_applicable
from repro_torch.config.registry import get_arch, list_archs, register_arch

__all__ = ["ArchFamily", "AttentionKind", "FLConfig", "JobConfig",
           "MeshConfig", "ModelConfig", "OptimizerConfig", "ShapeConfig",
           "TrainConfig",
           "SHAPES", "shape_applicable", "get_arch", "list_archs",
           "register_arch"]
