"""Typed configuration dataclasses: the part the ported paths use.

``ArchFamily``, ``ModelConfig`` and ``JobConfig`` as the engine, the
experiment spec and the CNN zoo (``models/cnn_zoo.py``) use them. The port
carries the paper's CNN classifiers; the reference's language-model fields
(attention, MoE, SSM, numerics) arrive with the LLM zoo, ROADMAP module 10.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class ArchFamily(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    SSM = "ssm"
    HYBRID = "hybrid"
    VLM = "vlm"
    AUDIO = "audio"
    CNN = "cnn"  # paper-plane classifiers


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The model a job trains: a CNN of the paper's zoo (or the scheduler
    plane's ``stub``)."""

    name: str
    family: ArchFamily = ArchFamily.DENSE
    # CNN-family (paper plane) description: sequence of layer specs.
    cnn_spec: Tuple = ()
    input_shape: Tuple[int, ...] = ()
    num_classes: int = 0

    def param_count(self) -> int:
        if self.family != ArchFamily.CNN:
            raise NotImplementedError(
                f"{self.name}: language-model configs are ROADMAP module 10, "
                "not ported yet")
        return _cnn_param_count(self)


def _cnn_param_count(cfg: ModelConfig) -> int:
    """Parameter count for the CNN zoo, derived from the spec tuples."""
    n = 0
    c = cfg.input_shape[-1]
    spatial = cfg.input_shape[0]
    for layer in cfg.cnn_spec:
        kind = layer[0]
        if kind in ("conv", "convp"):
            _, out_c, k = layer
            n += k * k * c * out_c + out_c
            c = out_c
            if kind == "convp":
                spatial //= 2
        elif kind == "gn":
            n += 2 * c
        elif kind == "res":
            _, out_c, stride = layer
            n += 9 * c * out_c + out_c + 9 * out_c * out_c + out_c
            if stride != 1 or c != out_c:
                n += c * out_c + out_c  # 1x1 projection shortcut
            c = out_c
            spatial //= stride
        elif kind == "flatten":
            c = c * spatial * spatial
        elif kind == "fc":
            _, width = layer
            n += c * width + width
            c = width
    n += c * cfg.num_classes + cfg.num_classes
    return n


@dataclasses.dataclass(frozen=True)
class JobConfig:
    """One FL job: a model trained to a target metric."""

    job_id: int
    model: ModelConfig
    target_metric: float            # target accuracy (paper uses accuracy in place of loss)
    max_rounds: int = 200           # R_m
    local_epochs: int = 5           # τ_m
    batch_size: int = 32
    lr: float = 0.05
