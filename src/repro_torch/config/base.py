"""Typed configuration dataclasses: the part the scheduling loop uses.

``ArchFamily``, ``ModelConfig`` and ``JobConfig`` as the engine and the
experiment spec use them. The port carries no model zoo yet (ROADMAP
modules 6 and 10), so ``ModelConfig`` keeps only the fields that name a job
and describe the scheduler-plane ``stub`` classifier; the reference's
parameter counting, attention, MoE, SSM and numerics fields arrive with
the models.
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
    """The model a job trains, as far as the scheduling loop needs it."""

    name: str
    family: ArchFamily = ArchFamily.DENSE
    # CNN-family (paper plane) description: sequence of layer specs.
    cnn_spec: Tuple = ()
    input_shape: Tuple[int, ...] = ()
    num_classes: int = 0


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
