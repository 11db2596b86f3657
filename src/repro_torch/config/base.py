"""Typed configuration dataclasses: the part the ported paths use.

``ArchFamily``, ``AttentionKind``, ``ModelConfig``, ``ShapeConfig`` and
``JobConfig``, as the engine, the experiment spec, the CNN zoo
(``models/cnn_zoo.py``) and the LLM zoo (``models/transformer.py``) use
them; ``OptimizerConfig``, ``TrainConfig`` and ``FLConfig``, the
reference's, as the LM train path (``launch/steps.py``,
``launch/train.py``) uses them. ``ModelConfig`` carries every field of the reference's, so each
architecture family's ``param_count`` is the reference's arithmetic; the
LLM zoo itself runs the dense, MoE, hybrid and SSM families (audio and
VLM are ROADMAP module 10).
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


class AttentionKind(str, enum.Enum):
    FULL = "full"          # full causal attention (quadratic)
    SLIDING = "sliding"    # sliding-window attention (sub-quadratic)
    NONE = "none"          # attention-free (pure SSM/recurrent)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (decoder-only LM backbone unless
    family=CNN)."""

    name: str
    family: ArchFamily = ArchFamily.DENSE

    # Transformer backbone.
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0  # 0 -> d_model // num_heads
    qk_norm: bool = False
    mlp_kind: str = "swiglu"  # swiglu | geglu | gelu
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # Attention behaviour.
    attention: AttentionKind = AttentionKind.FULL
    sliding_window: int = 4096  # used when attention == SLIDING

    # MoE.
    num_experts: int = 0
    experts_per_token: int = 0
    moe_dense_first_n: int = 0   # leading dense layers before MoE blocks
    num_shared_experts: int = 0

    # SSM / recurrent.
    ssm_state: int = 0           # per-head SSM state width
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    slstm_every: int = 0         # xLSTM: every n-th block is sLSTM (0 = none)

    # Hybrid (parallel attention + SSM heads, Hymba-style).
    hybrid_parallel: bool = False

    # Modality frontend stubs (precomputed embeddings).
    frontend_tokens: int = 0
    frontend_dim: int = 0

    # CNN-family (paper plane) description: sequence of layer specs.
    cnn_spec: Tuple = ()
    input_shape: Tuple[int, ...] = ()
    num_classes: int = 0

    # Numerics / memory policy.
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"     # parameter storage dtype
    remat: bool = True               # checkpoint at block boundaries

    def __post_init__(self):
        if self.family != ArchFamily.CNN:
            if self.d_model <= 0 or self.num_layers <= 0:
                raise ValueError(f"{self.name}: a language model needs "
                                 "d_model > 0 and num_layers > 0")
            if self.num_heads:
                hd = self.head_dim or self.d_model // self.num_heads
                object.__setattr__(self, "head_dim", hd)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def param_count(self) -> int:
        if self.family == ArchFamily.CNN:
            return _cnn_param_count(self)
        d, h, kv, hd, f = (self.d_model, self.num_heads, self.num_kv_heads,
                           self.head_dim, self.d_ff)
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d  # q, k+v, o
        if self.qk_norm:
            attn += 2 * hd
        per_layer = attn + 2 * d  # two norms
        if self.is_moe:
            moe_layers = self.num_layers - self.moe_dense_first_n
            dense_layers = self.moe_dense_first_n
            expert_ff = 3 * d * f  # gate/up/down (SwiGLU)
            per_moe = (attn + 2 * d + self.num_experts * expert_ff
                       + d * self.num_experts)
            per_moe += self.num_shared_experts * expert_ff
            dense_f = f if dense_layers else 0
            per_dense = attn + 2 * d + 3 * d * (dense_f or f)
            body = moe_layers * per_moe + dense_layers * per_dense
        elif self.family == ArchFamily.SSM:
            inner = self.ssm_expand * d
            per_layer = 2 * d + 3 * d * inner + inner * d + 4 * inner
            body = self.num_layers * per_layer
        elif self.family == ArchFamily.HYBRID:
            inner = self.ssm_expand * d
            ssm = 2 * d * inner + inner * (self.ssm_state * 2 + 1) + inner * d
            per_layer = attn + ssm + 2 * d + 3 * d * f
            body = self.num_layers * per_layer
        else:
            mlp_mats = 2 if self.mlp_kind == "gelu" else 3
            per_layer += mlp_mats * d * f
            body = self.num_layers * per_layer
        emb = self.vocab_size * d
        out = 0 if self.tie_embeddings else self.vocab_size * d
        return body + emb + out + d  # final norm


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
class ShapeConfig:
    """An input-shape cell: (seq_len, global_batch, mode)."""

    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # sgd | momentum | adam | adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9
    grad_clip: float = 1.0
    # Gradient compression (FL / cross-pod): 0 disables.
    topk_compress_ratio: float = 0.0
    error_feedback: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    microbatches: int = 1            # gradient accumulation steps
    remat_policy: str = "block"      # none | block | full
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """Federated plane configuration (the paper's experimental setting)."""

    num_devices: int = 100
    devices_per_round_ratio: float = 0.1   # C_m: the paper samples 10%
    local_epochs: int = 5                  # tau_m
    batch_size: int = 32
    # Cost weights (Formula 2), set empirically in the paper ("increase
    # alpha for fast convergence, increase beta for high accuracy").
    alpha: float = 4.0                     # time-cost weight
    beta: float = 0.25                     # fairness-cost weight
    non_iid: bool = True
    classes_per_device: int = 2            # the paper's non-IID split
    parts_per_class: int = 20
    seed: int = 0


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
