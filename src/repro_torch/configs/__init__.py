"""Architecture configs of the port: the paper's FL model zoo and the
dense, MoE, hybrid, SSM, audio and VLM language models, and the port's
own Trinity-Mini (``trinity_mini.py``), which the JAX package lacks and
``ASSIGNED_ARCHS`` leaves out.

Importing this package registers every arch with the registry, so
``repro_torch.config.get_arch("<id>")`` resolves it, as in the reference.
"""

from repro_torch.configs import (  # noqa: F401
    dbrx_132b,
    deepseek_67b,
    glm4_9b,
    hymba_1p5b,
    kimi_k2_1t_a32b,
    musicgen_medium,
    paligemma_3b,
    paper_models,
    qwen3_1p7b,
    qwen3_8b,
    trinity_mini,
    xlstm_350m,
)

ASSIGNED_ARCHS = (
    "qwen3-1.7b",
    "qwen3-8b",
    "deepseek-67b",
    "glm4-9b",
    "musicgen-medium",
    "dbrx-132b",
    "kimi-k2-1t-a32b",
    "hymba-1.5b",
    "xlstm-350m",
    "paligemma-3b",
)
