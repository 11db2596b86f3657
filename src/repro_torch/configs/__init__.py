"""Architecture configs of the port: the paper's FL model zoo and the
dense, MoE, hybrid and SSM language models.

Importing this package registers every ported arch with the registry, so
``repro_torch.config.registry.get_arch("<id>")`` resolves it. The
reference's audio and VLM language models are ROADMAP module 10.
"""

from repro_torch.configs import (  # noqa: F401
    dbrx_132b,
    deepseek_67b,
    glm4_9b,
    hymba_1p5b,
    kimi_k2_1t_a32b,
    paper_models,
    qwen3_1p7b,
    qwen3_8b,
    xlstm_350m,
)
