"""Architecture configs of the port: the paper's FL model zoo and the
dense language models.

Importing this package registers every ported arch with the registry, so
``repro_torch.config.registry.get_arch("<id>")`` resolves it. The
reference's other language-model families (MoE, hybrid, SSM, audio, VLM)
are ROADMAP module 10.
"""

from repro_torch.configs import (  # noqa: F401
    deepseek_67b,
    glm4_9b,
    paper_models,
    qwen3_1p7b,
    qwen3_8b,
)
