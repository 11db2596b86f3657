"""Architecture configs of the port: the paper's FL model zoo.

Importing this package registers every ported arch with the registry, so
``repro_torch.config.registry.get_arch("<id>")`` resolves it. The
reference's language-model configs are ROADMAP module 10.
"""

from repro_torch.configs import paper_models  # noqa: F401
