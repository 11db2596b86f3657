"""Federated substrate of the port: the synthetic runtime (``runtime``)."""

from repro_torch.fl.runtime import DEFAULT_B0, SyntheticRuntime

__all__ = ["DEFAULT_B0", "SyntheticRuntime"]
