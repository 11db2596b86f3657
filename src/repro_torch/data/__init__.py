"""Synthetic datasets (``synthetic``) and restartable batching
(``pipeline``) of the port: numpy only, the reference's draws."""

from repro_torch.data.pipeline import Batcher, host_local_batches
from repro_torch.data.synthetic import (make_classification_dataset,
                                        make_lm_tokens)

__all__ = ["make_classification_dataset", "make_lm_tokens", "Batcher",
           "host_local_batches"]
