"""Optimizers (``optimizers``), learning-rate schedules (``schedule``) and
gradient compression (``compression``) of the port, under the reference's
names (``repro/optim/__init__.py``)."""

from repro_torch.optim.compression import (ErrorFeedbackState, topk_compress,
                                           topk_decompress)
from repro_torch.optim.optimizers import (OptState, adafactor, adam, adamw,
                                          clip_by_global_norm, make_optimizer,
                                          momentum, sgd)
from repro_torch.optim.schedule import cosine_schedule, warmup_cosine

__all__ = ["OptState", "adafactor", "adam", "adamw", "clip_by_global_norm",
           "make_optimizer", "momentum", "sgd", "topk_compress",
           "topk_decompress", "ErrorFeedbackState", "cosine_schedule",
           "warmup_cosine"]
