"""Synthetic datasets with real learnable structure.

``make_classification_dataset`` builds class-prototype image data: each class
c has a fixed random prototype P_c; a sample is x = P_c + sigma * noise with
label c. Models must learn the prototypes -> accuracy is a real function of
training, capacity, and (critically for the paper) WHICH devices' label
shards participated — the property the fairness term exploits.

``make_lm_tokens`` builds an order-2 Markov token stream with a Zipfian
marginal so LM training steps have non-trivial learnable signal.

Pure numpy, making the reference's calls in the reference's order, so the
port's copy gives the reference's arrays bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_classification_dataset(
    num_samples: int,
    input_shape: Tuple[int, ...],
    num_classes: int,
    noise: float = 1.0,
    seed: int = 0,
    proto_seed: int = 1234,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (x: (N, *input_shape) float32, y: (N,) int32).

    ``proto_seed`` fixes the class prototypes INDEPENDENTLY of the sampling
    seed, so train and eval splits drawn with different ``seed`` values share
    the same underlying task.
    """
    rng_p = np.random.default_rng(proto_seed)
    protos = rng_p.normal(0.0, 1.0, size=(num_classes, *input_shape)).astype(np.float32)
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=num_samples).astype(np.int32)
    x = protos[y] + noise * rng.normal(0.0, 1.0, size=(num_samples, *input_shape)).astype(np.float32)
    return x.astype(np.float32), y


def make_lm_tokens(num_tokens: int, vocab_size: int, seed: int = 0,
                   zipf_a: float = 1.2) -> np.ndarray:
    """Order-2 Markov chain over a Zipfian vocabulary. (num_tokens,) int32."""
    rng = np.random.default_rng(seed)
    # Sparse transition structure: each (prev token bucket) prefers 8
    # successors.
    buckets = 256
    succ = rng.integers(0, vocab_size, size=(buckets, 8))
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    zipf_p = ranks ** (-zipf_a)
    zipf_p /= zipf_p.sum()
    out = np.empty(num_tokens, dtype=np.int32)
    tok = int(rng.integers(0, vocab_size))
    for i in range(num_tokens):
        if rng.random() < 0.7:
            tok = int(succ[tok % buckets, rng.integers(0, 8)])
        else:
            tok = int(rng.choice(vocab_size, p=zipf_p))
        out[i] = tok
    return out
