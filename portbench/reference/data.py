"""Synthetic class-prototype data and the paper's non-IID split (§5).

Frozen copies: the same NumPy calls in the same order as the program's
generator and partitioner, so the same seeds give the same arrays.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

PROTO_SEED = 1234


def labels(num_samples: int, num_classes: int, seed: int) -> np.ndarray:
    """The labels alone (the generator draws them first)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, num_classes, size=num_samples).astype(np.int32)


def dataset(num_samples: int, input_shape: Sequence[int], num_classes: int,
            noise: float, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """x = prototype of the label + noise * N(0, 1); (N, *shape) float32."""
    rng_p = np.random.default_rng(PROTO_SEED)
    protos = rng_p.normal(0.0, 1.0, size=(num_classes, *input_shape)).astype(
        np.float32)
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=num_samples).astype(np.int32)
    x = protos[y] + noise * rng.normal(
        0.0, 1.0, size=(num_samples, *input_shape)).astype(np.float32)
    return x.astype(np.float32), y


def noniid_partition(y: np.ndarray, num_devices: int, classes_per_device: int,
                     parts_per_class: int, seed: int) -> np.ndarray:
    """Each class in ``parts_per_class`` parts; a device takes one part of
    each of ``classes_per_device`` classes. (K, W) int64 indices."""
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    parts = {}
    min_part = np.inf
    for c in classes:
        idx = rng.permutation(np.flatnonzero(y == c))
        chunks = np.array_split(idx, parts_per_class)
        parts[c] = chunks
        min_part = min(min_part, min(len(ch) for ch in chunks))
    width = int(min_part) * classes_per_device
    if width == 0:
        raise ValueError("a class has fewer samples than parts_per_class")
    out = np.zeros((num_devices, width), dtype=np.int64)
    for k in range(num_devices):
        cs = rng.choice(classes, size=classes_per_device, replace=False)
        sel = np.concatenate([parts[c][rng.integers(0, parts_per_class)]
                              [: width // classes_per_device] for c in cs])
        if len(sel) < width:
            sel = np.concatenate([sel, rng.choice(sel, width - len(sel))])
        out[k] = sel
    return out


def partition_width(y: np.ndarray, classes_per_device: int,
                    parts_per_class: int) -> int:
    """The width ``noniid_partition`` gives, from the label counts alone."""
    counts = np.bincount(y)
    counts = counts[counts > 0]
    return int(counts.min() // parts_per_class) * classes_per_device


def split_batches(width: int, batch_size: int) -> Tuple[int, int]:
    """(steps, batch) of one device's shard of ``width`` samples: a shard
    smaller than the batch is one batch; the ragged tail is dropped."""
    batch = min(batch_size, width)
    return max(width // batch, 1), batch
