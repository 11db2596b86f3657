"""Data partitioners — exactly the paper's §5 setups.

IID: each device uniformly samples a fixed number of examples.
Non-IID: "the training set is classified by category, and the samples of each
category are divided into 20 parts. Each device randomly selects two
categories and then selects one part from each category."

Both return an (num_devices, samples_per_device) int index matrix into the
global arrays — fixed width so device datasets stack/vmap with static shapes.
Pure numpy: the port's copy gives the reference's partitions bit for bit.
"""

from __future__ import annotations

import numpy as np


def iid_partition(labels: np.ndarray, num_devices: int, samples_per_device: int,
                  seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = len(labels)
    return rng.integers(0, n, size=(num_devices, samples_per_device)).astype(np.int64)


def noniid_partition(labels: np.ndarray, num_devices: int,
                     classes_per_device: int = 2, parts_per_class: int = 20,
                     seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    # Split each class into `parts_per_class` equal parts.
    parts = {}
    min_part = np.inf
    for c in classes:
        idx = rng.permutation(np.flatnonzero(labels == c))
        chunks = np.array_split(idx, parts_per_class)
        parts[c] = chunks
        min_part = min(min_part, min(len(ch) for ch in chunks))
    width = int(min_part) * classes_per_device
    if width == 0:
        # Some class split into `parts_per_class` chunks came out empty —
        # every device shard would be width 0 (a zero-row gather the local
        # train step can only skip). Fail early with the actual sizing math
        # instead of a downstream ZeroDivisionError.
        counts = {int(c): int(np.count_nonzero(labels == c)) for c in classes}
        starved = min(counts, key=counts.get)
        raise ValueError(
            f"noniid_partition: {len(labels)} samples over {len(classes)} "
            f"classes split {parts_per_class} ways leaves class {starved} "
            f"(n={counts[starved]}) with empty parts (width 0). Provide "
            f">= {parts_per_class} samples per class or lower "
            f"parts_per_class.")
    out = np.zeros((num_devices, width), dtype=np.int64)
    for k in range(num_devices):
        cs = rng.choice(classes, size=classes_per_device, replace=False)
        chosen = []
        for c in cs:
            part = parts[c][rng.integers(0, parts_per_class)]
            chosen.append(part[: width // classes_per_device])
        sel = np.concatenate(chosen)
        if len(sel) < width:  # pad by resampling (rare ragged tail)
            sel = np.concatenate([sel, rng.choice(sel, width - len(sel))])
        out[k] = sel
    return out


def device_label_histogram(labels: np.ndarray, partition: np.ndarray,
                           num_classes: int) -> np.ndarray:
    """(num_devices, num_classes) label counts — used in tests/fairness analysis."""
    K = partition.shape[0]
    out = np.zeros((K, num_classes), dtype=np.int64)
    for k in range(K):
        binc = np.bincount(labels[partition[k]], minlength=num_classes)
        out[k] = binc[:num_classes]
    return out
