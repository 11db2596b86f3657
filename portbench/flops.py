"""Matmul operations of the paper's CNNs, counted from their layer shapes.

A convolution is an im2col product: Ho Wo k^2 Cin Cout multiply-adds a
sample (SAME padding, so the padded zeros are multiplied too); a dense
layer Cin Cout. A training sample costs its forward products, the weight
gradients (as many) and the input gradients (as many, except the first
layer's: the data needs none). Elementwise work (ReLU, pooling, GroupNorm,
softmax, the SGD update, FedAvg) is not counted.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def layer_macs(spec: Sequence, input_shape: Sequence[int], num_classes: int
               ) -> List[Tuple[str, int]]:
    """(layer, multiply-adds a sample) for every product, in order."""
    out: List[Tuple[str, int]] = []
    hw, c = input_shape[0], input_shape[-1]
    for i, layer in enumerate(spec):
        kind = layer[0]
        if kind in ("conv", "convp"):
            out_c, k = layer[1], layer[2]
            out.append((f"{i}.{kind}", hw * hw * k * k * c * out_c))
            c = out_c
            if kind == "convp":
                hw //= 2
        elif kind == "res":
            out_c, stride = layer[1], layer[2]
            ho = -(-hw // stride)
            out.append((f"{i}.conv1", ho * ho * 9 * c * out_c))
            out.append((f"{i}.conv2", ho * ho * 9 * out_c * out_c))
            if stride != 1 or c != out_c:
                out.append((f"{i}.proj", ho * ho * c * out_c))
            c, hw = out_c, ho
        elif kind == "flatten":
            c = c * hw * hw
        elif kind == "fc":
            out.append((f"{i}.fc", c * layer[1]))
            c = layer[1]
    out.append(("head", c * num_classes))
    return out


def forward_flops(spec, input_shape, num_classes) -> int:
    """FLOPs (2 per multiply-add) of one sample's forward pass."""
    return 2 * sum(m for _, m in layer_macs(spec, input_shape, num_classes))


def train_flops(spec, input_shape, num_classes) -> int:
    """FLOPs of one sample's forward and backward products."""
    macs = [m for _, m in layer_macs(spec, input_shape, num_classes)]
    return 2 * (3 * sum(macs) - macs[0])
