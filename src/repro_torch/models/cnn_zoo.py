"""The paper's CNN model zoo in PyTorch (NHWC at every public function).

Built from the ``cnn_spec`` mini-language in ``configs/paper_models.py``.
Params are a list of per-layer dicts of tensors, as in the reference, so
``torch.func.vmap``/``grad`` treat them as a pytree and FedAvg is a
weighted mean over a stacked leading axis.

The math is the reference's default ``gemm`` lowering
(``repro/models/cnn_zoo.py``), restated:

- Convolution is im2col plus ``torch.matmul`` with the reference's SAME
  padding: ``pad // 2`` before and the rest after, which is asymmetric at
  stride 2 and at CNN-B's even 2x2 kernels. The padding is explicit
  (``F.pad``): ``F.conv2d(padding="same")`` refuses stride > 1 and pads
  another way. A float32 ``torch.matmul`` runs in full float32 under
  PyTorch's defaults (``torch.backends.cuda.matmul.allow_tf32`` False),
  where a cuDNN convolution would run in TF32.
- Max-pool is reshape-max (``amax`` over the two window axes), whose
  gradient splits a tied window evenly as JAX's does; ``F.max_pool2d``
  would send it all to one element, and ties are common after ReLU.
- GroupNorm uses ``min(8, c)`` contiguous channel groups, the population
  variance and ``rsqrt(var + 1e-5)``.

The reference's ``lax`` lowering (its historical baseline) is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(device)


def _conv_init(rng, k, c_in, c_out, device):
    fan_in = k * k * c_in
    w = rng.normal(0, np.sqrt(2.0 / fan_in), (k, k, c_in, c_out))
    return {"w": _tensor(w, device),
            "b": torch.zeros((c_out,), dtype=torch.float32, device=device)}


def _fc_init(rng, c_in, c_out, device):
    w = rng.normal(0, np.sqrt(2.0 / c_in), (c_in, c_out))
    return {"w": _tensor(w, device),
            "b": torch.zeros((c_out,), dtype=torch.float32, device=device)}


def cnn_init(cfg: ModelConfig, seed: int = 0,
             device="cpu") -> List[Dict]:
    """The reference's initial params bit for bit (the same numpy draws,
    rounded to float32 once), as tensors on ``device``."""
    rng = np.random.default_rng(seed)
    params: List[Dict] = []
    c = cfg.input_shape[-1]
    spatial = cfg.input_shape[0]
    for layer in cfg.cnn_spec:
        kind = layer[0]
        if kind in ("conv", "convp"):
            _, out_c, k = layer
            params.append(_conv_init(rng, k, c, out_c, device))
            c = out_c
            if kind == "convp":
                spatial //= 2
        elif kind == "gn":
            params.append({
                "scale": torch.ones((c,), dtype=torch.float32, device=device),
                "bias": torch.zeros((c,), dtype=torch.float32, device=device)})
        elif kind == "res":
            _, out_c, stride = layer
            blk = {
                "conv1": _conv_init(rng, 3, c, out_c, device),
                "conv2": _conv_init(rng, 3, out_c, out_c, device),
            }
            if stride != 1 or c != out_c:
                blk["proj"] = _conv_init(rng, 1, c, out_c, device)
            params.append(blk)
            c = out_c
            spatial //= stride
        elif kind == "flatten":
            params.append({})
            c = c * spatial * spatial
        elif kind == "fc":
            _, width = layer
            params.append(_fc_init(rng, c, width, device))
            c = width
        else:
            raise ValueError(kind)
    params.append(_fc_init(rng, c, cfg.num_classes, device))  # classifier head
    return params


def _conv(x, p, stride=1):
    """SAME conv as im2col + GEMM, NHWC in and out, HWIO weights."""
    w = p["w"]
    k = w.shape[0]
    n, h, wd, c = x.shape
    ho = -(-h // stride)
    wo = -(-wd // stride)
    pad_h = max((ho - 1) * stride + k - h, 0)
    pad_w = max((wo - 1) * stride + k - wd, 0)
    # F.pad lists the last axis first: C, then W, then H.
    xp = F.pad(x, (0, 0, pad_w // 2, pad_w - pad_w // 2,
                   pad_h // 2, pad_h - pad_h // 2))
    cols = [xp[:, i:i + (ho - 1) * stride + 1:stride,
               j:j + (wo - 1) * stride + 1:stride, :]
            for i in range(k) for j in range(k)]
    patches = torch.cat(cols, dim=-1)                  # (N, Ho, Wo, k*k*C)
    y = patches.reshape(n * ho * wo, k * k * c) @ w.reshape(k * k * c, -1)
    return y.reshape(n, ho, wo, -1) + p["b"]


def _maxpool2(x):
    """2x2/2 VALID max-pool (ragged edge dropped); ties share the gradient."""
    n, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2, :]
    x = x.reshape(n, h // 2, 2, w // 2, 2, c)
    return x.amax(dim=(2, 4))


def _groupnorm(x, p, groups=8):
    n, h, w, c = x.shape
    g = min(groups, c)
    xg = x.reshape(n, h, w, g, c // g)
    mu = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = xg.var(dim=(1, 2, 4), keepdim=True, correction=0)
    xg = (xg - mu) * torch.rsqrt(var + 1e-5)
    return xg.reshape(n, h, w, c) * p["scale"] + p["bias"]


def cnn_apply(params: List[Dict], cfg: ModelConfig,
              x: torch.Tensor) -> torch.Tensor:
    """x: (N, H, W, C) -> logits (N, num_classes)."""
    for layer, p in zip(cfg.cnn_spec, params):
        kind = layer[0]
        if kind == "conv":
            x = torch.relu(_conv(x, p))
        elif kind == "convp":
            x = _maxpool2(torch.relu(_conv(x, p)))
        elif kind == "gn":
            x = _groupnorm(x, p)
        elif kind == "res":
            _, out_c, stride = layer
            h = torch.relu(_conv(x, p["conv1"], stride))
            h = _conv(h, p["conv2"])
            sc = _conv(x, p["proj"], stride) if "proj" in p else x
            x = torch.relu(h + sc)
        elif kind == "flatten":
            x = x.reshape(x.shape[0], -1)
        elif kind == "fc":
            x = torch.relu(x @ p["w"] + p["b"])
    head = params[-1]
    return x @ head["w"] + head["b"]


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of the labels ``y`` (int)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, y[:, None].long()).mean()


def cnn_loss_and_accuracy(params, cfg: ModelConfig, x, y
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    logits = cnn_apply(params, cfg, x)
    loss = cross_entropy(logits, y)
    acc = (logits.argmax(-1) == y).float().mean()
    return loss, acc
