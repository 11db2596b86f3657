"""The paper's CNNs as im2col + batched matmuls over a stacked cohort,
trained by local SGD with autograd, merged by FedAvg, evaluated.

The architecture is the configuration file's ``cnn_spec`` mini-language:
``conv``/``convp`` (k x k SAME, stride 1, ReLU; ``convp`` then a 2 x 2
max-pool), ``gn`` (GroupNorm, min(8, C) groups), ``res`` (two 3 x 3 convs,
a 1 x 1 projection where the shape changes), ``flatten``, ``fc`` (dense +
ReLU), and an implicit classifier. Tensors are NHWC with a leading cohort
axis. SAME padding puts ``pad // 2`` before and the rest after. A pooled
window's gradient is split evenly between tied maxima (``amax``).

Each device's parameters are one slice of a stacked tensor, and the
gradient of the sum of the devices' mean losses is, slice by slice, each
device's own gradient: one autograd pass trains the whole cohort.

``matmul_precision``: ``"float32"`` (the configuration's precision, with
TF32 off) or ``"tf32"`` (the control: the next precision below), which
runs every product on the card with TF32 allowed, and on the CPU rounds
both operands to TF32's 10-bit mantissa first.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import numpy as np
import torch

Params = List[Dict[str, torch.Tensor]]


def init_params(spec: Sequence, input_shape: Sequence[int], num_classes: int,
                seed: int, device) -> Params:
    """He-normal weights drawn with NumPy from ``seed`` (layer by layer,
    weight then nothing for a zero bias), rounded to float32 once."""
    rng = np.random.default_rng(seed)

    def conv(k, cin, cout):
        w = rng.normal(0, np.sqrt(2.0 / (k * k * cin)), (k, k, cin, cout))
        return {"w": torch.tensor(w, dtype=torch.float32, device=device),
                "b": torch.zeros(cout, device=device)}

    def fc(cin, cout):
        w = rng.normal(0, np.sqrt(2.0 / cin), (cin, cout))
        return {"w": torch.tensor(w, dtype=torch.float32, device=device),
                "b": torch.zeros(cout, device=device)}

    params: Params = []
    c, hw = input_shape[-1], input_shape[0]
    for layer in spec:
        kind = layer[0]
        if kind in ("conv", "convp"):
            params.append(conv(layer[2], c, layer[1]))
            c = layer[1]
            hw = hw // 2 if kind == "convp" else hw
        elif kind == "gn":
            params.append({"scale": torch.ones(c, device=device),
                           "bias": torch.zeros(c, device=device)})
        elif kind == "res":
            out_c, stride = layer[1], layer[2]
            blk = {"conv1": conv(3, c, out_c), "conv2": conv(3, out_c, out_c)}
            if stride != 1 or c != out_c:
                blk["proj"] = conv(1, c, out_c)
            params.append(blk)
            c, hw = out_c, hw // stride
        elif kind == "flatten":
            params.append({})
            c = c * hw * hw
        elif kind == "fc":
            params.append(fc(c, layer[1]))
            c = layer[1]
        else:
            raise ValueError(f"unknown layer {kind!r}")
    params.append(fc(c, num_classes))
    return params


def leaves(params) -> List[torch.Tensor]:
    """Every tensor, depth first, keys in sorted order."""
    if isinstance(params, torch.Tensor):
        return [params]
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in leaves(params[k])]
    return [t for p in params for t in leaves(p)]


def leaf_names(params, prefix: str = "") -> List[str]:
    if isinstance(params, torch.Tensor):
        return [prefix]
    if isinstance(params, dict):
        return [n for k in sorted(params)
                for n in leaf_names(params[k], f"{prefix}.{k}")]
    return [n for i, p in enumerate(params)
            for n in leaf_names(p, f"{prefix}{i}")]


def _map(fn, params):
    if isinstance(params, torch.Tensor):
        return fn(params)
    if isinstance(params, dict):
        return {k: _map(fn, params[k]) for k in sorted(params)}
    return [_map(fn, p) for p in params]


def to_device(params, device) -> Params:
    """A copy of a parameter tree (lists and dicts of tensors) on
    ``device``, in float32."""
    return _map(lambda t: t.to(device=device, dtype=torch.float32,
                               copy=True), params)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """Round to nearest (ties away) at TF32's 10 mantissa bits."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32BMM(torch.autograd.Function):
    """A batched product whose operands, forward and backward, are rounded
    to TF32 first: the CPU's stand-in for the card's TF32 products."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(_tf32(a), _tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _tf32(g)
        return (torch.bmm(g, _tf32(b).transpose(1, 2)),
                torch.bmm(_tf32(a).transpose(1, 2), g))


class Net:
    def __init__(self, spec: Sequence, matmul_precision: str = "float32"):
        if matmul_precision not in ("float32", "tf32"):
            raise ValueError(matmul_precision)
        self.spec = [tuple(layer) for layer in spec]
        self.tf32 = matmul_precision == "tf32"

    def _mm(self, a, b):
        if self.tf32 and not a.is_cuda:
            return _TF32BMM.apply(a, b)
        return torch.bmm(a, b)

    @contextlib.contextmanager
    def _precision(self):
        """TF32 allowed on the card for the body (forward and backward)."""
        flags = torch.backends.cuda.matmul
        prev = flags.allow_tf32
        flags.allow_tf32 = self.tf32
        try:
            yield
        finally:
            flags.allow_tf32 = prev

    def _conv(self, x, p, stride=1):
        """x (n, B, H, W, C), w (n, k, k, C, O) -> (n, B, Ho, Wo, O)."""
        w, b = p["w"], p["b"]
        n, bsz, h, wd, c = x.shape
        k = w.shape[1]
        ho, wo = -(-h // stride), -(-wd // stride)
        ph = max((ho - 1) * stride + k - h, 0)
        pw = max((wo - 1) * stride + k - wd, 0)
        xp = torch.nn.functional.pad(
            x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        cols = torch.cat([xp[:, :, i:i + (ho - 1) * stride + 1:stride,
                             j:j + (wo - 1) * stride + 1:stride, :]
                          for i in range(k) for j in range(k)], dim=-1)
        y = self._mm(cols.reshape(n, bsz * ho * wo, k * k * c),
                     w.reshape(n, k * k * c, -1))
        return y.reshape(n, bsz, ho, wo, -1) + b[:, None, None, None, :]

    @staticmethod
    def _pool(x):
        n, bsz, h, w, c = x.shape
        x = x[:, :, : h // 2 * 2, : w // 2 * 2, :]
        return x.reshape(n, bsz, h // 2, 2, w // 2, 2, c).amax(dim=(3, 5))

    @staticmethod
    def _groupnorm(x, p):
        n, bsz, h, w, c = x.shape
        g = min(8, c)
        xg = x.reshape(n, bsz, h, w, g, c // g)
        mu = xg.mean(dim=(2, 3, 5), keepdim=True)
        var = xg.var(dim=(2, 3, 5), keepdim=True, correction=0)
        xg = (xg - mu) * torch.rsqrt(var + 1e-5)
        shape = (n, 1, 1, 1, c)
        return (xg.reshape(n, bsz, h, w, c) * p["scale"].reshape(shape)
                + p["bias"].reshape(shape))

    def _dense(self, x, p):
        return self._mm(x, p["w"]) + p["b"][:, None, :]

    def logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Stacked params (n, ...) and inputs (n, B, H, W, C) -> (n, B, C)."""
        for layer, p in zip(self.spec, params):
            kind = layer[0]
            if kind == "conv":
                x = torch.relu(self._conv(x, p))
            elif kind == "convp":
                x = self._pool(torch.relu(self._conv(x, p)))
            elif kind == "gn":
                x = self._groupnorm(x, p)
            elif kind == "res":
                h = torch.relu(self._conv(x, p["conv1"], layer[2]))
                h = self._conv(h, p["conv2"])
                sc = self._conv(x, p["proj"], layer[2]) if "proj" in p else x
                x = torch.relu(h + sc)
            elif kind == "flatten":
                x = x.reshape(x.shape[0], x.shape[1], -1)
            elif kind == "fc":
                x = torch.relu(self._dense(x, p))
        return self._dense(x, params[-1])

    @staticmethod
    def losses(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """(n,) mean cross-entropy of each device's batch."""
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, 2, y[..., None].long())[..., 0].mean(dim=1)

    def local_sgd(self, params: Params, x: torch.Tensor, y: torch.Tensor,
                  epochs: int, batch_size: int, lr: float) -> Params:
        """Global params (unstacked), the cohort's shards x (n, W, ...) and
        y (n, W) -> each device's params after ``epochs`` passes over its
        full batches, stacked on a leading (n,) axis."""
        n, width = x.shape[0], x.shape[1]
        batch = min(batch_size, width)
        steps = max(width // batch, 1)
        xb = x[:, : steps * batch].reshape(n, steps, batch, *x.shape[2:])
        yb = y[:, : steps * batch].reshape(n, steps, batch)
        p = _map(lambda t: t.expand(n, *t.shape).clone(), params)
        with self._precision():
            p = self._sgd(p, xb, yb, steps, epochs, lr)
        return _map(lambda t: t.detach(), p)

    def _sgd(self, p, xb, yb, steps, epochs, lr):
        for _ in range(epochs):
            for s in range(steps):
                flat = leaves(p)
                for t in flat:
                    t.requires_grad_(True)
                loss = self.losses(self.logits(p, xb[:, s]), yb[:, s]).sum()
                grads = torch.autograd.grad(loss, flat)
                with torch.no_grad():
                    new = iter([t - lr * g for t, g in zip(flat, grads)])
                    p = _map(lambda _t: next(new), p)
        return p

    def evaluate(self, params: Params, x: torch.Tensor, y: torch.Tensor):
        """(loss, accuracy) of unstacked params on (E, ...) inputs."""
        with torch.no_grad(), self._precision():
            one = _map(lambda t: t[None], params)
            logits = self.logits(one, x[None])[0]
            logp = torch.log_softmax(logits, dim=-1)
            loss = -torch.gather(logp, 1, y[:, None].long()).mean()
            acc = (logits.argmax(-1) == y).float().mean()
        return float(loss), float(acc)


def fedavg(stacked: Params, sizes: torch.Tensor) -> Params:
    """Size-weighted mean over the leading cohort axis."""
    w = sizes / sizes.sum()
    return _map(lambda t: (t * w.reshape((-1,) + (1,) * (t.dim() - 1))
                           ).sum(dim=0), stacked)
