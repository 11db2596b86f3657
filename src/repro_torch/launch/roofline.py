"""Roofline terms of a dry-run record (``repro/launch/roofline.py``), at an
NVIDIA H100 SXM's peaks.

Three terms per (arch x shape x mesh), in seconds, each a per-device
quantity over a per-device rate (the chips cancel: the record's counts
are already per device):

    compute_s    = flops_total / PEAK_FLOPS
    memory_s     = bytes_total / HBM_BW
    collective_s = collective_bytes / LINK_BW

``MODEL_FLOPS = 6 N D`` for a train step (2 N D otherwise), N the active
params and D the tokens, checks the counted FLOPs: a remat'd train step
runs forward, forward again and backward, about 8 N D, so its
``useful_flops_ratio`` sits near 0.75.

Peaks (NVIDIA H100 SXM5 data sheet; dense, no sparsity):
- ``PEAK_FLOPS`` 989e12: bf16 tensor-core FLOP/s.
- ``HBM_BW`` 3.35e12: HBM3 bytes/s.
- Links, by mesh axis: the (16, 16) mesh is 32 hosts of 8 cards. Inside a
  host NVLink 4 (900 GB/s a card both ways) gives ``NVLINK_BW`` 450e9
  bytes/s each way; across hosts one 400 Gb/s InfiniBand NIC a card gives
  ``IB_BW`` 50e9 bytes/s. The 16-way "model" axis spans two hosts and
  "data" and "pod" cross hosts, so every collective of the production
  meshes crosses InfiniBand: ``LINK_BW`` is ``IB_BW``. Only a "model"
  group held inside one host (8 cards or fewer) would run at
  ``NVLINK_BW``.

There is no HLO to parse. ``CollectiveTally`` is a ``TorchDispatchMode``
that sums the shard-local result bytes of every functional collective
(``_c10d_functional`` all-gather, all-reduce, reduce-scatter, all-to-all
and permute) it sees, times the traffic factor each puts on a link (the
reference's ``_TRAFFIC_FACTOR``), by kind; DTensor's redistributions
issue exactly these ops, and the tally sees them as DTensor lowers each
op to its local tensors.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12        # H100 SXM bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12           # H100 SXM HBM3 bytes/s
NVLINK_BW = 450e9          # NVLink 4 bytes/s each way, inside an 8-card host
IB_BW = 50e9               # 400 Gb/s InfiniBand a card, across hosts
LINK_BW = IB_BW            # the production meshes' axes all cross hosts

# Traffic each op puts on one link, as a multiple of its shard-local
# result bytes (ring algorithms, n = group size, large n):
#   all-gather: receives (n-1)/n of the FULL result   ~= 1x the result
#   all-reduce: 2(n-1)/n of the payload              ~= 2x
#   reduce-scatter: (n-1)/n of the payload           ~= 1x
#   all-to-all: (n-1)/n of the payload               ~= 1x
#   collective-permute: 1x
_TRAFFIC_FACTOR = {
    "all-gather": 1.0,
    "all-reduce": 2.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# _c10d_functional op names -> the reference's collective kinds
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "permute_tensor": "collective-permute",
    "send": "collective-permute",
}


def tensor_bytes(tree) -> int:
    """Bytes of the tensors in ``tree`` (a tensor, or lists and tuples of
    them and other values)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(t) for t in tree)
    return 0


def collective_kind(func) -> str:
    """The reference's kind of a ``_c10d_functional`` op, or ''."""
    if getattr(func, "namespace", None) not in ("_c10d_functional",
                                                "c10d_functional"):
        return ""
    return _KINDS.get(func._overloadpacket.__name__, "")


class CollectiveTally(TorchDispatchMode):
    """Link bytes by collective kind (``bytes``), op counts (``counts``)
    and their sum (``total``) of the functional collectives run inside the
    context. An op on DTensors is left to DTensor (``NotImplemented``), so
    the tally sees the local ops, collectives included, it lowers to."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, float] = dict.fromkeys(_TRAFFIC_FACTOR, 0.0)
        self.counts: Dict[str, int] = dict.fromkeys(_TRAFFIC_FACTOR, 0)

    @property
    def total(self) -> float:
        return sum(self.bytes.values())

    def _seen(self, func, types, args, kwargs, out) -> None:
        kind = collective_kind(func)
        if kind:
            self.bytes[kind] += tensor_bytes(out) * _TRAFFIC_FACTOR[kind]
            self.counts[kind] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        self._seen(func, types, args, kwargs, out)
        return out

    def as_dict(self) -> Dict:
        return dict(self.bytes, total=self.total, counts=dict(self.counts))


def roofline_terms(rec: Dict) -> Dict:
    """rec: a dry-run record; ``flops_total``, ``bytes_total`` and
    ``collective_bytes["total"]`` are per-device quantities."""
    chips = rec["num_devices"]
    compute_s = rec["flops_total"] / PEAK_FLOPS
    memory_s = rec["bytes_total"] / HBM_BW
    collective_s = rec["collective_bytes"]["total"] / LINK_BW

    n = rec["active_params"]
    d = rec["tokens"]
    factor = 6.0 if rec["mode"] == "train" else 2.0
    model_flops = factor * n * d              # cluster-total useful FLOPs
    model_flops_pd = model_flops / chips      # per-device share
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "model_flops": model_flops,
        "hlo_flops_per_device": rec["flops_total"],
        "useful_flops_ratio": (model_flops_pd / rec["flops_total"]
                               if rec["flops_total"] else 0.0),
    }
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    terms["dominant"] = dom.replace("_s", "")
    bound = max(compute_s, memory_s, collective_s)
    ideal_s = model_flops_pd / PEAK_FLOPS
    terms["roofline_fraction"] = ideal_s / bound if bound > 0 else 0.0
    return terms
