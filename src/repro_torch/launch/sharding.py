"""Logical-axis sharding with divisibility-aware resolution
(``repro/launch/sharding.py``), on torch's ``DeviceMesh`` and DTensor.

Models name each tensor dim by a LOGICAL axis ("embed", "mlp", "heads",
"experts", "batch", ...). A rule table maps logical axes to mesh axes;
``resolve_spec`` drops a mapping whose mesh-axis size does not divide the
dim (paligemma's one kv-head, musicgen's 24 heads, hymba's 32001 vocab),
tries shorter prefixes of a multi-axis mapping, uses each mesh axis at
most once per tensor, and lets ``act_heads`` shard unevenly. A spec is a
tuple with one entry per dim: a mesh-axis name, a tuple of names, or
``None``, the counterpart of the reference's ``PartitionSpec``.

Torch has no ambient mesh, so ``use_mesh(mesh)`` installs one,
thread-local as the rules are (``active_mesh``). A mesh is a torch
``DeviceMesh`` or anything with axis names and a shape: a ``MeshConfig``,
or the reference tests' ``FakeMesh``.

``shard(x, *axes)`` is the counterpart of ``with_sharding_constraint``:
it returns a plain tensor (or any tensor with no mesh installed)
unchanged, so single-device paths run bit for bit as before, and
redistributes a DTensor to the resolved placements (``placements``: a dim
over two mesh axes is a ``Shard`` on each of them). ``distribute_tree``
lays out a tree of tensors as DTensors, the counterpart of ``jit``'s
``in_shardings``; ``meta`` leaves become ``meta`` DTensors with their
local shard shapes, so the dry run (``launch/dryrun.py``) holds nothing.

``split_dim`` reshapes one dim into several and ``merge_dims`` several
into one. DTensor refuses to split a dim whose shards do not hold whole
rows of the new leading dim (a GQA projection of 8 kv-heads over a 16-way
model axis), or to merge dims whose first is split unevenly (25 heads
over 16 shards), where XLA's partitioner would reshard; these two first
gather that dim over the offending mesh axes. On a plain tensor each is
``reshape``.
"""

from __future__ import annotations

import contextlib
import math
import sys
import threading
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

# Default rule table: single-pod ("data", "model") and multi-pod
# ("pod", "data", "model") meshes share it; "pod" only ever carries batch.
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    # activations
    "batch": ("pod", "data"),
    "seq": (),
    "act_embed": (),
    "act_heads": ("model",),
    "act_mlp": ("model",),
    "act_exp": ("model",),
    "act_vocab": ("model",),
    # params
    "vocab": ("model",),
    "embed": ("data",),      # FSDP / ZeRO-3: the d_model dim over data
    "mlp": ("model",),       # tensor parallel: d_ff over model
    "heads": ("model",),
    "kv_heads": ("model",),
    "qkv": ("model",),       # flattened (heads * head_dim) projections
    "experts": ("model",),   # expert parallelism
    "mlp_zero": ("data",),   # ZeRO storage of the experts' w_down d_ff dim
    "inner": ("model",),     # SSM inner (expanded) dim
    "layers": (),            # the stacked layer axis: never sharded
    "state": (),
    # KV cache
    "cache_batch": ("data",),
    "cache_seq": (),
    "cache_heads": ("model",),
}

# Logical axes where uneven (padded) sharding beats replication.
UNEVEN_OK = {"act_heads"}

_local = threading.local()

Spec = Tuple[Any, ...]


def current_rules() -> Dict[str, Tuple[str, ...]]:
    return getattr(_local, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def axis_rules(rules: Optional[Dict[str, Tuple[str, ...]]] = None,
               **overrides):
    """Install a rule table (``DEFAULT_RULES`` with ``overrides``) for the
    context, on this thread."""
    base = dict(rules if rules is not None else DEFAULT_RULES)
    base.update(overrides)
    prev = getattr(_local, "rules", None)
    _local.rules = base
    try:
        yield base
    finally:
        if prev is None:
            del _local.rules
        else:
            _local.rules = prev


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor, without importing DTensor's module
    (over a second) on paths that never made one."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh on this thread for the context."""
    prev = getattr(_local, "mesh", None)
    _local.mesh = mesh
    try:
        yield mesh
    finally:
        _local.mesh = prev


def active_mesh():
    """The mesh ``use_mesh`` installed on this thread, or ``None``."""
    return getattr(_local, "mesh", None)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh, a MeshConfig or a duck-typed
    mesh (``axis_names`` and ``devices.shape``)."""
    names = (getattr(mesh, "mesh_dim_names", None)
             or getattr(mesh, "axis_names", None) or mesh.axes)
    shape = (mesh.devices.shape if hasattr(mesh, "devices")
             else tuple(mesh.shape))
    return dict(zip(names, (int(s) for s in shape)))


def _entry(axes):
    return tuple(axes) if len(axes) > 1 else axes[0]


def resolve_spec(shape: Sequence[int], logical_axes: Sequence[Optional[str]],
                 mesh) -> Spec:
    """Logical axes -> a spec, dropping non-divisible mappings."""
    rules = current_rules()
    sizes = axis_sizes(mesh)
    used = set()
    parts = []
    for dim, name in zip(shape, logical_axes):
        if name is None:
            parts.append(None)
            continue
        mesh_axes = [a for a in rules.get(name, ())
                     if a in sizes and a not in used]
        total = math.prod(sizes[a] for a in mesh_axes)
        # Activations tolerate uneven sharding (hymba's 25 heads on a
        # 16-way axis): replication would compute every head on each shard.
        if name in UNEVEN_OK and mesh_axes and dim >= total:
            used.update(mesh_axes)
            parts.append(_entry(mesh_axes))
            continue
        if mesh_axes and dim % total == 0:
            used.update(mesh_axes)
            parts.append(_entry(mesh_axes))
            continue
        # progressively shorter prefixes (a batch too small for pod * data)
        ok = None
        for cut in range(len(mesh_axes) - 1, 0, -1):
            if dim % math.prod(sizes[a] for a in mesh_axes[:cut]) == 0:
                ok = mesh_axes[:cut]
                break
        if ok:
            used.update(ok)
            parts.append(_entry(ok))
        else:
            parts.append(None)
    return tuple(parts)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh axis, a
    ``Shard(dim)`` where the spec names that axis, else ``Replicate()``.
    A dim over several mesh axes is split in mesh-axis order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(a)] = Shard(dim)
    return tuple(out)


def shard(x, *logical_axes):
    """Redistribute a DTensor to the layout its logical axes resolve to;
    a plain tensor, or any tensor with no active mesh, is returned as it
    is."""
    if active_mesh() is None or not is_dtensor(x):
        return x
    mesh = x.device_mesh
    target = placements(resolve_spec(x.shape, logical_axes, mesh), mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(mesh, target)


def gather_storage(x, *logical_axes):
    """A weight's dims stored over the batch mesh axes (ZeRO-3: "embed",
    "mlp_zero" over "data") gathered, its other dims left as they are:
    the FSDP all-gather XLA's partitioner chooses for a matmul with such a
    weight, made explicit, since DTensor's per-op choice would instead
    all-reduce the (batch, seq, out) partial sums. A no-op where
    ``shard`` is one."""
    if active_mesh() is None:
        return x
    batch = set(current_rules().get("batch", ()))
    return shard(x, *(None if a is not None and
                      set(current_rules().get(a, ())) & batch else a
                      for a in logical_axes))


def _whole_if_uneven(x, pl, dim: int, rows: int):
    """``pl`` with dim ``dim``'s shards replaced by ``Replicate()`` where
    the shards that split it do not divide ``rows``."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = list(axis_sizes(x.device_mesh).values())
    split = math.prod(sizes[i] for i, p in enumerate(pl)
                      if isinstance(p, Shard) and p.dim == dim)
    if rows % split == 0:
        return tuple(pl)
    return tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
                 for p in pl)


def _reshaped(x, dim: int, rows: int, shape):
    """``x.reshape(shape)`` for a DTensor, first gathered on ``dim`` unless
    its shards of that dim hold whole multiples of ``x.shape[dim] /
    rows``."""
    pl = _whole_if_uneven(x, x.placements, dim, rows)
    if pl != tuple(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return x.reshape(shape)


class _SplitDim(torch.autograd.Function):
    """A DTensor's ``split_dim`` whose gradient goes back through
    ``merge_dims``: autograd's own view backward would merge the
    gradient's (possibly unevenly split) dims, which DTensor refuses."""

    @staticmethod
    def forward(ctx, x, dim, sizes):
        ctx.dim, ctx.count = dim, len(sizes)
        shape = tuple(x.shape[:dim]) + tuple(sizes) + tuple(x.shape[dim + 1:])
        return _reshaped(x, dim, sizes[0], shape)

    @staticmethod
    def backward(ctx, grad):
        return merge_dims(grad, ctx.dim, ctx.count), None, None


class _MergeDims(torch.autograd.Function):
    """A DTensor's ``merge_dims``, its gradient split by ``split_dim``."""

    @staticmethod
    def forward(ctx, x, dim, count):
        ctx.dim, ctx.sizes = dim, tuple(x.shape[dim:dim + count])
        shape = (tuple(x.shape[:dim]) + (math.prod(ctx.sizes),)
                 + tuple(x.shape[dim + count:]))
        return _reshaped(x, dim, x.shape[dim], shape)

    @staticmethod
    def backward(ctx, grad):
        return split_dim(grad, ctx.dim, ctx.sizes), None, None


def split_dim(x, dim: int, sizes: Sequence[int]):
    """``x`` with dim ``dim`` reshaped into ``sizes`` (see the module
    docstring)."""
    if not is_dtensor(x):
        return x.unflatten(dim, sizes)
    return _SplitDim.apply(x, dim % x.dim(), tuple(sizes))


def merge_dims(x, dim: int, count: int = 2):
    """``x`` with dims ``dim .. dim + count - 1`` merged into one (see the
    module docstring)."""
    if not is_dtensor(x):
        return x.flatten(dim, dim + count - 1)
    return _MergeDims.apply(x, dim % x.dim(), count)


def local_apply(fn, spec_axes, *xs):
    """``fn`` on the local shards of DTensors ``xs`` (``local_map``), each
    first laid out by the matching logical axes of ``spec_axes``, a dim
    its axes would split unevenly kept whole; the result takes the first
    input's placements. The counterpart of a ``shard_map`` body for work
    independent across the sharded dims (attention over batch and
    heads): DTensor then plans no layout for the ops inside, which on a
    3-D mesh takes minutes an op."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = xs[0].device_mesh
    laid = []
    for x, axes in zip(xs, spec_axes):
        pl = placements(resolve_spec(x.shape, axes, mesh), mesh)
        for dim in {p.dim for p in pl if isinstance(p, Shard)}:
            pl = _whole_if_uneven(x, pl, dim, x.shape[dim])
        laid.append(x.redistribute(mesh, pl))
    return local_map(fn, out_placements=list(laid[0].placements),
                     in_placements=tuple(list(t.placements) for t in laid),
                     redistribute_inputs=False)(*laid)


class NamedSharding(NamedTuple):
    """A mesh and a resolved spec (``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def named_sharding(mesh, shape: Sequence[int],
                   logical_axes: Sequence[Optional[str]]) -> NamedSharding:
    return NamedSharding(mesh, resolve_spec(shape, logical_axes, mesh))


def _zip_tree(fn, tree, axes):
    """``fn(leaf, axes)`` over ``tree``'s leaves. The tensor tree bounds
    the walk, so an axes tuple (which looks like a container) is taken
    whole; ``None`` axes mean every dim unsharded."""
    if tree is None:
        return None
    if hasattr(tree, "shape"):    # a tensor or a Spec
        return fn(tree, axes if axes is not None
                  else (None,) * len(tree.shape))
    if isinstance(tree, dict):
        return {k: _zip_tree(fn, v, axes[k]) for k, v in tree.items()}
    if hasattr(tree, "_fields"):  # a NamedTuple: axes by field name or place
        return type(tree)(*(
            _zip_tree(fn, getattr(tree, f),
                      axes[f] if isinstance(axes, dict) else axes[i])
            for i, f in enumerate(tree._fields)))
    return type(tree)(_zip_tree(fn, t, axes[i]) for i, t in enumerate(tree))


def tree_shardings(mesh, tree, tree_axes):
    """A ``NamedSharding`` for every leaf of ``tree`` (tensors or anything
    with a ``shape``), from the matching logical-axes tree."""
    return _zip_tree(lambda t, ax: named_sharding(mesh, tuple(t.shape), ax),
                     tree, tree_axes)


def distribute(mesh, t: torch.Tensor, logical_axes) -> torch.Tensor:
    """``t`` as a DTensor on ``mesh`` at its resolved placements. A
    ``meta`` tensor becomes a ``meta`` DTensor holding its local shard's
    shape; any other is split from the full tensor every rank holds."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    pl = placements(resolve_spec(tuple(t.shape), logical_axes, mesh), mesh)
    if t.device.type == "meta":
        local, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
        return DTensor.from_local(
            torch.empty(local, dtype=t.dtype, device="meta"), mesh, pl,
            shape=t.shape, stride=t.stride(), run_check=False)
    return distribute_tensor(t, mesh, pl)


def distribute_tree(mesh, tree, axes):
    """Every leaf of ``tree`` as a DTensor on ``mesh`` (``distribute``),
    laid out by the matching logical-axes tree."""
    return _zip_tree(lambda t, ax: distribute(mesh, t, ax), tree, axes)
