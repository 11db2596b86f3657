"""Atomic, manifest-driven pytree checkpoints (pure numpy .npz container).

Layout:  <dir>/step_<N:010d>/
            manifest.json   — leaf keys, dtypes, shapes, metadata (``extra``)
            arrays.npz      — flat leaf arrays keyed "leaf_<i>"
            .complete       — commit marker (written LAST -> atomic restore)

This is the reference's layout, leaf for leaf: leaves are visited in JAX's
order (``repro_torch.tree.tree_flatten_with_paths``: dict keys sorted, a
NamedTuple's fields as ``.<field>``, ``None`` an empty subtree), so either
package loads the other's steps.

Fault-tolerance contract:
- ``save`` writes into a temp dir then os.rename's it into place; a crash
  mid-save never corrupts the latest checkpoint.
- ``restore`` picks the newest COMMITTED step; partial saves are ignored and
  garbage-collected, and an unreadable newest step falls back to the one
  before it.
- Tensor leaves are saved from the host (``.detach().cpu()``, which waits
  for the stream) and restored to the dtype and device of the matching
  leaf of ``like``; numpy leaves stay numpy.
- bf16 and fp8 leaves are stored as same-width unsigned integer views with
  the manifest naming the real dtype (numpy's ``savez`` cannot hold them),
  without ``ml_dtypes``: on load they come back as torch tensors of that
  dtype.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import warnings
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_flatten_with_paths, tree_unflatten

PyTree = Any
_MARKER = ".complete"

# dtype name -> (torch dtype, numpy storage view, same-width signed view
# that torch.from_numpy takes).
_EXOTIC = {"bfloat16": (torch.bfloat16, np.uint16, np.int16),
           "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, np.int8),
           "float8_e5m2": (torch.float8_e5m2, np.uint8, np.int8)}
_TORCH_EXOTIC = {v[0]: k for k, v in _EXOTIC.items()}
_SIGNED = {1: torch.int8, 2: torch.int16}


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the numpy array stored in the npz and its dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = _TORCH_EXOTIC.get(t.dtype)
        if name is not None:
            bits = t.view(_SIGNED[t.element_size()]).numpy()
            return bits.view(_EXOTIC[name][1]), name
        a = t.numpy()
        return a, a.dtype.name
    a = np.asarray(leaf)
    return a, a.dtype.name


def _decode(a: np.ndarray, dtype_name: str):
    """A stored array as its leaf: exotic dtypes become torch tensors."""
    if dtype_name in _EXOTIC:
        dtype, _, signed = _EXOTIC[dtype_name]
        return torch.from_numpy(np.ascontiguousarray(a).view(signed)).view(
            dtype)
    return a


def _like_leaf(stored, like):
    """``stored`` in the dtype (and, for tensors, on the device) of the
    matching leaf of ``like``."""
    if isinstance(like, torch.Tensor):
        t = stored if isinstance(stored, torch.Tensor) else \
            torch.from_numpy(np.array(stored))
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(stored, torch.Tensor):   # a bf16 or fp8 leaf: exact in f32
        stored = stored.float().numpy()
    return np.asarray(stored, dtype=np.asarray(like).dtype)


def save_checkpoint(directory: str, step: int, tree: PyTree,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    final = step_path(directory, step)
    tmp = tempfile.mkdtemp(prefix=f".tmp_step_{step}_", dir=directory)
    try:
        flat = tree_flatten_with_paths(tree)
        raw = [_host(v) for _, v in flat]
        arrays = {f"leaf_{i}": a for i, (a, _) in enumerate(raw)}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "keys": [k for k, _ in flat],
            "dtypes": [name for _, name in raw],
            "shapes": [list(a.shape) for a, _ in raw],
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, _MARKER), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def step_path(directory: str, step: int) -> str:
    """Canonical on-disk location of one step — the single definition of
    the layout."""
    return os.path.join(directory, f"step_{step:010d}")


def committed_steps(directory: str) -> List[int]:
    """Steps with a commit marker (fully written), ascending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
                os.path.join(directory, name, _MARKER)):
            steps.append(int(name.split("_")[1]))
    return sorted(steps)


# Failure modes a damaged-on-disk step presents as: missing/short files
# (OSError, EOFError), garbled JSON, an npz whose zip directory is torn
# (zipfile.BadZipFile or ValueError from numpy), or a manifest missing keys.
_CORRUPT_ERRORS = (OSError, ValueError, KeyError, json.JSONDecodeError,
                   zipfile.BadZipFile, EOFError)


def _load_step(path: str, like: PyTree) -> Tuple[PyTree, Dict[str, Any]]:
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        leaves = [_decode(data[f"leaf_{i}"], manifest["dtypes"][i])
                  for i in range(len(manifest["keys"]))]
    flat_like = [leaf for _, leaf in tree_flatten_with_paths(like)]
    if len(flat_like) != len(leaves):
        # Not one of _CORRUPT_ERRORS: a wrong ``like`` is the caller's
        # fault, and an older step would not fit it either.
        raise RuntimeError(f"checkpoint/model structure mismatch: "
                         f"{len(leaves)} stored leaves, {len(flat_like)} in "
                         "the tree to restore into")
    leaves = [_like_leaf(l, fl) for l, fl in zip(leaves, flat_like)]
    return tree_unflatten(like, leaves), manifest["extra"]


def load_checkpoint(directory: str, like: PyTree, step: Optional[int] = None
                    ) -> Tuple[int, PyTree, Dict[str, Any]]:
    """Restore the newest (or given) committed step into the structure of
    ``like``; each leaf takes the dtype (and a tensor leaf the device) of
    ``like``'s.

    When ``step`` is None and the newest committed step is unreadable
    (torn write that still managed to land a marker, disk bit-rot), older
    committed steps are tried newest-first — losing one save interval
    beats refusing to resume. An explicitly requested ``step`` still
    raises: the caller asked for THAT state, not a neighbor's.
    """
    steps = committed_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoints in {directory}")
    if step is not None:
        tree, extra = _load_step(step_path(directory, step), like)
        return step, tree, extra
    last_err: Optional[BaseException] = None
    for s in reversed(steps):
        try:
            tree, extra = _load_step(step_path(directory, s), like)
        except _CORRUPT_ERRORS as e:
            warnings.warn(
                f"checkpoint step {s} in {directory} is unreadable "
                f"({type(e).__name__}: {e}); falling back to the previous "
                f"committed step", stacklevel=2)
            last_err = e
            continue
        return s, tree, extra
    raise FileNotFoundError(
        f"all {len(steps)} committed checkpoints in {directory} are "
        f"unreadable (last error: {last_err!r})")


class CheckpointManager:
    """Keep-last-N manager with crash-safe GC of partial saves."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._gc_partial()

    def _gc_partial(self) -> None:
        for name in os.listdir(self.directory):
            p = os.path.join(self.directory, name)
            if name.startswith(".tmp_") or (
                    name.startswith("step_") and not os.path.exists(os.path.join(p, _MARKER))):
                shutil.rmtree(p, ignore_errors=True)

    def save(self, step: int, tree: PyTree, extra: Optional[Dict] = None) -> str:
        path = save_checkpoint(self.directory, step, tree, extra)
        for s in committed_steps(self.directory)[: -self.keep]:
            shutil.rmtree(step_path(self.directory, s), ignore_errors=True)
        return path

    def restore_latest(self, like: PyTree):
        return load_checkpoint(self.directory, like)

    def latest_step(self) -> Optional[int]:
        steps = committed_steps(self.directory)
        return steps[-1] if steps else None
