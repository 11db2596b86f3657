"""Policy zoo: durable, named storage for trained scheduler state.

Gym-trained RLDS policies, online-trained DNN regressors, and BODS GP
observation rings all persist through ``repro_torch.checkpoint`` (atomic,
manifest-driven .npz pytrees in the reference's layout), keyed by a policy
NAME under one root directory::

    policies/<name>/step_0000000000/{manifest.json, arrays.npz, .complete}

The manifest's ``extra`` block records the policy KIND (the scheduler
registry name) and free-form metadata (curriculum, training iters, eval
costs), so ``load_into`` can refuse kind mismatches before touching any
scheduler state. Restores are bit-exact, and an entry written by either
package loads in the other (tested in tests/test_torch_zoo.py).

Schedulers participate by exposing ``state_dict() -> pytree`` and
``load_state_dict(pytree)`` (RLDS, DNN, BODS do); the experiment layer
wires the ``ExperimentSpec.policy`` axis through ``load_into`` so a spec
names its warm start declaratively.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import (committed_steps, load_checkpoint,
                                    save_checkpoint, step_path)

DEFAULT_ZOO_DIR = "policies"


class PolicyZoo:
    """Name -> checkpointed scheduler-state pytree, with kind/meta tags."""

    def __init__(self, root: str = DEFAULT_ZOO_DIR):
        self.root = root

    def _dir(self, name: str) -> str:
        return os.path.join(self.root, name)

    # ---- write ----

    def save(self, name: str, kind: str, tree: Any,
             meta: Optional[Dict] = None) -> str:
        """Persist a scheduler state pytree under ``name``; returns the
        committed checkpoint path."""
        return save_checkpoint(self._dir(name), 0, tree,
                               extra={"kind": kind, "meta": meta or {}})

    def save_scheduler(self, name: str, scheduler,
                       meta: Optional[Dict] = None) -> str:
        """Snapshot a live scheduler (anything with ``state_dict``)."""
        return self.save(name, scheduler.name, scheduler.state_dict(), meta)

    # ---- read ----

    def load(self, name: str, like: Any) -> Tuple[Any, str, Dict]:
        """Restore ``name`` into the structure of ``like``; returns
        (tree, kind, meta)."""
        try:
            _, tree, extra = load_checkpoint(self._dir(name), like)
        except FileNotFoundError:
            raise FileNotFoundError(
                f"no policy {name!r} in zoo {self.root!r}; "
                f"known: {self.names()}") from None
        return tree, extra.get("kind", "?"), extra.get("meta", {})

    def load_into(self, name: str, scheduler) -> Dict:
        """Load ``name`` into a live scheduler; returns the policy meta.

        The scheduler must expose ``state_dict``/``load_state_dict`` and its
        registry name must match the saved policy kind.
        """
        # SchedulerBase gives every scheduler an EMPTY state_dict default
        # (service warm hand-off protocol); only learners override it with
        # real state, so an empty tree means there is nothing to load into.
        if not scheduler.state_dict():
            raise TypeError(
                f"scheduler {scheduler.name!r} has an empty state_dict; "
                "only learned schedulers (rlds, dnn, bods) can load zoo "
                "policies")
        # info() raises the known-names FileNotFoundError for missing
        # entries and reads the kind from the manifest BEFORE any arrays
        # load, so a mismatched tree structure can't mask the error.
        kind = self.info(name).get("kind", "?")
        if kind != scheduler.name:
            raise ValueError(
                f"policy {name!r} is kind {kind!r}, scheduler is "
                f"{scheduler.name!r}")
        tree, _, meta = self.load(name, like=scheduler.state_dict())
        scheduler.load_state_dict(tree)
        return meta

    def info(self, name: str) -> Dict:
        """Kind + meta of the newest committed step, without loading the
        arrays. Layout questions (which step, what counts as committed)
        are answered by ``repro_torch.checkpoint`` — the zoo never
        re-derives the on-disk format."""
        steps = committed_steps(self._dir(name))
        if not steps:
            raise FileNotFoundError(
                f"no policy {name!r} in zoo {self.root!r}; "
                f"known: {self.names()}")
        path = os.path.join(step_path(self._dir(name), steps[-1]),
                            "manifest.json")
        with open(path) as f:
            return json.load(f).get("extra", {})

    def names(self) -> List[str]:
        if not os.path.isdir(self.root):
            return []
        return [name for name in sorted(os.listdir(self.root))
                if committed_steps(self._dir(name))]


def save_rlds_params(zoo: PolicyZoo, name: str, params, num_jobs: int,
                     lr: float = 1e-2, meta: Optional[Dict] = None) -> str:
    """Wrap bare gym-trained policy params into a full RLDS scheduler state
    (fresh AdamW moments, unset baselines) and save it.

    The tree is the reference's leaf for leaf: f32 params and moments, an
    int32 optimizer step, f64 ``baselines`` and ``adv_scale``, a bool
    ``pretrained``. The live scheduler's optimizer state is
    shape-determined by the params, so a fresh init is the correct warm
    start — online fine-tuning resumes from step 0 with the trained
    weights. ``pretrained`` is True: the gym training IS the pre-training,
    so the lazy Algorithm-3 loop is skipped.
    """
    from repro_torch.core.schedulers.rlds import policy_optimizer

    opt_init, _ = policy_optimizer(lr)
    tree = {"params": params, "opt": opt_init(params),
            "baselines": np.full(num_jobs, np.nan),
            "adv_scale": np.asarray(1.0, np.float64),
            "pretrained": np.asarray(True)}
    return zoo.save(name, "rlds", tree, meta=meta)
