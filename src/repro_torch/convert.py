"""Carry a run across from the reference ``repro`` in the middle of it.

``load_engine_state`` builds the port's ``Experiment`` from the reference's
spec and its numpy and JSON state alone, so that both engines then go on
with identical ``RoundRecord``s. The state is a plain dict of what the
reference's public methods give:

    {"pool":          DevicePool.state_dict(),
     "pool_rng":      pool.rng.bit_generator.state,
     "engine_arrays": engine.state_arrays(),
     "engine_meta":   engine.state_meta(),
     "runtime":       SyntheticRuntime.state_dict(),
     "runtime_rng":   runtime.rng.bit_generator.state,
     "scheduler":     scheduler.snapshot()}

The pool's generator draws every round's realized times, so its state is
carried beside the arrays. A learning scheduler's snapshot carries its
``state_dict`` beside the generator state; the port's ``load_state_dict``
takes the reference's leaves (numpy or JAX arrays) as they are. The
``*_state_from_reference`` / ``*_state_to_reference`` pairs map one
scheduler's ``state_dict`` between the layouts explicitly: BODS's
observation rings (numpy on both sides), RLDS's params, ``OptState(step,
(m, v))``, baselines, ``adv_scale`` and ``pretrained`` flag, DNN's params
and replay ring. To the reference every leaf is numpy; the optimizer state
keeps the fields ``step`` and ``inner`` the reference reads.

A ``real_fl`` run's models cross with ``cnn_params_from_reference`` (the
reference's CNN params, a list of dicts of numpy arrays as
``jax.device_get`` gives them, to the port's tensors),
``cnn_params_to_reference`` (back); ``FusedMultiRuntime.load_params(job_id,
params)`` takes either form for one job. A language model's params cross
with ``lm_params_from_reference`` / ``lm_params_to_reference``: the
reference's ``lm_init`` params (nested dicts, block leaves stacked on a
leading layer axis) keep that layout in the port. The scheduler gym's
environments cross with ``env_state_from_reference`` (the reference's
``EnvState`` or ``ScenarioDraw``, one environment or a vmapped batch, to the
port's batched tensors), so that both packages step the same scenarios.
Nothing here imports the reference.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Union

import numpy as np
import torch

from repro_torch.experiment.spec import Experiment, ExperimentSpec
from repro_torch.optim.optimizers import OptState
from repro_torch.tree import as_tensor, tree_map


def cnn_params_from_reference(params: List[Dict[str, Any]],
                              device: str = "cuda") -> List[Dict[str, Any]]:
    """The reference's CNN params (numpy leaves, NHWC/HWIO as the port
    keeps them) as float32 tensors on ``device``; values are copied
    exactly."""
    return tree_map(
        lambda a: torch.as_tensor(np.array(a, np.float32), device=device),
        params)


def cnn_params_to_reference(params: List[Dict[str, Any]]
                            ) -> List[Dict[str, np.ndarray]]:
    """The port's CNN params as numpy float32 arrays, the reference's
    layout (``jnp.asarray`` of each leaf gives its params)."""
    return tree_map(lambda t: t.detach().cpu().numpy().astype(np.float32),
                    params)


def _lm_leaf_from_reference(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: same bits as torch's
        bits = np.array(a).view(np.int16)  # a writable copy
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a, np.float32), device=device)


def lm_params_from_reference(params: Dict[str, Any],
                             device: str = "cuda") -> Dict[str, Any]:
    """The reference's LLM params (numpy leaves, as ``jax.device_get``
    gives them) as tensors on ``device``: a bfloat16 leaf (a
    ``param_dtype="bfloat16"`` config such as kimi-k2) stays bfloat16, any
    other becomes float32; values are copied exactly."""
    return tree_map(lambda a: _lm_leaf_from_reference(a, device), params)


def _lm_leaf_to_reference(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # JAX's own dependency, present beside the reference

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().astype(np.float32)


def lm_params_to_reference(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's LLM params as numpy arrays in the reference's layout
    (``jnp.asarray`` of each leaf gives its params): bfloat16 leaves as
    ``ml_dtypes.bfloat16`` arrays (the package JAX's bf16 arrays use),
    every other leaf as float32."""
    return tree_map(_lm_leaf_to_reference, params)


def _host(leaf) -> np.ndarray:
    """A tensor or array leaf as a numpy copy."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy().copy()
    return np.array(leaf)


def bods_state_from_reference(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The reference's BODS rings as the port's, or the port's as the
    reference's: numpy on both sides, so a copy serves both ways."""
    return {k: _host(v) for k, v in tree.items()}


def _opt_from_reference(opt, device) -> OptState:
    step, (m, v) = opt

    def f32(a):
        return as_tensor(a, device, torch.float32)

    return OptState(as_tensor(step, device, torch.int32),
                    (tree_map(f32, m), tree_map(f32, v)))


def rlds_state_from_reference(tree: Dict[str, Any],
                              device: str = "cuda") -> Dict[str, Any]:
    """The reference's RLDS ``state_dict`` (params and the adamw
    ``OptState`` as JAX or numpy arrays) as the port's: f32 tensors on
    ``device``, the step an int32 tensor."""
    return {
        "params": tree_map(lambda a: as_tensor(a, device, torch.float32),
                           dict(tree["params"])),
        "opt": _opt_from_reference(tree["opt"], device),
        "baselines": np.array(tree["baselines"], np.float64),
        "adv_scale": np.array(tree["adv_scale"], np.float64),
        "pretrained": np.array(tree["pretrained"], bool),
    }


def rlds_state_to_reference(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's RLDS ``state_dict`` with numpy leaves, the reference's
    layout (its ``load_state_dict`` reads ``opt.step`` and ``opt.inner``)."""
    step, (m, v) = tree["opt"]
    return {
        "params": tree_map(_host, dict(tree["params"])),
        "opt": OptState(np.asarray(_host(step), np.int32),
                        (tree_map(_host, m), tree_map(_host, v))),
        "baselines": np.array(tree["baselines"], np.float64),
        "adv_scale": np.array(tree["adv_scale"], np.float64),
        "pretrained": np.array(tree["pretrained"], bool),
    }


def dnn_state_from_reference(tree: Dict[str, Any],
                             device: str = "cuda") -> Dict[str, Any]:
    """The reference's DNN ``state_dict``: the MLP params as f32 tensors on
    ``device``, the replay ring numpy."""
    out = {k: _host(v) for k, v in tree.items() if k != "params"}
    out["params"] = tree_map(lambda a: as_tensor(a, device, torch.float32),
                             dict(tree["params"]))
    return out


def dnn_state_to_reference(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's DNN ``state_dict`` with numpy leaves (the reference's)."""
    out = {k: _host(v) for k, v in tree.items() if k != "params"}
    out["params"] = tree_map(_host, dict(tree["params"]))
    return out


def _env_leaf(a, batched: bool, device) -> torch.Tensor:
    """A reference gym leaf as a tensor with a leading environment axis:
    floats f32, bools bool, integer indices int64 (torch's index type)."""
    a = np.asarray(a)
    if not batched:
        a = a[None]
    if a.dtype == np.bool_:
        return torch.as_tensor(np.array(a), device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(a.astype(np.float32), device=device)


def env_state_from_reference(tree, device: str = "cuda"):
    """The reference's gym ``EnvState`` or ``ScenarioDraw`` (numpy or JAX
    leaves; one environment, or E of them as ``vmap`` gives them) as the
    port's, with a leading environment axis on ``device``. The state's PRNG
    key is dropped: the port's draws come from a ``torch.Generator``, or
    are injected (``policy_rollout(..., noise=...)``)."""
    from repro_torch.gym.env import EnvState, Scenario
    from repro_torch.gym.scenarios import ScenarioDraw

    def fields(obj, cls, batched):
        return {f: _env_leaf(getattr(obj, f), batched, device)
                for f in cls._fields}

    if not hasattr(tree, "scen"):
        return ScenarioDraw(**fields(tree, ScenarioDraw,
                                     np.ndim(tree.a) == 2))
    batched = np.ndim(tree.busy_until) == 2
    dyn = {f: _env_leaf(getattr(tree, f), batched, device)
           for f in EnvState._fields if f != "scen"}
    dyn["round_idx"] = dyn["round_idx"].to(torch.int32)
    return EnvState(scen=Scenario(**fields(tree.scen, Scenario, batched)),
                    **dyn)


def load_engine_state(spec: Union[ExperimentSpec, dict],
                      state: Dict[str, Any],
                      device: str = "cuda") -> Experiment:
    """Build the port's experiment for ``spec`` (a port spec, or the
    reference's ``spec.to_dict()``) and load ``state`` into it. Jobs the
    reference admitted mid-run must already be in ``spec.jobs``."""
    if isinstance(spec, dict):
        spec = ExperimentSpec.from_dict(spec)
    state = copy.deepcopy(state)
    exp = spec.build(device=device)
    eng = exp.engine
    eng.pool.load_state_dict(state["pool"])
    eng.pool.rng.bit_generator.state = state["pool_rng"]
    eng.load_state(state["engine_arrays"], state["engine_meta"])
    eng.runtime.load_state_dict(state["runtime"])
    eng.runtime.rng.bit_generator.state = state["runtime_rng"]
    eng.scheduler.restore(state["scheduler"])
    return exp
