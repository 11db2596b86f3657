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
carried beside the arrays. The schedulers of this slice have no learned
parameters (their snapshot is the generator state); BODS rings and RLDS
params join in ROADMAP module 5.

A ``real_fl`` run's models cross with ``cnn_params_from_reference`` (the
reference's CNN params, a list of dicts of numpy arrays as
``jax.device_get`` gives them, to the port's tensors),
``cnn_params_to_reference`` (back); ``FusedMultiRuntime.load_params(job_id,
params)`` takes either form for one job. Nothing here imports the
reference.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Union

import numpy as np
import torch

from repro_torch.experiment.spec import Experiment, ExperimentSpec
from repro_torch.tree import tree_map


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
