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
params join in ROADMAP module 5. Nothing here imports the reference.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Union

from repro_torch.experiment.spec import Experiment, ExperimentSpec


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
