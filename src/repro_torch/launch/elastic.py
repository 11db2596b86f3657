"""Elastic, fault-tolerant training runtime: checkpoint and restart.

A copy of the reference's ``repro/launch/elastic.py`` over the port's
``CheckpointManager`` (pure host code):

- Checkpoints every ``save_every`` steps and at the end, committed
  atomically; a crash loses at most ``save_every`` steps.
- The data pipeline's cursor rides in the checkpoint's ``extra``, so the
  batch stream resumes exactly.
- ``run_elastic`` wraps the step loop: a step that raises (a lost device;
  injected here by ``FailureInjector``) restores the latest checkpoint, or
  the initial state before the first one, and resumes.

The checkpoint holds ``make_state()``'s tree in the reference's layout and
JAX's leaf order, so a run resumes from a step the other package wrote.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable, Dict, Optional

from repro_torch.checkpoint import CheckpointManager


class FailureInjector:
    """Deterministic fault injection: raises at the given steps, once
    each."""

    def __init__(self, fail_at_steps=(), exc=RuntimeError):
        self.fail_at = set(fail_at_steps)
        self.exc = exc
        self.injected = []

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at:
            self.fail_at.discard(step)
            self.injected.append(step)
            raise self.exc(f"injected device failure at step {step}")


@dataclasses.dataclass
class ElasticConfig:
    save_every: int = 20
    max_restarts: int = 3
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(),
                                       "repro_torch_ckpt")


def run_elastic(
    *,
    make_state: Callable[[], Any],           # () -> (params, opt_state)
    step_fn: Callable[[Any, Any], Any],      # (state, batch) -> (state, metrics)
    batch_iter,                              # restartable: .state(), .restore()
    num_steps: int,
    config: ElasticConfig,
    injector: Optional[FailureInjector] = None,
    on_step: Optional[Callable[[int, Dict], None]] = None,
) -> Dict[str, Any]:
    """Run ``num_steps`` with checkpoint/restart fault tolerance.

    Returns {'state': final_state, 'restarts': n, 'steps_replayed': n}.
    """
    mgr = CheckpointManager(config.checkpoint_dir, keep=2)
    restarts = 0
    replayed = 0

    init_pipeline = batch_iter.state()  # for recovery before any checkpoint
    state = make_state()
    step = 0
    latest = mgr.latest_step()
    if latest is not None:
        step, state, extra = mgr.restore_latest(state)
        if "pipeline" in extra:
            batch_iter.restore(extra["pipeline"])

    while step < num_steps:
        try:
            if injector is not None:
                injector.maybe_fail(step)
            batch = next(batch_iter)
            state, metrics = step_fn(state, batch)
            step += 1
            if on_step is not None:
                m = {k: float(v) for k, v in metrics.items()}
                on_step(step, m)
            if step % config.save_every == 0 or step == num_steps:
                mgr.save(step, state, extra={"pipeline": batch_iter.state()})
        except StopIteration:
            break
        except Exception as e:  # noqa: BLE001 - any fault triggers recovery
            restarts += 1
            if restarts > config.max_restarts:
                raise RuntimeError(
                    f"exceeded max_restarts={config.max_restarts}") from e
            latest = mgr.latest_step()
            if latest is None:
                state = make_state()
                batch_iter.restore(init_pipeline)
                replayed += step
                step = 0
            else:
                prev_step, state, extra = mgr.restore_latest(make_state())
                if "pipeline" in extra:
                    batch_iter.restore(extra["pipeline"])
                replayed += step - prev_step
                step = prev_step
    return {"state": state, "restarts": restarts, "steps_replayed": replayed}
