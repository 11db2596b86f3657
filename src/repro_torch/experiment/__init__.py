"""Declarative experiment API: one ``ExperimentSpec -> run()`` entrypoint.

    from repro_torch.experiment import ExperimentSpec, JobSpec

    spec = ExperimentSpec(jobs=(JobSpec(name="clf"),), scheduler="greedy")
    result = spec.run(device="cuda")   # -> ExperimentResult

Specs and results are the reference's JSON: a spec or result written by
``repro`` loads and replays here unchanged (``from_dict`` maps the
reference's scoring backends ``jax``/``pallas`` to ``torch``/``cuda``).
The device is a build argument, never a spec field.

Attribute access is lazy (PEP 562) so that ``repro_torch.core.schedulers``
can import ``repro_torch.experiment.registry`` at class-definition time
without an import cycle.
"""

from __future__ import annotations

_EXPORTS = {
    "Registry": "repro_torch.experiment.registry",
    "SCHEDULERS": "repro_torch.experiment.registry",
    "RUNTIMES": "repro_torch.experiment.registry",
    "register_scheduler": "repro_torch.experiment.registry",
    "register_runtime": "repro_torch.experiment.registry",
    "JobSpec": "repro_torch.experiment.spec",
    "PoolSpec": "repro_torch.experiment.spec",
    "CostSpec": "repro_torch.experiment.spec",
    "FleetSpec": "repro_torch.experiment.spec",
    "TrainSpec": "repro_torch.experiment.spec",
    "ObsSpec": "repro_torch.experiment.spec",
    "ExperimentSpec": "repro_torch.experiment.spec",
    "Experiment": "repro_torch.experiment.spec",
    "ExperimentResult": "repro_torch.experiment.spec",
    "get_preset": "repro_torch.experiment.presets",
    "list_presets": "repro_torch.experiment.presets",
    "register_preset": "repro_torch.experiment.presets",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib

        module = importlib.import_module(_EXPORTS[name])
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return __all__
