"""Device schedulers for multi-job FL.

Paper baselines ported here: Random, FedCS, Greedy, Genetic and (appendix)
SimulatedAnnealing, the last two on their host search. The paper's methods
BODS and RLDS, and the DNN scheduler, are ROADMAP module 5: their names are
registered so that a spec naming them fails with ``NotImplementedError``
instead of an unknown-name ``KeyError``.

Schedulers self-register into ``repro_torch.experiment.registry.SCHEDULERS``
via ``@register_scheduler("<name>")``; importing this package loads every
built-in.
"""

from repro_torch.core.schedulers.base import SchedulerBase, SchedulingContext
from repro_torch.core.schedulers.random_sched import RandomScheduler
from repro_torch.core.schedulers.greedy import GreedyScheduler
from repro_torch.core.schedulers.fedcs import FedCSScheduler
from repro_torch.core.schedulers.genetic import GeneticScheduler
from repro_torch.core.schedulers.simulated_annealing import (
    SimulatedAnnealingScheduler)
from repro_torch.experiment.registry import SCHEDULERS

NOT_PORTED = ("bods", "dnn", "rlds")


def _not_ported(name: str):
    def factory(cost_model=None, seed: int = 0, **kwargs):
        raise NotImplementedError(
            f"scheduler {name!r} (with core/search.py) is ROADMAP module 5, "
            "not ported yet")

    factory.__name__ = f"{name}_not_ported"
    return factory


for _name in NOT_PORTED:
    SCHEDULERS.register(_name)(_not_ported(_name))


def get_scheduler(name: str, **kwargs) -> SchedulerBase:
    return SCHEDULERS.create(name, **kwargs)


def list_schedulers():
    return SCHEDULERS.names()


__all__ = [
    "SchedulerBase",
    "SchedulingContext",
    "SCHEDULERS",
    "get_scheduler",
    "list_schedulers",
    "RandomScheduler",
    "GreedyScheduler",
    "FedCSScheduler",
    "GeneticScheduler",
    "SimulatedAnnealingScheduler",
]
