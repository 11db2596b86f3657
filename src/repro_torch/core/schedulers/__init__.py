"""Device schedulers for multi-job FL.

Paper methods: BODS (Bayesian optimization), RLDS (reinforcement learning).
Paper baselines: Random, FedCS, Greedy, Genetic (+ appendix: SimulatedAnnealing,
DNN).

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
from repro_torch.core.schedulers.bods import BODSScheduler
from repro_torch.core.schedulers.dnn import DNNScheduler
from repro_torch.core.schedulers.rlds import RLDSScheduler
from repro_torch.experiment.registry import SCHEDULERS


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
    "BODSScheduler",
    "DNNScheduler",
    "RLDSScheduler",
]
