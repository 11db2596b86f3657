"""How ``correct`` is decided: the run's cohorts and its training, held to
the plain reference (``portbench.reference``).

Cohorts (every round launched, the window's included): the engine's
guarantees (n_sel distinct devices, each free at launch) and Formulas 2-5
replayed from the seed (``reference.pool.replay_cohorts``), and, under
BODS, each plan's regret against the EI-best of the candidates that BODS
draws from the scheduler's seed on the history so far
(``reference.bods``).

Training (each job's rounds trained before the window, on the same
object the window then drives): the reference trains the same cohorts
from the same data and initial weights, and four numbers compare the two:
the worst relative gap of a round's held-out loss, the worst gap of its
accuracy, and, leaf by leaf, the gap between the norms of the change of
the parameters after the first round and after the last, against the
reference's norm of that leaf or of the median leaf, whichever is larger.
Leaves the reference's first round moves by under a thousandth of the
median leaf's change are left out of both.

The window's training (each job's last round trained in the window whose
record the window holds): from the program's parameters before that
round, the reference trains the same cohort once; two numbers compare the
two: the relative gap of the held-out loss, and, leaf by leaf, the gap
between the norms of the round's change, as above. This follows the
program from its own state; the warm-up's numbers check the start.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from portbench.reference import bods as ref_bods, cnn, data, \
    pool as ref_pool

NUMBERS = ("cohort_faults", "round_time_gap", "cost_gap", "est_cost_gap",
           "bods_regret", "loss_gap", "acc_gap", "update1_gap", "update_gap",
           "window_loss_gap", "window_update_gap")
STILL = 1e-3   # a leaf under this share of the median change is left out


@dataclasses.dataclass
class Trajectory:
    """One side's training of one job: parameters after the first round
    and after ``rounds``, and each round's held-out loss and accuracy."""

    rounds: int
    first: list
    last: list
    losses: Dict[int, float]
    accs: Dict[int, float]


def job_inputs(cfg: dict, traffic: dict, job: int, seeds: dict, device):
    """The job's data, eval set, partition and initial weights, made again
    from the seeds."""
    j = cfg["jobs"][job]
    x, y = data.dataset(cfg["samples_per_job"], j["input_shape"],
                        j["num_classes"], cfg["noise"], seeds["data"] + job)
    ex, ey = data.dataset(cfg["eval_samples"], j["input_shape"],
                          j["num_classes"], cfg["noise"],
                          seeds["data"] + 100 + job)
    part = data.noniid_partition(y, traffic["num_devices"],
                                 traffic["classes_per_device"],
                                 traffic["parts_per_class"],
                                 seeds["data"] + job)
    p0 = cnn.init_params(j["cnn_spec"], j["input_shape"], j["num_classes"],
                         seeds["init"] + job, device)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return (t(x, torch.float32), t(y, torch.int64), part,
            t(ex, torch.float32), t(ey, torch.int64), p0)


def follow(cfg: dict, job: int, inputs, cohorts: Sequence[np.ndarray],
           net: cnn.Net, aggregate: Callable = cnn.fedavg) -> Trajectory:
    """Train ``cohorts`` (one id array a round) from the initial weights."""
    j = cfg["jobs"][job]
    x, y, part, ex, ey, p = inputs
    dev = x.device
    first, losses, accs = None, {}, {}
    for r, ids in enumerate(cohorts):
        idx = torch.as_tensor(part[np.asarray(ids)], device=dev)
        stacked = net.local_sgd(p, x[idx], y[idx], j["local_epochs"],
                                j["batch_size"], j["lr"])
        sizes = torch.full((len(ids),), float(part.shape[1]), device=dev)
        p = aggregate(stacked, sizes)
        del stacked
        losses[r], accs[r] = net.evaluate(p, ex, ey)
        if r == 0:
            first = [t.cpu() for t in cnn.leaves(p)]
    return Trajectory(len(cohorts), first, [t.cpu() for t in cnn.leaves(p)],
                      losses, accs)


def _norms(params: List[torch.Tensor], p0: List[torch.Tensor]) -> np.ndarray:
    return np.array([float(torch.linalg.vector_norm(
        a.double() - b.double())) for a, b in zip(params, p0)])


def _leaf_gap(a: np.ndarray, ref: np.ndarray, keep: np.ndarray) -> float:
    floor = np.maximum(ref, np.median(ref))
    gaps = np.abs(a - ref) / floor
    gaps = np.where(np.isfinite(a), gaps, np.inf)[keep]
    return float(gaps.max()) if gaps.size else 0.0


def training_numbers(side: Trajectory, ref: Trajectory, p0) -> Dict[str, float]:
    """The four training numbers of one job: ``side`` against ``ref``."""
    p0 = [t.cpu() for t in cnn.leaves(p0)]
    r1 = _norms(ref.first, p0)
    keep = r1 >= STILL * np.median(r1)
    out = dict(update1_gap=_leaf_gap(_norms(side.first, p0), r1, keep),
               update_gap=_leaf_gap(_norms(side.last, p0),
                                    _norms(ref.last, p0), keep),
               loss_gap=0.0, acc_gap=0.0)
    for r, loss in side.losses.items():
        if r in ref.losses:
            out["loss_gap"] = max(out["loss_gap"],
                                  ref_pool.rel_gap(loss, ref.losses[r]))
            gap = abs(side.accs[r] - ref.accs[r])
            out["acc_gap"] = max(out["acc_gap"],
                                 gap if np.isfinite(gap) else np.inf)
    return out


def one_round(cfg: dict, job: int, inputs, ids: np.ndarray, start,
              net: cnn.Net, aggregate: Callable = cnn.fedavg):
    """Train one round of cohort ``ids`` from the parameters ``start``:
    (the parameters after it, its held-out loss)."""
    j = cfg["jobs"][job]
    x, y, part, ex, ey, _ = inputs
    dev = x.device
    p = cnn.to_device(start, dev)
    idx = torch.as_tensor(part[np.asarray(ids)], device=dev)
    stacked = net.local_sgd(p, x[idx], y[idx], j["local_epochs"],
                            j["batch_size"], j["lr"])
    sizes = torch.full((len(ids),), float(part.shape[1]), device=dev)
    p = aggregate(stacked, sizes)
    del stacked
    loss, _ = net.evaluate(p, ex, ey)
    return [t.cpu() for t in cnn.leaves(p)], loss


def round_numbers(before, after, loss: float, ref_after,
                  ref_loss: float) -> Dict[str, float]:
    """The window round's two numbers: ``after``/``loss`` (one side) against
    ``ref_after``/``ref_loss`` (the reference), both from ``before``."""
    before = [t.cpu() for t in cnn.leaves(before)]
    r = _norms(ref_after, before)
    keep = r >= STILL * np.median(r)
    return dict(window_update_gap=_leaf_gap(
                    _norms([t.cpu() for t in cnn.leaves(after)], before),
                    r, keep),
                window_loss_gap=ref_pool.rel_gap(loss, ref_loss))


def program_trajectory(snapshots: Dict[int, object], records: Dict,
                       job: int) -> Trajectory:
    """The program's side of one job: its host copies after the first round
    and after the last round trained before the window, and the held-out
    metrics its records carry for those rounds."""
    rounds = max(snapshots)
    recs = {r: records[(job, r)] for r in range(rounds)
            if (job, r) in records}
    return Trajectory(rounds, cnn.leaves(snapshots[1]),
                      cnn.leaves(snapshots[rounds]),
                      {r: v["loss"] for r, v in recs.items()},
                      {r: v["accuracy"] for r, v in recs.items()})


def worst(numbers: List[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for d in numbers:
        for k, v in d.items():
            v = float(v) if np.isfinite(v) else float("inf")
            out[k] = max(out.get(k, 0.0), v)
    return out


def cohort_numbers(cfg: dict, traffic: dict, seeds: dict, launches,
                   records: Dict) -> Dict[str, float]:
    K, M = traffic["num_devices"], len(cfg["jobs"])
    pool = ref_pool.Pool.heterogeneous(
        K, M, seeds["pool"], traffic["pool"]["a_range"],
        traffic["pool"]["mu_range"], traffic["pool"]["data_range"])
    return ref_pool.replay_cohorts(
        pool, launches, records, [j["local_epochs"] for j in cfg["jobs"]],
        traffic["n_sel"], traffic["alpha"], traffic["beta"],
        ref_bods.settings_of(traffic), seeds["scheduler"])


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(name in numbers and np.isfinite(numbers[name])
               and numbers[name] <= limits[name] for name in limits)
