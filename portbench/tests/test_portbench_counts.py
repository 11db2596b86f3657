"""The sample counter against the runtime's batching rule, the partition
width against the program's partitioner, and the probe's reading of the
runtime's flushes."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.probe import RuntimeProbe
from portbench.reference import data


@pytest.mark.parametrize("width", [1, 9, 10, 29, 30, 31, 184, 480, 500, 509])
@pytest.mark.parametrize("batch_size", [10, 30, 64])
def test_split_batches_rule(width, batch_size):
    from repro_torch.fl.runtime import _split_batches

    x = torch.zeros(2, width, 1)
    y = torch.zeros(2, width, dtype=torch.int64)
    xb, _, steps = _split_batches(x, y, batch_size, axis=1)
    assert data.split_batches(width, batch_size) == (steps, xb.shape[2])


@pytest.mark.parametrize("classes,ppc", [(10, 20), (26, 20), (10, 5)])
def test_partition_width_and_indices_match_the_program(classes, ppc):
    from repro_torch.data.synthetic import make_classification_dataset
    from repro_torch.fl.partition import noniid_partition

    x, y = make_classification_dataset(3000, (4, 4, 1), classes, seed=11)
    rx, ry = data.dataset(3000, (4, 4, 1), classes, 1.0, 11)
    assert np.array_equal(x, rx) and np.array_equal(y, ry)
    assert np.array_equal(data.labels(3000, classes, 11), y)
    part = noniid_partition(y, 30, 2, ppc, seed=5)
    assert np.array_equal(data.noniid_partition(y, 30, 2, ppc, 5), part)
    assert data.partition_width(y, 2, ppc) == part.shape[1]


def test_geometry_counts_samples_as_the_runtime_trains(tiny_cell):
    seeds = harness.sub_seeds(3, tiny_cell)
    for m, g in enumerate(harness.geometry(tiny_cell, seeds)):
        job = tiny_cell.config["jobs"][m]
        y = data.labels(tiny_cell.config["samples_per_job"],
                        job["num_classes"], seeds["data"] + m)
        width = data.noniid_partition(
            y, 12, 2, tiny_cell.traffic["parts_per_class"],
            seeds["data"] + m).shape[1]
        steps = max(width // min(job["batch_size"], width), 1)
        batch = min(job["batch_size"], width)
        assert (g.width, g.steps, g.batch) == (width, steps, batch)
        assert g.samples_per_device == steps * batch * job["local_epochs"]


class _Runtime:
    """Trains on the first demand of an untrained round, as the runtime:
    the flush takes the queue of announced rounds and leaves a new one."""

    def __init__(self, in_place=False):
        self._queued, self.results, self.flushes = {}, set(), []
        self.in_place = in_place

    def begin_round(self, job, ids, r):
        self._queued[job] = (ids, r)

    def run_round(self, job, ids, r):
        if (job, r) not in self.results:
            self._queued[job] = (ids, r)
            flushed = sorted((j, q[1]) for j, q in self._queued.items())
            self.flushes.append(flushed)
            self.results |= set(flushed)
            if self.in_place:
                self._queued.clear()
            else:
                self._queued = {}
        self.results.discard((job, r))
        return {"loss": 0.0, "accuracy": 0.0}

    def params_of(self, job):
        return [{"w": torch.full((2,), float(len(self.flushes)))}]


class _Record:
    def __init__(self, job, round_idx):
        self.job, self.round_idx = job, round_idx


def _drive(probe):
    ids = np.arange(4)
    for j in range(3):
        probe.begin_round(j, ids, 0)
    probe.run_round(1, ids, 0)          # trains all three
    probe.begin_round(1, ids, 1)
    probe.run_round(0, ids, 0)          # cached
    probe.begin_round(0, ids, 1)
    probe.run_round(1, ids, 1)          # trains 1 and 0
    return [_Record(0, 0), _Record(1, 0), _Record(1, 1)]


def test_probe_reads_the_runtime_flushes():
    from portbench.probe import JobGeometry

    geo = [JobGeometry(10, 2, 5, 1, 1, 1, 1)] * 3
    rt = _Runtime()
    probe = RuntimeProbe(rt, geo)
    probe.counting = probe.keeping_pairs = True
    probe.mark = lambda: 0.0
    probe.check_flushed(_drive(probe))
    assert len(probe.count.flushes) == len(rt.flushes) == 2
    assert probe.count.rounds == 5
    assert probe.count.samples == 5 * 4 * geo[0].samples_per_device
    assert [n for _, n in probe.count.flushes] == [
        3 * 4 * geo[0].samples_per_device, 2 * 4 * geo[0].samples_per_device]
    assert probe.trained == [2, 2, 1]
    assert [(j, r) for j, r, _ in probe.launches] == [
        (0, 0), (1, 0), (2, 0), (1, 1), (0, 1)]
    # Each job's parameters before and after the flush of each round.
    assert sorted(probe.pairs[0]) == [0, 1]
    before, after = probe.pairs[0][1]
    assert before[0]["w"][0] == 1 and after[0]["w"][0] == 2


def test_probe_stops_where_it_cannot_read_the_flushes():
    from portbench.probe import JobGeometry

    probe = RuntimeProbe(_Runtime(in_place=True),
                         [JobGeometry(10, 2, 5, 1, 1, 1, 1)] * 3)
    records = _drive(probe)
    with pytest.raises(RuntimeError, match="recorded without a flush"):
        probe.check_flushed(records)


@pytest.mark.parametrize("seconds,expected", [
    (0.5, 5.0),            # inside the first flush: its share
    (1.0, 10.0),           # a flush that ends on the instant counts whole
    (3.0, 10 + 20 + 20.0),  # half of the third flush's span (2 to 4)
    (9.0, 70.0)])           # every flush ended before the instant
def test_samples_in_the_window(seconds, expected):
    assert harness.samples_in([1.0, 2.0, 4.0], [10, 20, 40], seconds) \
        == pytest.approx(expected)


def test_every_seed_gets_the_nominal_sizes(tiny_cell):
    nominal = harness._steps(tiny_cell, harness._draw(0, 0))
    seen = set()
    for seed in (1, 2 ** 31 + 5, 2 ** 33 + 11, 4294967798):
        seeds = harness.sub_seeds(seed, tiny_cell)
        assert harness._steps(tiny_cell, seeds["data"]) == nominal
        assert seeds == harness.sub_seeds(seed, tiny_cell)
        seen.add(seeds["data"])
    assert len(seen) == 4
