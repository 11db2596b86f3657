"""Shared set-up of the benchmark's CPU tests: the checkout's root and the
program's sources on the path, and a cell cut to a size the CPU runs in
seconds."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def shrink(cell, **traffic):
    """The cell at a CPU test's size: fewer samples, devices and epochs;
    every width, batch and learning rate as configured."""
    cell = copy.deepcopy(cell)
    cell.config["samples_per_job"] = 600
    cell.config["eval_samples"] = 60
    for job in cell.config["jobs"]:
        job["local_epochs"] = 1
    cell.traffic.update(num_devices=12, n_sel=3, parts_per_class=5,
                        check_rounds=2, **traffic)
    return cell


@pytest.fixture(autouse=True)
def few_threads():
    """Several test workers share the machine's cores."""
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def tiny_cell():
    from portbench import manifest

    return shrink(manifest.load_cell("group-b.cohort100"))
