"""``BENCHMARK.json`` and the files it names, resolved by name.

A cell ``<config>.<traffic>`` reads ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``limits/<cell>.json``; a per-layer metric
``<name>`` is read by ``metrics/<name>.py``'s ``read(run)``. The
configuration's ``kind`` picks the runner (``KINDS``): ``fl_loop`` (the
default, the multi-job FL loop, ``harness.py``) or ``lm_train`` (one LM
training step of the port in a closed loop, ``lm_harness.py``, whose
configuration names its plain reference, ``reference/<file>``). Adding a
configuration of either kind, a mix or a metric adds files and entries,
and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
#: a configuration's kind -> the module that runs its cells
KINDS = {"fl_loop": "portbench.harness", "lm_train": "portbench.lm_harness"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    base: Path = HERE


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest: Optional[dict] = None,
              base: Path = HERE) -> Cell:
    """The cell ``name`` of ``manifest`` (default: the checkout's
    ``BENCHMARK.json``), its files read from under ``base``."""
    if manifest is None:
        manifest = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; one of {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(base / "configs" / f"{w['config']}.json")
    if config.get("name") != w["config"] or w["config"] not in configs:
        raise ValueError(f"configuration file of {w['config']!r} names "
                         f"{config.get('name')!r}")
    kind(config)
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        traffic=load_json(base / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(base / "limits" / f"{name}.json"),
        end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, name)],
        base=base)


def load_module(path: Path, prefix: str = "portbench_file"):
    """The Python file ``path``, loaded by its path."""
    name = re.sub(r"[^A-Za-z0-9_]", "_", f"{prefix}_{path.stem}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod     # where its dataclasses look themselves up
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, base: Path = HERE) -> Callable:
    """``read`` of ``metrics/<metric>.py``."""
    return load_module(base / "metrics" / f"{metric}.py",
                       "portbench_metric").read


def kind(config: dict) -> str:
    """The configuration's kind (``fl_loop`` where it names none)."""
    k = config.get("kind", "fl_loop")
    if k not in KINDS:
        raise ValueError(f"configuration {config.get('name')!r}: unknown "
                         f"kind {k!r}; one of {sorted(KINDS)}")
    return k


def runner(cell: Cell):
    """The module that runs the cell's kind: its ``run(cell, seed,
    seconds, trace, process_start)`` and its ``NUMBERS``."""
    return importlib.import_module(KINDS[kind(cell.config)])
