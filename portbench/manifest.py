"""``BENCHMARK.json`` and the files it names, resolved by name.

A cell ``<config>.<traffic>`` reads ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``limits/<cell>.json``; a per-layer metric
``<name>`` is read by ``metrics/<name>.py``'s ``read(run)``. Adding a
configuration, a mix or a metric adds files and entries, and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


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
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        traffic=load_json(base / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(base / "limits" / f"{name}.json"),
        end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, name)],
        base=base)


def reader(metric: str, base: Path = HERE) -> Callable:
    """``read`` of ``metrics/<metric>.py``."""
    path = base / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
