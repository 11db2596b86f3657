"""``BENCHMARK.json`` against the contract's shapes, names and units, and
every file it names."""

import json
import re

import pytest

from portbench import manifest

ROOT = manifest.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
LINE = re.compile(r"^[^\n\t]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(SPEC["command"]) <= 32
    assert all(LINE.match(w) for w in SPEC["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[key]:
            yield key, entry


@pytest.mark.parametrize("key,entry", list(_names()),
                         ids=lambda v: v if isinstance(v, str)
                         else v.get("name"))
def test_entry_names_units_and_keys(key, entry):
    assert manifest.NAME.match(entry["name"])
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source",
                              "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves", "workloads"}}[key]
    assert set(entry) <= allowed
    if key in ("end_to_end", "per_layer"):
        assert manifest.UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    if key == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0 < entry["bound"] <= 0.25
    if key == "per_layer":
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        assert LINE.match(entry["layer"])
        assert entry["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert (manifest.HERE / "metrics" / f"{entry['name']}.py").is_file()
    if key == "configs":
        assert LINE.match(entry["source"]) and LINE.match(entry["why"])
        assert entry["file"].startswith(SPEC["paths"][0] + "/")
        cfg = json.loads((ROOT / entry["file"]).read_text())
        assert cfg["name"] == entry["name"]
        assert len(entry["reduced"]) <= 16
        for k in entry["reduced"]:
            assert manifest.NAME.match(k) and k in cfg
            assert k in cfg["reduced_from"]
    if key == "workloads":
        assert LINE.match(entry["why"]) and entry["chips"] in (1, 4)
        assert manifest.NAME.match(entry["config"])
        assert manifest.NAME.match(entry["traffic"])


def test_names_are_unique_and_every_config_used():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(cell):
    c = manifest.load_cell(cell)
    assert set(c.limits) <= set(manifest.runner(c).NUMBERS)
    assert {"setup_s"} < {m["name"] for m in c.end_to_end}
    assert c.per_layer
    for m in c.per_layer:
        assert callable(manifest.reader(m["name"]))
