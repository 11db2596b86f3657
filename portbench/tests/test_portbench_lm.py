"""The ``lm_train`` kind on the CPU: a cell made of files alone (a
configuration, a traffic mix, limits and the reference file, in a base of
its own), its run, its controls and faults, and the configuration checks.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import control, harness, lm_harness, manifest

TEST_ARCH = "qwen3-1.7b-portbench-test"
CELL = "tiny.lm"
#: Set from CPU readings at this size (qwen3-1.7b's ``reduced()``): the
#: program's worst over 18 seeds (1-12, 101-103 and the tests' own), then
#: the least that the float8 control or a fault read on 5 control seeds.
#: loss 3.9e-4 / 1.4e-3 (float8), gradient norm 6.4e-4 / 3.5e-3 (float8),
#: first gradient's leaves 1.9e-3 / 6.6e-3 (float8), change 2.3e-3 /
#: 7.6e-3 (half batch), the check step's loss 2.1e-4 / 1.8e-3 (half
#: batch) and change 3.3e-4 / 1.9e-3 (float8). The float8 control fails
#: four numbers on every seed; each fault fails one or more.
LIMITS = {"loss_gap": 8e-4, "grad_norm_gap": 1.5e-3, "grad1_gap": 3.5e-3,
          "update_gap": 5e-3, "window_loss_gap": 1e-3,
          "window_update_gap": 7e-4}
TRAFFIC = {"why": "a CPU test's size", "batch": 4, "seq_len": 32,
           "warmup_steps": 3, "check_steps": 2}


@pytest.fixture(scope="module")
def test_arch():
    """qwen3-1.7b's CPU smoke size, registered under a test id."""
    from repro_torch.config.registry import _REGISTRY, register_arch
    from repro_torch.configs import qwen3_1p7b

    register_arch(TEST_ARCH)(qwen3_1p7b.reduced)
    yield qwen3_1p7b.reduced()
    _REGISTRY.pop(TEST_ARCH, None)


def model_block(cfg) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def write_cell(base, model: dict, kind="lm_train", limits=None,
               traffic=None):
    """An lm_train cell's files under ``base``; returns its manifest."""
    for d in ("configs", "traffic", "limits", "reference"):
        (base / d).mkdir(parents=True, exist_ok=True)
    shutil.copy(manifest.HERE / "reference" / "lm_dense.py",
                base / "reference" / "lm_dense.py")
    config = {"name": "tiny", "kind": kind,
              "source": "https://huggingface.co/Qwen/Qwen3-1.7B",
              "arch": TEST_ARCH, "model": model,
              "deployment": {"chips_per_layer": 1, "held": "every layer"},
              "reduced_from": {}, "assumed": {},
              "optimizer": {"name": "adamw", "lr": 3e-4, "b1": 0.9,
                            "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
                            "grad_clip": 1.0},
              "microbatches": 2, "tf32": False, "reference": "lm_dense.py"}
    if kind is None:
        del config["kind"]
    (base / "configs" / "tiny.json").write_text(json.dumps(config))
    (base / "traffic" / "lm.json").write_text(json.dumps(traffic or TRAFFIC))
    (base / "limits" / f"{CELL}.json").write_text(
        json.dumps(limits or LIMITS))
    spec = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": "tiny", "source": config["source"],
                        "file": "portbench/configs/tiny.json",
                        "reduced": [], "why": "a CPU test"}]
    spec["workloads"] = [{"name": CELL, "config": "tiny", "traffic": "lm",
                          "chips": 1, "why": "a CPU test"}]
    spec["per_layer"] = []
    return spec


@pytest.fixture
def cell(tmp_path, test_arch):
    spec = write_cell(tmp_path, model_block(test_arch))
    return manifest.load_cell(CELL, spec, tmp_path)


def test_runs_from_files_alone_and_is_correct(cell):
    assert manifest.runner(cell) is lm_harness
    out = lm_harness.run(cell, 2 ** 31 + 5, 0.5, False, 0.0, device="cpu")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert out["metrics"]["train_samples_per_s"]["value"] > 0
    w = out["window"]
    assert w["steps"] == out["attempted"] >= 1 and out["failed"] == 0
    assert w["tokens"] == w["steps"] * 4 * 32
    assert w["flops"] == w["steps"] * w["flops_per_step"] > 0
    assert w["tokens_per_s"] == pytest.approx(
        out["metrics"]["train_samples_per_s"]["value"] * 32)
    assert set(out["checks"]) == set(LIMITS) <= set(lm_harness.NUMBERS)
    assert list(out)[-1] == "checks"


def test_seeds_give_the_same_inputs(cell):
    arch = lm_harness.reference(cell)
    a = lm_harness.Program(cell, arch, 7, "cpu")
    b = lm_harness.Program(cell, arch, 7, "cpu")
    c = lm_harness.Program(cell, arch, 8, "cpu")
    pa, pb, pc = (lm_harness.flat(p.params) for p in (a, b, c))
    assert all((pa[k] == pb[k]).all() for k in pa)
    assert not (pa["embed/embedding"] == pc["embed/embedding"]).all()
    assert (a.batch(3) == b.batch(3)).all()
    assert not (a.batch(3) == a.batch(4)).all()


@pytest.mark.parametrize("seed", [11, 2 ** 33 + 1])
def test_controls_and_faults_fail_a_limit(cell, seed):
    line = control.lm_line(cell, seed, "cpu", True)
    assert manifest.runner(cell).NUMBERS == lm_harness.NUMBERS
    from portbench import check

    assert check.verdict(line["program"], cell.limits), line["program"]
    for name in (control.LM_CONTROL, *control.LM_FAULTS):
        assert not check.verdict(line[name], cell.limits), (name, line[name])


@pytest.mark.parametrize("fault", sorted(control.LM_FAULTS))
def test_a_run_with_a_fault_is_not_correct(cell, fault):
    with control.LM_FAULTS[fault](cell.config["model"]):
        out = lm_harness.run(cell, 3, 0.3, False, 0.0, device="cpu")
    assert not out["correct"], out["checks"]


def test_a_differing_model_block_is_refused(tmp_path, test_arch):
    model = dict(model_block(test_arch), d_ff=256)
    cell = manifest.load_cell(CELL, write_cell(tmp_path, model), tmp_path)
    with pytest.raises(harness.Failed, match="d_ff"):
        lm_harness.run(cell, 1, 0.1, False, 0.0, device="cpu")


def test_an_unknown_kind_is_refused(tmp_path, test_arch):
    spec = write_cell(tmp_path, model_block(test_arch), kind="lm_serve")
    with pytest.raises(ValueError, match="lm_serve"):
        manifest.load_cell(CELL, spec, tmp_path)


def test_a_config_without_kind_runs_the_fl_loop(tmp_path, test_arch):
    spec = write_cell(tmp_path, model_block(test_arch), kind=None)
    cell = manifest.load_cell(CELL, spec, tmp_path)
    assert manifest.kind(cell.config) == "fl_loop"
    assert manifest.runner(cell) is harness
    fl = manifest.load_cell("group-a.paper")
    assert "kind" not in fl.config and manifest.runner(fl) is harness


def test_step_flops_counts_the_model():
    from portbench.reference import lm_dense

    m = dict(num_layers=1, d_model=4, d_ff=8, vocab_size=10, num_heads=2,
             num_kv_heads=1, head_dim=2, mlp_kind="swiglu")
    # per token: q 4x4, k and v 4x2 each, o 4x4, MLP 3 x 4x8; attention:
    # 2 heads x 2 products x D 2 x (S (S + 1) / 2) rows; head 4 x 10.
    B, S = 3, 5
    fwd = 2 * (B * S * (16 + 8 + 8 + 16 + 96) + 2 * 2 * 2 * 15 * B
               + B * (S - 1) * 40)
    assert lm_dense.step_flops(m, B, S) == 3 * fwd


def test_the_reference_imports_no_program_and_no_jax():
    code = ("import sys; sys.path[:0] = [%r]\n"
            "from portbench import manifest\n"
            "for f in ('lm_dense.py', 'lm_train.py'):\n"
            "    manifest.load_module(manifest.HERE / 'reference' / f)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'flax', 'repro', 'repro_torch')]\n"
            "print(bad)\n" % str(manifest.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
