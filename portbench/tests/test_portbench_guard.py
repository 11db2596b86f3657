"""The import guard, and a run without the program's sources."""

import os
import shutil
import subprocess
import sys

from portbench import guard, manifest


def test_top_level_names_are_compared_whole():
    found = guard.forbidden_loaded(["repro", "repro.core", "repro_torch",
                                    "repro_torch.fl", "jax.numpy", "jaxlib",
                                    "flax.linen", "jaxtyping", "reprox"])
    assert found == ["flax.linen", "jax.numpy", "jaxlib", "repro",
                     "repro.core"]


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import portbench.harness, portbench.control, portbench.check\n"
            "import portbench.lm_harness, portbench.reference.lm_train\n"
            "import repro_torch.experiment, repro_torch.fl.runtime\n"
            "import repro_torch.launch.steps, repro_torch.models.transformer\n"
            "from portbench import manifest\n"
            "manifest.load_module(manifest.HERE / 'reference' / 'lm_dense.py')\n"
            "from portbench import guard\n"
            "print(guard.forbidden_loaded())\n"
            % (str(manifest.ROOT), str(manifest.ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_exits_non_zero_without_the_program(tmp_path):
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "group-a.paper",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
