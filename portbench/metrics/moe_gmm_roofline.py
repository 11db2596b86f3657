"""Kernel 2.5's share of its roofline in the trinity-mini LM step: the
expert products' FLOPs a step (``reference/lm_afmoe.py``'s
``expert_flops`` for ``configs/trinity-mini.json``'s model: the held
experts' picks at their expectation, forward, again where blocks are
recomputed, and the input and weight gradients; bucket padding left out)
times the traced window's steps, over the device seconds of kernel 2.5's
kernels in the window, against the H100 SXM's 989 TFLOP/s dense bfloat16
(%). Reads nothing where the trace holds no such kernel.

The run carries no model, so the reader counts trinity-mini's experts and
raises for a run whose step FLOPs (``RunData.flops``) are not that model's
at the run's shape: another cell needs its own count. The held picks
stray from their expectation by up to the reference's ``HELD_BAND``
(beyond it the reference refuses the run)."""

import re
from pathlib import Path

from portbench import manifest

BASE = Path(__file__).resolve().parents[1]
KERNEL = re.compile(r"gmm_(wgmma|mma|f32)_kernel")


def gmm_seconds(run) -> float:
    return sum(op.end_ns - op.start_ns for op in run.device_ops or ()
               if KERNEL.search(op.name)) / 1e9


def read(run):
    sec = gmm_seconds(run)
    if not sec or not run.steps:
        return None
    model = manifest.load_json(BASE / "configs" / "trinity-mini.json")["model"]
    arch = manifest.load_module(BASE / "reference" / "lm_afmoe.py")
    batch = run.sequences // run.steps
    seq_len = run.tokens // run.sequences
    if run.flops != run.steps * int(arch.step_flops(model, batch, seq_len)):
        raise ValueError(
            f"moe_gmm_roofline counts {model['name']}'s expert FLOPs; this "
            f"run's step ({run.flops // run.steps} FLOPs at {batch} x "
            f"{seq_len}) is another model's")
    flops = arch.expert_flops(model, batch, seq_len)
    return 100.0 * flops * run.steps / sec / run.peak_flops
