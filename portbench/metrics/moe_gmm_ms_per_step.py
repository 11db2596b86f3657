"""Kernel 2.5's device time a step of the LM step: the device seconds of
the grouped matmul's kernels (forward, recomputed forward and backward) in
the traced window over the steps trained there (ms). Reads nothing where
the trace holds no such kernel."""

import re

KERNEL = re.compile(r"gmm_(wgmma|mma|f32)_kernel")


def read(run):
    sec = sum(op.end_ns - op.start_ns for op in run.device_ops or ()
              if KERNEL.search(op.name)) / 1e9
    if not sec or not run.steps:
        return None
    return 1e3 * sec / run.steps
