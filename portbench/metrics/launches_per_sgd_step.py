"""Kernels launched a local SGD step: the device kernels in the profiled
window (copies and fills left out) over the vmapped SGD steps that the
rounds flushed in the window trained."""


def read(run):
    if not run.device_ops or not run.count.sgd_steps:
        return None
    kernels = sum(1 for op in run.device_ops if op.is_kernel)
    return kernels / run.count.sgd_steps
