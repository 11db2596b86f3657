"""The share of the window in which no operation ran on the device: one
less the union of the profiler's device intervals over the window (%)."""


def read(run):
    if run.busy_s is None or not run.device_ops:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
