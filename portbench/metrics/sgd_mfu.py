"""The whole step's share of the card's peak: the matmul FLOPs of the
rounds flushed in the traced window (forward, weight and input gradients
of local SGD, and the held-out forward; ``portbench/flops.py``) over the
window, against the H100 SXM's 67 TFLOP/s in float32 outside the tensor
cores (TF32 is off) (%)."""


def read(run):
    if not run.device_ops or not run.count.flops:
        return None
    return 100.0 * run.count.flops / run.window_s / run.peak_flops
