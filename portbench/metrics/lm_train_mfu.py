"""The LM training step's share of the card's peak: the matmul FLOPs of
the steps trained in the traced window, as the model needs them (the
reference file's ``step_flops``: no recomputation, routed experts at their
expected picks), over the window's host-clock seconds, against the H100
SXM's 989 TFLOP/s dense bfloat16 (%)."""


def read(run):
    if not getattr(run, "flops", None) or not run.window_s:
        return None
    return 100.0 * run.flops / run.window_s / run.peak_flops
