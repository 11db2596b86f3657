"""Hand-written CUDA kernels of the port (``csrc/``), their wrappers and
plain PyTorch versions, and the ``ops`` dispatch.

``refuse_grad``: a kernel without a backward pass (the linear scan: the
reference's Pallas version has no VJP) raises ``NoKernelGradError`` when
asked to launch on inputs that need a gradient, instead of returning an
output that carries none. The MoE grouped matmul has a backward of its
own (``moe_gmm.py``).
"""

import torch


class NoKernelGradError(RuntimeError):
    """A kernel with no backward pass was launched on inputs that need a
    gradient."""


#: The kernels without a backward pass, and the reference functions they
#: replace (plain ``pallas_call``s, no VJP).
NO_GRAD_KERNELS = {"linear_scan": "repro/kernels/ssm_scan.py:75"}


def no_grad_error(name: str) -> NoKernelGradError:
    return NoKernelGradError(
        f"{name}: the kernel has no backward pass, as the reference's "
        f"({NO_GRAD_KERNELS[name]}) has no VJP, so its output would carry "
        "no gradient; training this family on the card takes impl=\"ref\" "
        "(ops.set_default_impl(\"ref\")), and inference runs the kernel "
        "under torch.no_grad()")


def refuse_grad(name: str, *inputs: torch.Tensor) -> None:
    """Raise ``no_grad_error(name)`` if grad mode is on and any of
    ``inputs`` requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise no_grad_error(name)
