"""MoE grouped matmul: the CUDA kernel's wrapper and its plain version.

    out[e] = xg[e] @ wg[e]

xg (E, C, din) bucketed tokens, wg (E, din, dout) expert weights ->
(E, C, dout), accumulated in float32, the output in the inputs' dtype
(float32 or bfloat16).

``moe_gmm`` launches ``csrc/moe_gmm.cu`` for CUDA tensors and counts each
call that launched in ``launches`` and, by the variant ``kernel_variant``
names, in ``launches_by_variant``; for CPU tensors it is ``moe_gmm_ref``,
the plain PyTorch version (the reference oracle's einsum). There is no
fallback: a CUDA tensor launches the named variant or raises. The kernel
has no backward pass (the reference's has no VJP): on CUDA inputs that
need a gradient, with grad mode on, ``moe_gmm`` raises
``NoKernelGradError``; the CPU's plain path stays differentiable.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import refuse_grad

#: Wrapper calls that launched the kernel since the last reset (one per
#: call; the plain version does not count).
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The kernel's variants, by the number the C entry takes.
VARIANTS = ("simt", "mma", "wgmma")
#: The same launches split by variant.
launches_by_variant = dict.fromkeys(VARIANTS, 0)


def kernel_variant(dtype: torch.dtype, E: int, C: int, din: int,
                   dout: int) -> str:
    """The variant of ``csrc/moe_gmm.cu`` that serves this call:
    ``"simt"`` for float32; for bfloat16 ``"wgmma"`` (TMA and wgmma) where
    din and dout are positive multiples of 8 (TMA needs 16-byte strides),
    else ``"mma"`` (mma.sync). Any C: at decode's few rows the wgmma
    variant also beats mma.sync (``chip_smoke.py`` times both)."""
    if dtype != torch.bfloat16:
        return "simt"
    if din <= 0 or din % 8 or dout % 8:
        return "mma"
    return "wgmma"


def moe_gmm_ref(xg: torch.Tensor, wg: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (``repro/kernels/ref.py::moe_gmm``)."""
    return torch.einsum("ecd,edf->ecf", xg, wg)


def _check(xg, wg):
    if xg.dim() != 3 or wg.dim() != 3:
        raise TypeError(f"xg must be (E, C, din) and wg (E, din, dout), got "
                        f"{tuple(xg.shape)} and {tuple(wg.shape)}")
    if wg.shape[0] != xg.shape[0] or wg.shape[1] != xg.shape[2]:
        raise TypeError(f"wg {tuple(wg.shape)} does not match xg "
                        f"{tuple(xg.shape)}")
    if xg.dtype not in DTYPES or wg.dtype != xg.dtype:
        raise TypeError(f"xg and wg must share one of {list(DTYPES)}, got "
                        f"{xg.dtype} and {wg.dtype}")
    if xg.device != wg.device:
        raise ValueError(f"moe_gmm inputs on several devices: {xg.device}, "
                         f"{wg.device}")


def _entry():
    """The kernel's C entry point, built and typed at first use."""
    from repro_torch.kernels import build

    fn = build.load("moe_gmm").moe_gmm
    if fn.argtypes is None:  # ints would pass as 32-bit, cutting pointers
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def moe_gmm(xg: torch.Tensor, wg: torch.Tensor) -> torch.Tensor:
    """xg (E, C, din), wg (E, din, dout) -> (E, C, dout) (see the module
    docstring). CUDA tensors launch the kernel; CPU tensors take
    ``moe_gmm_ref``."""
    global launches
    _check(xg, wg)
    if xg.device.type == "cpu":
        return moe_gmm_ref(xg, wg)
    if xg.device.type != "cuda":
        raise ValueError(f"moe_gmm has no kernel for {xg.device}")
    refuse_grad("moe_gmm", xg, wg)
    for name, t in (("xg", xg), ("wg", wg)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    E, C, din = xg.shape
    dout = wg.shape[2]
    out = torch.empty((E, C, dout), dtype=xg.dtype, device=xg.device)
    if out.numel() == 0:
        return out
    variant = kernel_variant(xg.dtype, E, C, din, dout)
    stream = torch.cuda.current_stream(xg.device).cuda_stream
    rc = _entry()(xg.data_ptr(), wg.data_ptr(), out.data_ptr(),
                  DTYPES[xg.dtype], VARIANTS.index(variant), E, C, din, dout,
                  stream)
    if rc != 0:
        raise RuntimeError(f"moe_gmm kernel ({variant}) launch failed: CUDA "
                           f"error {rc} at (E, C, din, dout) = "
                           f"({E}, {C}, {din}, {dout})")
    launches += 1
    launches_by_variant[variant] += 1
    return out
