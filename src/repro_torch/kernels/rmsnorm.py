"""RMSNorm: the CUDA kernel's wrapper and its plain version.

    y = x * rsqrt(mean(x^2, -1) + eps) * scale

x (..., d) in float32, bfloat16 or float16, scale (d,); the mean square
and the products in float32, y in x's dtype.

``rmsnorm`` launches ``csrc/rmsnorm.cu`` for CUDA tensors and counts each
call that launched in ``launches``; for CPU tensors it is ``rmsnorm_ref``,
the plain PyTorch version (``repro/kernels/ref.py::rmsnorm``). There is no
fallback: a CUDA tensor launches the kernel or raises. As in the
reference, no model calls it (``models/layers.py`` keeps its own
rmsnorm); ``ops.rmsnorm`` reaches it.
"""

from __future__ import annotations

import ctypes

import torch

#: Wrapper calls that launched the kernel since the last reset (one per
#: call; the plain version does not count).
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _entry():
    """The kernel's C entry point, built and typed at first use."""
    from repro_torch.kernels import build

    fn = build.load("rmsnorm").rmsnorm
    if fn.argtypes is None:  # ints would pass as 32-bit, cutting pointers
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., d), scale (d,) -> x's shape and dtype (see the module
    docstring). CUDA tensors launch the kernel; CPU tensors take
    ``rmsnorm_ref``."""
    global launches
    if x.dim() < 1 or tuple(scale.shape) != (x.shape[-1],):
        raise TypeError(f"scale must be ({x.shape[-1] if x.dim() else '?'},)"
                        f" for x {tuple(x.shape)}, got {tuple(scale.shape)}")
    if x.dtype not in DTYPES or not scale.is_floating_point():
        raise TypeError(f"x must be one of {list(DTYPES)} and scale a float "
                        f"tensor, got {x.dtype} and {scale.dtype}")
    if x.device != scale.device:
        raise ValueError(f"rmsnorm inputs on several devices: {x.device}, "
                         f"{scale.device}")
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm has no kernel for {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    sc = scale.float().contiguous()
    rc = _entry()(x.data_ptr(), sc.data_ptr(), out.data_ptr(),
                  DTYPES[x.dtype], rows, d, eps,
                  torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {rc} at "
                           f"(rows, d) = ({rows}, {d})")
    launches += 1
    return out
