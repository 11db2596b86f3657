"""RMSNorm: the CUDA kernel's wrapper and its plain version.

    y = x * rsqrt(mean(x^2, -1) + eps) * scale

x (..., d) in float32, bfloat16 or float16, scale (d,); the mean square
and the products in float32, y in x's dtype.

``rmsnorm`` launches ``csrc/rmsnorm.cu`` for CUDA tensors and counts each
call that launched in ``launches`` and, by the variant ``kernel_variant``
names, in ``launches_by_variant``; for CPU tensors it is ``rmsnorm_ref``,
the plain PyTorch version (``repro/kernels/ref.py::rmsnorm``). There is no
fallback: a CUDA tensor launches the named variant or raises. As in the
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
#: The kernel's variants, by the number the C entry takes.
VARIANTS = ("warp", "resident")
#: The same launches split by variant.
launches_by_variant = dict.fromkeys(VARIANTS, 0)
#: 16-byte vectors of a row the resident variant keeps in registers (2 a
#: thread, 1024 threads): d <= 16384 in bf16 and f16, 8192 in float32.
MAX_VECS = 2048


def vector_width(dtype: torch.dtype) -> int:
    """Elements of ``dtype`` in one 16-byte vector."""
    return 128 // torch.finfo(dtype).bits


def max_resident_d(dtype: torch.dtype) -> int:
    """The widest row the resident variant serves in ``dtype``."""
    return MAX_VECS * vector_width(dtype)


def kernel_variant(dtype: torch.dtype, rows: int, d: int) -> str:
    """The variant of ``csrc/rmsnorm.cu`` that serves this call:
    ``"resident"`` (each row read once and held in registers, the scale
    loaded once per thread, a persistent grid) where d splits into 16-byte
    vectors and is at most ``max_resident_d(dtype)``, ``"warp"`` (one warp
    a row, the row read twice) otherwise. Every row count is served by
    both, so ``rows`` does not enter the rule."""
    vec = vector_width(dtype)
    return "resident" if d % vec == 0 and 0 < d // vec <= MAX_VECS \
        else "warp"


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
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p]
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
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    sc = scale.float().contiguous()
    if sc.data_ptr() % 16:
        sc = sc.clone()
    d = x.shape[-1]
    variant = kernel_variant(x.dtype, x.numel() // d, d)
    launch_variant(variant, x, sc, out, eps)
    launches += 1
    launches_by_variant[variant] += 1
    return out


def launch_variant(variant: str, x: torch.Tensor, scale: torch.Tensor,
                   out: torch.Tensor, eps: float = 1e-6) -> None:
    """One launch of ``variant`` through the C entry on checked CUDA
    inputs (``scale`` float32, contiguous and 16-byte aligned); counts
    nothing (``rmsnorm`` does)."""
    d = x.shape[-1]
    rows = x.numel() // d
    rc = _entry()(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                  DTYPES[x.dtype], VARIANTS.index(variant), rows, d, eps,
                  torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel ({variant}) launch failed: CUDA "
                           f"error {rc} at (rows, d) = ({rows}, {d})")
