"""MoE grouped matmul: the CUDA kernel's wrapper and its plain version.

    out[e] = xg[e] @ wg[e]

xg (E, C, din) bucketed tokens, wg (E, din, dout) expert weights ->
(E, C, dout), accumulated in float32, the output in the inputs' dtype
(float32 or bfloat16).

``moe_gmm`` launches ``csrc/moe_gmm.cu`` for CUDA tensors and counts each
call that launched in ``launches`` and, by the variant ``kernel_variant``
names, in ``launches_by_variant``; for CPU tensors it is ``moe_gmm_ref``,
the plain PyTorch version (the reference oracle's einsum). There is no
fallback: a CUDA tensor launches the named variant or raises.

``moe_gmm`` is differentiable (the reference's kernel has no VJP; this
backward is the port's own): an ``autograd.Function`` whose backward runs
the same product twice on contiguous transposed operands,

    dxg[e] = dout[e] @ wg[e]^T        (E, C, dout) x (E, dout, din)
    dwg[e] = xg[e]^T @ dout[e]        (E, din, C) x (E, C, dout)

launching the kernel on the card (each launch counted as above, and in
``backward_launches``) and the plain version on the CPU. The weight
product contracts over C, so the wgmma variant serves it where C is a
multiple of 8.

``moe_gmm_grouped`` is the grouped form that dropless routing uses: x (R,
din) holds expert e's rows in one segment [offsets[e], offsets[e + 1]),
each a multiple of ``GROUP_ROWS`` (zero rows pad it), and

    out[r] = x[r] @ wg[e(r)]        (R, dout), no padding to the largest

launched as one call of ``csrc/moe_gmm.cu``'s grouped rows form over R /
``GROUP_ROWS`` row tiles (each tile's expert from ``tile_expert``, on the
device); its backward launches the rows form on ``wg``'s transpose for the
input gradient and the contraction form, each expert over its own segment,
for the weight gradient. ``grouped_variant`` names the variant: wgmma in
bfloat16, simt in float32. The CPU takes ``moe_gmm_grouped_ref``.
"""

from __future__ import annotations

import ctypes

import torch

#: Launches of the kernel since the last reset (one a forward call, two a
#: backward; the plain version does not count).
launches = 0
#: The backward's share of ``launches``.
backward_launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The kernel's variants, by the number the C entry takes.
VARIANTS = ("simt", "mma", "wgmma")
#: The same launches split by variant.
launches_by_variant = dict.fromkeys(VARIANTS, 0)
#: A grouped segment's rows are a multiple of this (the kernel's row tile).
GROUP_ROWS = 128
#: The grouped form's C entry takes these modes.
ROWS, CONTRACTION = 1, 2


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


def _entry(name: str = "moe_gmm"):
    """A C entry point of the kernel (``moe_gmm`` or ``moe_gmm_grouped``),
    built and typed at first use."""
    from repro_torch.kernels import build

    fn = getattr(build.load("moe_gmm"), name)
    if fn.argtypes is None:  # ints would pass as 32-bit, cutting pointers
        ints = 6 if name == "moe_gmm" else 7
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * ints + [
            ctypes.c_void_p] * (1 if name == "moe_gmm" else 2)
        fn.restype = ctypes.c_int
    return fn


def moe_gmm(xg: torch.Tensor, wg: torch.Tensor) -> torch.Tensor:
    """xg (E, C, din), wg (E, din, dout) -> (E, C, dout) (see the module
    docstring); differentiable. CUDA tensors launch the kernel; CPU
    tensors take ``moe_gmm_ref``."""
    _check(xg, wg)
    if xg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"moe_gmm has no kernel for {xg.device}")
    if torch.is_grad_enabled() and (xg.requires_grad or wg.requires_grad):
        return _Matmul.apply(xg, wg)
    return _product(xg, wg)


class _Matmul(torch.autograd.Function):
    """``_product`` forward; backward, ``_product`` on the transposes."""

    @staticmethod
    def forward(ctx, xg, wg):
        ctx.save_for_backward(xg, wg)
        return _product(xg, wg)

    @staticmethod
    def backward(ctx, grad):
        global backward_launches
        xg, wg = ctx.saved_tensors
        grad = grad.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _product(grad, wg.transpose(1, 2).contiguous())
        if ctx.needs_input_grad[1]:
            dw = _product(xg.transpose(1, 2).contiguous(), grad)
        if grad.device.type == "cuda":
            backward_launches += (dx is not None) + (dw is not None)
        return dx, dw


def _product(xg: torch.Tensor, wg: torch.Tensor) -> torch.Tensor:
    """One product: the kernel for CUDA tensors (counted), the plain
    version for CPU ones."""
    global launches
    if xg.device.type == "cpu":
        return moe_gmm_ref(xg, wg)
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


def grouped_variant(dtype: torch.dtype, din: int, dout: int) -> str:
    """The variant of the grouped form: ``"wgmma"`` for bfloat16 (din and
    dout multiples of 8), ``"simt"`` for float32; no other call is
    taken."""
    if dtype == torch.float32:
        return "simt"
    if dtype == torch.bfloat16 and din > 0 and din % 8 == 0 and dout % 8 == 0:
        return "wgmma"
    raise ValueError(f"the grouped form takes float32, or bfloat16 with din "
                     f"and dout multiples of 8; got {dtype}, {din}, {dout}")


def moe_gmm_grouped_ref(x: torch.Tensor, wg: torch.Tensor,
                        offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of the grouped form: each segment times its expert's
    weights."""
    o = offsets.tolist()
    out = x.new_zeros((x.shape[0], wg.shape[2]))
    for e in range(wg.shape[0]):
        if o[e + 1] > o[e]:
            out[o[e]:o[e + 1]] = x[o[e]:o[e + 1]] @ wg[e]
    return out


def _contract_ref(a: torch.Tensor, b: torch.Tensor,
                  offsets: torch.Tensor) -> torch.Tensor:
    """out[e] = a[:, segment e] @ b[segment e]: the weight gradient."""
    o = offsets.tolist()
    return torch.stack([a[:, o[e]:o[e + 1]] @ b[o[e]:o[e + 1]]
                        for e in range(len(o) - 1)])


def moe_gmm_grouped(x: torch.Tensor, wg: torch.Tensor, offsets: torch.Tensor,
                    tile_expert: torch.Tensor) -> torch.Tensor:
    """x (R, din) in segments (``offsets``, E + 1 int32 row offsets, each a
    multiple of ``GROUP_ROWS``; ``tile_expert``, (R / GROUP_ROWS,) int32, the
    expert of each row tile; both on x's device), wg (E, din, dout) -> (R,
    dout) (see the module docstring); differentiable."""
    if x.dim() != 2 or wg.dim() != 3 or wg.shape[1] != x.shape[1]:
        raise TypeError(f"x must be (R, din) and wg (E, din, dout), got "
                        f"{tuple(x.shape)} and {tuple(wg.shape)}")
    if x.shape[0] % GROUP_ROWS or tuple(tile_expert.shape) != (
            x.shape[0] // GROUP_ROWS,) or tuple(offsets.shape) != (
            wg.shape[0] + 1,):
        raise ValueError(f"R = {x.shape[0]} rows must be a multiple of "
                         f"{GROUP_ROWS}, with a tile table of R / "
                         f"{GROUP_ROWS} and E + 1 offsets")
    if wg.dtype != x.dtype or x.device != wg.device:
        raise TypeError("x and wg must share a dtype and a device")
    if torch.is_grad_enabled() and (x.requires_grad or wg.requires_grad):
        return _Grouped.apply(x, wg, offsets, tile_expert)
    return _grouped(ROWS, x, wg, offsets, tile_expert)


class _Grouped(torch.autograd.Function):
    """The grouped rows form forward; backward, the rows form on the
    weights' transpose and the contraction form."""

    @staticmethod
    def forward(ctx, x, wg, offsets, tile_expert):
        ctx.save_for_backward(x, wg, offsets, tile_expert)
        return _grouped(ROWS, x, wg, offsets, tile_expert)

    @staticmethod
    def backward(ctx, grad):
        global backward_launches
        x, wg, offsets, tile_expert = ctx.saved_tensors
        grad = grad.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _grouped(ROWS, grad, wg.transpose(1, 2).contiguous(),
                          offsets, tile_expert)
        if ctx.needs_input_grad[1]:
            dw = _grouped(CONTRACTION, x.t().contiguous(), grad, offsets,
                          tile_expert)
        if grad.device.type == "cuda":
            backward_launches += (dx is not None) + (dw is not None)
        return dx, dw, None, None


def _grouped(mode: int, a: torch.Tensor, b: torch.Tensor,
             offsets: torch.Tensor, tile_expert: torch.Tensor) -> torch.Tensor:
    """One grouped launch (counted), or its plain version on the CPU. ROWS:
    a (R, K) rows, b (E, K, N) -> (R, N). CONTRACTION: a (M, R), b (R, N)
    -> (E, M, N)."""
    global launches
    if a.device.type == "cpu":
        if mode == ROWS:
            return moe_gmm_grouped_ref(a, b, offsets)
        return _contract_ref(a, b, offsets)
    for name, t in (("a", a), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    E = offsets.shape[0] - 1
    M, K = a.shape
    N = b.shape[-1]
    table = (tile_expert if mode == ROWS else offsets).to(torch.int32)
    variant = grouped_variant(a.dtype, K, N)
    shape = (M, N) if mode == ROWS else (E, M, N)
    out = torch.empty(shape, dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = _entry("moe_gmm_grouped")(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), DTYPES[a.dtype],
        VARIANTS.index(variant), mode, E, M, K, N, table.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"moe_gmm grouped kernel ({variant}, mode {mode}) "
                           f"launch failed: CUDA error {rc} at (E, M, K, N) "
                           f"= ({E}, {M}, {K}, {N})")
    launches += 1
    launches_by_variant[variant] += 1
    return out
