"""Weighted scatter-add (compressed FedAvg): the CUDA kernel's wrapper and
its plain version.

Per parameter leaf the server decompresses every device's top-k delta into
one flat accumulator:

    out[p] = sum over (i, j) with idx[i, j] == p of weights[i] * vals[i, j]

``vals`` (n, k) f32, ``idx`` (n, k) int32/int64, ``weights`` (n,) f32 ->
(size,) f32. A negative index is padding and is dropped, as is an index
>= size. ``scatter_add`` launches ``csrc/scatter_add.cu`` for CUDA tensors
and counts each call that launched in ``launches`` and, by the variant
``kernel_variant`` names, in ``launches_by_variant``; for CPU tensors it is
``scatter_add_ref``, the plain PyTorch version (float64 sums rounded
once). There is no fallback: a CUDA tensor launches the named variant or
raises. Both variants sum with float atomics (in shared memory for
``tile``), in an order that changes from run to run, so on the card the
result is not bitwise reproducible; it agrees with the plain version
within 1e-5 relative plus absolute. ``atomic`` sums a warp's, then a
block's, entries first where they all hold one position, in float64, and
adds those sums with float64 atomics into a slot of a small zeroed scratch
that its last block rounds once into the output: a position that a stream
crowds takes one rounding, whatever the blocks' order.
"""

from __future__ import annotations

import ctypes

import torch

#: Kernel launches since the last reset (one per ``scatter_add`` call that
#: launched; the plain version and empty inputs do not count).
launches = 0

INDEX_TYPES = (torch.int32, torch.int64)
#: The kernel's variants, by the number the C entry takes.
VARIANTS = ("atomic", "tile")
#: The same launches split by variant.
launches_by_variant = dict.fromkeys(VARIANTS, 0)
TILE = 16384             # output floats the tile variant holds in shared memory
TILE_MAX_ENTRIES = 1024  # entries the rule sends to it: one a thread


def serves(variant: str, n: int, k: int, size: int) -> bool:
    """Whether the C entry takes ``variant`` for an (n, k) stream into
    ``size`` floats: ``atomic`` every shape, ``tile`` an output of at most
    ``TILE`` floats (a stream of any length)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    return variant == "atomic" or size <= TILE


def kernel_variant(n: int, k: int, size: int) -> str:
    """The variant of ``csrc/scatter_add.cu`` that serves an (n, k) stream
    into ``size`` floats: ``"tile"`` (one block, the output in shared
    memory, one launch and no fill) where it serves the shape and the
    stream has at most ``TILE_MAX_ENTRIES`` entries (VGG16's biases and
    first conv, LeNet-5's small leaves), ``"atomic"`` (float atomics into a
    zeroed output, the first design, with crowded warps and blocks summed
    first) otherwise. Both index types are served
    alike, so the rule takes the shape alone."""
    if serves("tile", n, k, size) and n * k <= TILE_MAX_ENTRIES:
        return "tile"
    return "atomic"


def scatter_add_ref(vals: torch.Tensor, idx: torch.Tensor,
                    weights: torch.Tensor, size: int) -> torch.Tensor:
    """Plain PyTorch version, with the reference oracle's semantics
    (``repro/kernels/ref.py``): padding and out-of-range positions are
    routed to one slot past the end, which is sliced off. Products and
    sums in float64, rounded to float32 once: a float32 sum of many terms
    onto one position walks by about 1e-4 (30,000 randn terms), past the
    1e-5 (1 + |exp|) the kernel is held to where the terms cancel."""
    wv = vals.to(torch.float64) * weights.to(torch.float64)[:, None]
    flat = idx.reshape(-1).long()
    flat = torch.where((flat < 0) | (flat >= size), size, flat)
    out = torch.zeros(size + 1, dtype=torch.float64, device=vals.device)
    out.index_put_((flat,), wv.reshape(-1), accumulate=True)
    return out[:size].to(torch.float32)


def _check(vals, idx, weights, size):
    if vals.dim() != 2 or vals.dtype != torch.float32:
        raise TypeError(f"vals must be an (n, k) float32 tensor, got "
                        f"{tuple(vals.shape)} {vals.dtype}")
    if tuple(idx.shape) != tuple(vals.shape) or idx.dtype not in INDEX_TYPES:
        raise TypeError(f"idx must be a {tuple(vals.shape)} int32/int64 "
                        f"tensor, got {tuple(idx.shape)} {idx.dtype}")
    n = vals.shape[0]
    if tuple(weights.shape) != (n,) or weights.dtype != torch.float32:
        raise TypeError(f"weights must be a ({n},) float32 tensor, got "
                        f"{tuple(weights.shape)} {weights.dtype}")
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")


def _entry():
    """The kernel's C entry point, built and typed at first use."""
    from repro_torch.kernels import build

    lib = build.load("scatter_add")
    fn = lib.fl_scatter_add
    if fn.argtypes is None:  # ints would pass as 32-bit, cutting pointers
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int] + [
            ctypes.c_longlong] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.fl_scatter_crowd_bytes.restype = ctypes.c_longlong
        fn.crowd_bytes = int(lib.fl_scatter_crowd_bytes())
    return fn


def scatter_add(vals: torch.Tensor, idx: torch.Tensor, weights: torch.Tensor,
                size: int) -> torch.Tensor:
    """(n, k) f32 vals, (n, k) int32/int64 idx, (n,) f32 weights -> (size,)
    f32 (see module docstring). CUDA tensors launch the kernel; CPU tensors
    take ``scatter_add_ref``; a mix raises."""
    global launches
    size = int(size)
    _check(vals, idx, weights, size)
    devices = {vals.device, idx.device, weights.device}
    if len(devices) != 1:
        raise ValueError(f"scatter_add inputs on several devices: {devices}")
    if vals.device.type == "cpu":
        return scatter_add_ref(vals, idx, weights, size)
    if vals.device.type != "cuda":
        raise ValueError(f"scatter_add has no kernel for {vals.device}")
    for name, x in (("vals", vals), ("idx", idx), ("weights", weights)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, k = vals.shape
    if n * k == 0:
        return torch.zeros(size, dtype=torch.float32, device=vals.device)
    variant = kernel_variant(n, k, size)
    out = launch_variant(variant, vals, idx, weights, size)
    launches += 1
    launches_by_variant[variant] += 1
    return out


def launch_variant(variant: str, vals: torch.Tensor, idx: torch.Tensor,
                   weights: torch.Tensor, size: int) -> torch.Tensor:
    """One launch of ``variant`` through the C entry on checked,
    contiguous CUDA inputs with n * k > 0; returns the (size,) output.
    ``atomic`` adds into a zeroed output, its crowded slots in a zeroed
    scratch after it (one ``torch.zeros``; the output is a view of its
    first ``size`` floats); ``tile`` writes every element of a
    ``torch.empty`` one. Counts nothing (``scatter_add`` does)."""
    n, k = vals.shape
    fn = _entry()
    scratch, nbytes = None, 0
    if variant == "atomic":
        start = -(-size // 4) * 4          # the scratch 16-byte aligned
        buf = torch.zeros(start + -(-fn.crowd_bytes // 4), dtype=torch.float32,
                          device=vals.device)
        out, scratch = buf[:size], buf[start:]
        nbytes = scratch.numel() * 4
    else:
        out = torch.empty(size, dtype=torch.float32, device=vals.device)
    rc = fn(vals.data_ptr(), idx.data_ptr(), idx.element_size(),
            weights.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, nbytes,
            VARIANTS.index(variant), n, k, size,
            torch.cuda.current_stream(vals.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"scatter_add kernel ({variant}) launch failed: "
                           f"CUDA error {rc} at (n, k, size) = ({n}, {k}, "
                           f"{size})")
    return out
