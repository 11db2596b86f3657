"""Plan-scoring statistics: the CUDA kernel's wrapper and its plain version.

Scores P candidate scheduling plans over K devices in one pass (the inner
loop of the host searchers: Formula 2 = alpha * masked-max round time +
beta * fairness-variance increment). Per plan it returns three sufficient
statistics:

  col 0:  max_{k in V} t_k          (Formula 3; -1e30 for an empty plan)
  col 1:  |V| = sum_k v_k           (selected count)
  col 2:  sum_{k in V} (2 c_k + 1)  (fairness increment numerator)

from which ``repro_torch.core.scoring`` combines the cost on the host in
float64. ``plan_stats`` launches ``csrc/sched_score.cu`` for CUDA tensors
and counts each launch in ``launches`` and, by the variant
``kernel_variant`` names, in ``launches_by_variant``; for CPU tensors it is
``plan_stats_ref``, the plain PyTorch version. There is no fallback: a CUDA
tensor launches the named variant or raises.

Two variants, named by ``kernel_variant(P, K, aligned)`` from the shape
and the plans pointer's alignment: ``stream`` (all of a 12 KB chunk's plan
bytes in flight before the first test, the next chunk's during it, a
persistent grid, gathers in batches) for K a multiple of 16 on 16-byte
aligned plans; ``row`` (one block a row, the first design) for every other
shape.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30

#: Kernel launches since the last reset (one per ``plan_stats`` call that
#: launched; the plain version and empty batches do not count).
launches = 0

#: The kernel's variants, by the number the C entry takes.
VARIANTS = ("row", "stream")
#: The same launches split by variant.
launches_by_variant = dict.fromkeys(VARIANTS, 0)


def serves(variant: str, P: int, K: int, aligned: bool) -> bool:
    """Whether the C entry takes ``variant`` for (P, K) plans whose pointer
    is 16-byte aligned (``aligned``): ``row`` every shape, ``stream``
    K > 0 a multiple of 16 on aligned plans (every row then starts on a
    16-byte boundary). P does not enter: both serve any row count."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    return variant == "row" or (bool(aligned) and K > 0 and K % 16 == 0)


def kernel_variant(P: int, K: int, aligned: bool) -> str:
    """The variant of ``csrc/sched_score.cu`` that serves (P, K) plans:
    ``"stream"`` wherever it serves the shape, ``"row"`` otherwise (K not a
    multiple of 16, K = 0 or 1, an unaligned plans pointer)."""
    return "stream" if serves("stream", P, K, aligned) else "row"


def plan_stats_ref(times: torch.Tensor, weights: torch.Tensor,
                   plans: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch (P, 3) stats: [masked max time, selected count,
    selected weight sum], float32, on the inputs' device.

    The weight sum accumulates in float64 and rounds to float32 once, as
    the kernel does, so plans that select the same multiset of weights get
    the same column 2 wherever those devices sit."""
    sel = plans != 0
    P, K = sel.shape
    t = times.to(torch.float32)
    w = weights.to(torch.float32)
    if K == 0:
        tmax = torch.full((P,), NEG_INF, dtype=torch.float32,
                          device=sel.device)
    else:
        tmax = torch.where(sel, t[None, :], NEG_INF).amax(dim=1)
    n = sel.sum(dim=1).to(torch.float32)
    ws = torch.where(sel, w[None, :], 0.0).sum(
        dim=1, dtype=torch.float64).to(torch.float32)
    return torch.stack([tmax, n, ws], dim=1)


def _check(times, weights, plans) -> torch.Tensor:
    if plans.dtype == torch.bool:
        plans = plans.view(torch.int8)
    if plans.dtype != torch.int8 or plans.dim() != 2:
        raise TypeError(f"plans must be a (P, K) int8 or bool tensor, got "
                        f"{tuple(plans.shape)} {plans.dtype}")
    K = plans.shape[1]
    for name, x in (("times", times), ("weights", weights)):
        if x.dtype != torch.float32 or tuple(x.shape) != (K,):
            raise TypeError(f"{name} must be a ({K},) float32 tensor, got "
                            f"{tuple(x.shape)} {x.dtype}")
    if K >= 2 ** 31:
        raise ValueError(f"K = {K} exceeds the kernel's int32 device index")
    return plans


def _entry():
    """The kernel's C entry point, built and typed at first use."""
    from repro_torch.kernels import build

    fn = build.load("sched_score").sched_plan_stats
    if fn.argtypes is None:  # ints would pass as 32-bit, cutting pointers
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def plan_stats(times: torch.Tensor, weights: torch.Tensor,
               plans: torch.Tensor) -> torch.Tensor:
    """(K,) f32 times, (K,) f32 weights, (P, K) int8/bool plans -> (P, 3)
    f32 stats (see module docstring). CUDA tensors launch the kernel; CPU
    tensors take ``plan_stats_ref``; a mix raises."""
    global launches
    plans = _check(times, weights, plans)
    devices = {times.device, weights.device, plans.device}
    if len(devices) != 1:
        raise ValueError(f"plan_stats inputs on several devices: {devices}")
    if plans.device.type == "cpu":
        return plan_stats_ref(times, weights, plans)
    if plans.device.type != "cuda":
        raise ValueError(f"plan_stats has no kernel for {plans.device}")
    for name, x in (("times", times), ("weights", weights),
                    ("plans", plans)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    P, K = plans.shape
    if P == 0:
        return torch.empty((0, 3), dtype=torch.float32, device=plans.device)
    variant = kernel_variant(P, K, plans.data_ptr() % 16 == 0)
    if variant == "stream":  # it reads dense vectors' times 16 bytes at a time
        times, weights = (x if x.data_ptr() % 16 == 0 else x.clone()
                          for x in (times, weights))
    out = launch_variant(variant, times, weights, plans)
    launches += 1
    launches_by_variant[variant] += 1
    return out


def launch_variant(variant: str, times: torch.Tensor, weights: torch.Tensor,
                   plans: torch.Tensor) -> torch.Tensor:
    """One launch of ``variant`` through the C entry on checked,
    contiguous CUDA inputs (``plans`` int8, P > 0; for ``stream`` times and
    weights 16-byte aligned, as ``plan_stats`` makes them); returns the
    (P, 3) stats. Counts nothing (``plan_stats`` does)."""
    P, K = plans.shape
    out = torch.empty((P, 3), dtype=torch.float32, device=plans.device)
    # The C entry launches on (and sizes its grid for) the current device:
    # make it the plans' card, which a fleet block need not be.
    with torch.cuda.device(plans.device):
        rc = _entry()(times.data_ptr(), weights.data_ptr(),
                      plans.data_ptr(), out.data_ptr(), P, K,
                      VARIANTS.index(variant),
                      torch.cuda.current_stream(plans.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sched_score kernel ({variant}) launch failed: "
                           f"CUDA error {rc} at (P, K) = ({P}, {K})")
    return out
