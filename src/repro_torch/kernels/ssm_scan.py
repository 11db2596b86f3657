"""Gated linear recurrence (SSD heads, mLSTM): the CUDA kernel's wrapper
and its plain versions.

Per (batch, head), from a state (S, n) of (Dk, Dv) and (Dk,):

    S_t = a_t S_{t-1} + k_t v_t^T,   n_t = a_t n_{t-1} + k_t,
    y_t = (q_t . S_t) / max(|q_t . n_t|, 1)

q, k (B, S, H, Dk); v (B, S, H, Dv); decays a (B, S, H) in (0, 1]; y in
v's dtype, the math and the state in float32.

- ``linear_scan_chunked_ref``: the reference's default plain path
  (``repro/kernels/ref.py::linear_scan_chunked``), zero initial state, in
  chunks of 128 halved until they divide S.
- ``linear_scan_ref``: the sequential oracle (``ref.linear_scan``), from
  any initial state.
- ``linear_scan_step``: one decode step (``ref.linear_scan_step``); it has
  no kernel, in the reference or here.
- ``linear_scan``: launches ``csrc/linear_scan.cu`` for CUDA tensors and
  counts each call that launched in ``launches`` and, by the variant
  ``kernel_variant`` names, in ``launches_by_variant``; for CPU tensors it
  is ``linear_scan_chunked_ref``. Prefill only (zero initial state). The
  final state, where asked for, is formed outside the kernel from the
  decay-weighted keys, as the reference's kernel path does
  (``ssm_scan.py:121-126``); the models do not ask for it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

#: Wrapper calls that launched the kernel since the last reset (one per
#: call; the plain versions do not count).
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DK = 1024          # the simt variant keeps a (Dk, 32) state slice on chip
#: The kernel's variants, by the number the C entry takes.
VARIANTS = ("simt", "mma")
#: The same launches split by variant.
launches_by_variant = dict.fromkeys(VARIANTS, 0)
#: Chunk lengths the mma variant is built for.
CHUNKS = (64, 128)

State = Tuple[torch.Tensor, torch.Tensor]


def _log_decay(decay: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(decay.float(), min=1e-37))


def linear_scan_ref(q, k, v, decay, init_state: Optional[State] = None
                    ) -> Tuple[torch.Tensor, State]:
    """The sequential oracle: one step per token. Returns y and the final
    state (S, n)."""
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    if init_state is None:
        St = torch.zeros((B, H, Dk, Dv), dtype=torch.float32, device=q.device)
        nt = torch.zeros((B, H, Dk), dtype=torch.float32, device=q.device)
    else:
        St, nt = init_state
    ys = []
    for t in range(S):
        y, (St, nt) = linear_scan_step(q[:, t], k[:, t], v[:, t],
                                       decay[:, t], (St, nt))
        ys.append(y)
    y = (torch.stack(ys, 1) if ys else
         torch.zeros((B, 0, H, Dv), dtype=v.dtype, device=v.device))
    return y, (St, nt)


def linear_scan_chunked_ref(q, k, v, decay, chunk: int = 128
                            ) -> Tuple[torch.Tensor, State]:
    """The chunked plain form, the reference's default data path: the same
    math as the kernel, with the chunk's work as dense products. Returns y
    and the final state (S, n)."""
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    Lc = min(chunk, S)
    while S % Lc:
        Lc //= 2
    nC = S // Lc

    def resh(x):
        return x.reshape(B, nC, Lc, *x.shape[2:]).float()

    qc, kc, vc = resh(q), resh(k), resh(v)                   # (B,nC,Lc,H,.)
    la = torch.cumsum(_log_decay(resh(decay)), dim=2)        # (B,nC,Lc,H)
    A = torch.exp(la)
    ratio = torch.exp(la[:, :, :, None, :] - la[:, :, None, :, :])
    pos = torch.arange(Lc, device=q.device)
    mask = (pos[:, None] >= pos[None, :])[None, None, :, :, None]
    Wqk = torch.where(mask, ratio, 0.0) * torch.einsum(
        "bcthd,bcihd->bctih", qc, kc)                        # (B,nC,t,i,H)
    y_intra = torch.einsum("bctih,bcihv->bcthv", Wqk, vc)
    den_intra = Wqk.sum(dim=3)                               # (B,nC,t,H)
    kd = kc * torch.exp(la[:, :, -1:, :] - la)[..., None]    # (A_L/A_i) k_i
    S_chunk = torch.einsum("bcihk,bcihv->bchkv", kd, vc)     # (B,nC,H,Dk,Dv)
    n_chunk = kd.sum(dim=2)                                  # (B,nC,H,Dk)
    AL = A[:, :, -1, :]                                      # (B,nC,H)

    S_in = torch.zeros((B, H, Dk, Dv), dtype=torch.float32, device=q.device)
    n_in = torch.zeros((B, H, Dk), dtype=torch.float32, device=q.device)
    S_ins, n_ins = [], []
    for c in range(nC):
        S_ins.append(S_in)
        n_ins.append(n_in)
        S_in = AL[:, c, :, None, None] * S_in + S_chunk[:, c]
        n_in = AL[:, c, :, None] * n_in + n_chunk[:, c]
    y_cross = A[..., None] * torch.einsum("bcthk,bchkv->bcthv", qc,
                                          torch.stack(S_ins, 1))
    den_cross = A * torch.einsum("bcthk,bchk->bcth", qc, torch.stack(n_ins, 1))
    den = torch.clamp(torch.abs(den_intra + den_cross), min=1.0)
    y = ((y_intra + y_cross) / den[..., None]).reshape(B, S, H, Dv)
    return y.to(v.dtype), (S_in, n_in)


def linear_scan_step(q, k, v, decay, state: State
                     ) -> Tuple[torch.Tensor, State]:
    """One decode step: q, k (B, H, Dk); v (B, H, Dv); decay (B, H)."""
    St, nt = state
    St = (decay[..., None, None] * St
          + k[..., :, None].float() * v[..., None, :].float())
    nt = decay[..., None] * nt + k.float()
    num = torch.einsum("bhk,bhkv->bhv", q.float(), St)
    den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", q.float(), nt)),
                      min=1.0)
    return (num / den[..., None]).to(v.dtype), (St, nt)


def final_state(k, v, decay) -> State:
    """The state after the whole sequence from a zero start, in closed form
    (``repro/kernels/ssm_scan.py:121-126``)."""
    la = torch.cumsum(_log_decay(decay), dim=1)
    kd = k.float() * torch.exp(la[:, -1:, :] - la)[..., None]
    return (torch.einsum("bshk,bshv->bhkv", kd, v.float()),
            torch.einsum("bshk->bhk", kd))


def kernel_variant(dtype: torch.dtype, B: int, S: int, H: int, Dk: int,
                   Dv: int) -> str:
    """The variant of ``csrc/linear_scan.cu`` that serves this call:
    ``"mma"`` (chunk-parallel, tensor cores) for bfloat16 at any shape,
    ``"simt"`` (chunks in order, all math f32) for float32."""
    return "mma" if dtype == torch.bfloat16 else "simt"


def chunk_length(Dk: int, Dv: int) -> int:
    """The mma variant's chunk length L: 64, or 128 where the state is large
    (its f32 scratch of B H (S / L) Dk Dv, written once and read twice,
    halves with L)."""
    return 128 if Dk * Dv >= 128 * 128 else 64


def scan_plan(B: int, S: int, H: int, Dk: int, Dv: int, chunk: int = None):
    """(L, nC, state_floats, al_floats): the mma variant's chunk length, the
    number of chunks and its two f32 scratch sizes (each chunk's state S_c
    and n_c, then the state entering it; each chunk's decay product)."""
    L = chunk or chunk_length(Dk, Dv)
    if L not in CHUNKS:
        raise ValueError(f"chunk must be one of {CHUNKS}, got {L}")
    nC = -(-S // L)
    return L, nC, B * H * nC * (Dk * Dv + Dk), B * H * nC


def _check(q, k, v, decay):
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 \
            or v.shape[:3] != q.shape[:3] or decay.shape != q.shape[:3]:
        raise TypeError(f"q, k must be (B, S, H, Dk), v (B, S, H, Dv) and "
                        f"decay (B, S, H), got {tuple(q.shape)}, "
                        f"{tuple(k.shape)}, {tuple(v.shape)}, "
                        f"{tuple(decay.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one of {list(DTYPES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device, decay.device}) != 1:
        raise ValueError("linear_scan inputs on several devices")


def _entry():
    """The kernel's C entry point, built and typed at first use."""
    from repro_torch.kernels import build

    fn = build.load("linear_scan").linear_scan
    if fn.argtypes is None:  # ints would pass as 32-bit, cutting pointers
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_longlong] * 9 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def linear_scan(q, k, v, decay, want_final_state: bool = True
                ) -> Tuple[torch.Tensor, Optional[State]]:
    """Prefill scan from a zero state -> (y, final state or None). CUDA
    tensors launch the kernel; CPU tensors take
    ``linear_scan_chunked_ref``."""
    global launches
    _check(q, k, v, decay)
    if q.device.type == "cpu":
        y, state = linear_scan_chunked_ref(q, k, v, decay)
        return y, (state if want_final_state else None)
    if q.device.type != "cuda":
        raise ValueError(f"linear_scan has no kernel for {q.device}")
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    variant = kernel_variant(q.dtype, B, S, H, Dk, Dv)
    if variant == "simt" and Dk > MAX_DK:
        raise ValueError(f"the simt variant takes Dk <= {MAX_DK}, got {Dk}")
    a = decay.float().contiguous()
    y = torch.empty((B, S, H, Dv), dtype=v.dtype, device=v.device)
    if y.numel():
        launch_variant(variant, q, k, v, a, y)
        launches += 1
        launches_by_variant[variant] += 1
    return y, (final_state(k, v, a) if want_final_state else None)


def _vec_bits(*tensors) -> int:
    """Bit i set where tensor i's base and outer strides allow 16-byte
    loads (bf16: multiples of 8 elements)."""
    bits = 0
    for i, t in enumerate(tensors):
        if t.data_ptr() % 16 == 0 and all(st % 8 == 0
                                          for st in t.stride()[:3]):
            bits |= 1 << i
    return bits


def launch_variant(variant: str, q, k, v, a, y, chunk: int = None) -> None:
    """One launch of ``variant`` through the C entry on checked CUDA inputs
    (``a`` the float32 decays, contiguous), into ``y``; ``chunk`` overrides
    the mma variant's ``chunk_length``. Counts nothing (``linear_scan``
    does)."""
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    states = al = None
    L = 0
    if variant == "mma":
        L, _, n_states, n_al = scan_plan(B, S, H, Dk, Dv, chunk)
        states = torch.empty(n_states, dtype=torch.float32, device=q.device)
        al = torch.empty(n_al, dtype=torch.float32, device=q.device)
    rc = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), a.data_ptr(),
                  y.data_ptr(), None if states is None else states.data_ptr(),
                  None if al is None else al.data_ptr(), DTYPES[q.dtype],
                  VARIANTS.index(variant), L, B, S, H, Dk, Dv,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  _vec_bits(q, k, v),
                  torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"linear_scan kernel ({variant}) launch failed: "
                           f"CUDA error {rc} at (B, S, H, Dk, Dv) = ({B}, {S}, "
                           f"{H}, {Dk}, {Dv})")
