#!/usr/bin/env python3
"""Tune the decode-attention split plan and the linear scan's chunk length
on the card.

    python3 scripts/tune_decode_scan.py [--out FILE]

Times by CUDA events (``chip_smoke.cuda_time_ms``), in bf16:

- decode attention's ``tma`` variant under each plan that
  ``decode_attention.split_plan`` makes for a target block count (256,
  512, 4096) and a smallest chunk (256, 1024 rows), at qwen3-1.7b's and
  kimi-k2's 16 slots (T = 4096), hymba-1.5b's 16 slots on a 1024-row ring
  and the decode_32k layer, beside the rows' bytes bound;
- the scan's ``mma`` variant at each of ``ssm_scan.CHUNKS``, at
  hymba-1.5b's (2, 4096, 25, 16 x 128) and xlstm-350m's (1, 1024) and
  (2, 4096) 512 x 512 states, with the device time of each of its
  launches (torch.profiler).

The kernels are checked against their plain versions by ``chip_smoke.py``
(phases 6 and 8) and ``tests/test_torch_cuda.py``, not here. Prints one
JSON line per record and the card's name and power limit last. Needs one
CUDA card and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import (HBM_BYTES_PER_S, cuda_time_ms,  # noqa: E402
                        nvidia_smi_line)

DECODE_SHAPES = (  # label, B, T, H, KV, D
    ("qwen3-1.7b 16 slots", 16, 4096, 16, 8, 128),
    ("decode_32k layer", None, None, 16, 8, 128),
    ("hymba-1.5b 16 slots, 1024 ring", 16, 1024, 25, 5, 64),
    ("kimi-k2 16 slots", 16, 4096, 64, 8, 112))
SCAN_SHAPES = (  # label, B, S, H, Dk, Dv
    ("hymba-1.5b", 2, 4096, 25, 16, 128),
    ("xlstm-350m (1, 1024)", 1, 1024, 4, 512, 512),
    ("xlstm-350m (2, 4096)", 2, 4096, 4, 512, 512))


def emit(rec, sink):
    print(json.dumps(rec), flush=True)
    sink.append(rec)


def kernel_us(torch, fn, calls=5):
    """Mean device microseconds per call of each kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if t:
            out[e.key[:60]] = t / calls
    return out


def sweep_decode(torch, dev, g, sink):
    from repro_torch.config.shapes import SHAPES
    from repro_torch.kernels import decode_attention as da

    d32 = SHAPES["decode_32k"]
    for label, B, T, H, KV, D in DECODE_SHAPES:
        B, T = B or d32.global_batch, T or d32.seq_len
        q = torch.randn((B, H, D), device=dev, generator=g).bfloat16()
        k = torch.randn((B, T, KV, D), device=dev, generator=g).bfloat16()
        v = torch.randn((B, T, KV, D), device=dev, generator=g).bfloat16()
        lin = torch.linspace(1, T, B, device=dev).round().int()
        length = lin[torch.randperm(B, device=dev, generator=g)].contiguous()
        out = torch.empty_like(q)
        rows = sum(length.tolist())
        bound = (2 * rows * KV * D + 2 * B * H * D) * 2 / HBM_BYTES_PER_S * 1e3
        shipped = da.split_plan(B, KV, T)
        for target in (256, 512, 4096):
            for min_chunk in (256, 1024):
                plan = da.split_plan(B, KV, T, "tma", target, min_chunk)
                ms = cuda_time_ms(torch, lambda: da.launch_variant(
                    "tma", q, k, v, length, out, plan),
                    inner=5 if B > 16 else 20, reps=5)
                emit(dict(what="decode split plan", label=label,
                          target_blocks=target, min_chunk=min_chunk,
                          plan=list(plan), shipped=plan == shipped, ms=ms,
                          bound_ms=bound), sink)
        del q, k, v
        torch.cuda.empty_cache()


def sweep_scan(torch, dev, g, sink):
    from repro_torch.kernels import ssm_scan as ss

    for label, B, S, H, Dk, Dv in SCAN_SHAPES:
        q = torch.randn((B, S, H, Dk), device=dev, generator=g).bfloat16()
        k = (0.5 * torch.randn((B, S, H, Dk), device=dev,
                               generator=g)).bfloat16()
        v = torch.randn((B, S, H, Dv), device=dev, generator=g).bfloat16()
        a = 0.5 + 0.5 * torch.rand((B, S, H), device=dev, generator=g)
        y = torch.empty((B, S, H, Dv), dtype=v.dtype, device=dev)
        for L in ss.CHUNKS:
            def run(L=L):
                ss.launch_variant("mma", q, k, v, a, y, chunk=L)

            emit(dict(what="scan chunk", label=label, chunk=L,
                      shipped=L == ss.chunk_length(Dk, Dv),
                      ms=cuda_time_ms(torch, run, inner=3, reps=5),
                      device_us=kernel_us(torch, run)), sink)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the records here (JSON)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tune_decode_scan: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    sink = []
    sweep_decode(torch, dev, g, sink)
    sweep_scan(torch, dev, g, sink)
    emit(dict(what="card", nvidia_smi=nvidia_smi_line()), sink)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(sink, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
