#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--out details.json]

Needs one CUDA card and ``nvcc``; imports nothing of JAX and nothing of the
reference package. Every phase prints one JSON line; any failure exits
non-zero with a traceback, and no phase's failure is caught.

1. device  — the card's name and power limit (``nvidia-smi``) and the
   kernel build, from the checkout's sources, one ``nvcc`` per source, with
   each library's build seconds and, per compiled function, the registers,
   spills and performance warnings ``ptxas`` reports.
2. kernels — the plan-scoring kernel (2.1) against its plain PyTorch
   version on the card, at the shapes the main path gives it and at ragged
   and edge-case shapes: every variant that serves a shape
   (``sched_score.serves``), columns 0 and 1 exact, column 2 within
   ``1e-5 * max(1, sum |w| over the selected devices)``. Each row names the
   variant ``kernel_variant`` picked (its count must advance). Times (CUDA
   events, warm-up then the median, L2-warm) of
   the kernel, of the first design (``row``), of the plain version and of
   the host-to-device copy of the plans, beside the bound and the time of
   an empty kernel under the same timer (``torch.cuda._sleep(0)``). At the
   main path's (512, 10,000) also a cold row: launches rotate over 12
   copies of the plans (61 MB, more than the 50 MB L2), every variant is
   held to the plain version on rotated copies, and one launch at a time
   is timed on warm plans, on cold ones and right after a fresh
   host-to-device copy (as the main path launches it).
3. main    — the ``fleet-scale`` preset (K = 10,000, n_sel = 100, 2 jobs x 5
   rounds) with the genetic host search (population 512, 12 generations)
   and ``scoring_backend="cuda"``, through ``ExperimentSpec.build/run`` on
   the card: the kernel must launch 13 times per decision (the launches
   by variant are printed); the same spec on
   the ``torch`` backend must give identical device ids and round times
   and est_cost within 1e-5. Greedy on the same preset covers the index
   form on the card and must match the numpy backend's records.

4. fl-kernels — the compressed-FedAvg scatter-add against its plain
   PyTorch version on the card, within 1e-5 relative plus absolute, at the
   main path's shapes (VGG16's 4096x4096 fc leaf at n = 10 and ratios 0.01
   and 0.1, a 3x3x512x512 conv leaf at 0.01, LeNet-5's leaves at n = 5)
   and at edge shapes (negative and out-of-range indices, an index repeated
   within a row, size 1, n*k not a multiple of the block, int32 indices,
   outputs of T - 1, T and T + 1 floats for the tile size T, every entry
   on one position, a small output with a long stream). Each row names the
   variant ``kernel_variant`` picked (its count must advance). Times of
   the kernel, of the other design that serves the shape
   (``scatter_add.serves``) held to the same tolerance, of the plain
   version and of one ``index_add_`` call (the library yardstick, never
   called by the port), beside the bound. The stream "every entry on one
   position" again from CROWDED_SEEDS seeds: each seed's ``atomic`` output
   held to the plain version at the same limit, and the largest gap of
   each side to the float64 sum of the same terms.
5. fl-main — real federated training through ``ExperimentSpec.build(
   device="cuda").run()``: the ``real-fl-two-job`` preset (LeNet-5 + CNN-B,
   40 devices, greedy) for 3 rounds and one VGG16 job (100 devices,
   n_sel = 10, non-IID, group A's epochs and batch size) for 2 rounds; records
   finite, accuracy in [0, 1], one ``fused_round`` span per record. Then,
   on VGG16's last cohort, the locals are trained again from the runtime's
   global params and aggregated by ``fedavg_compressed(ratio=0.01,
   impl="cuda")``: one kernel launch per leaf (32), by variant as the
   leaves' shapes name them (fc2 ``atomic``, every bias ``tile``), the
   result within 1e-5 relative plus absolute of ``impl="ref"``, and at
   ratio 1.0 of ``fedavg``. The VGG16 round is split into local SGD,
   FedAvg and eval, and the compressed aggregation into top-k and kernel
   time, and each leaf's stream is timed on its variant and on the other
   design (as in phase 4), each held to the plain version; VGG16's
   first-round loss at group A's lr of 0.05 and at 0.01 is recorded beside
   the lr the job runs at (``VGG16_LR``).

6. lm-kernels — flash attention (prefill) and decode attention against
   their plain PyTorch versions on the card, in bf16 (the working type) and
   f32, within the reference's tolerances (2e-5 in f32; 2e-2 flash and
   3e-2 decode in bf16), and each bf16 output also held tightly to the
   plain version run in f32 on the same bf16 inputs (every output row
   within ``BF16_ROW_RTOL`` of its own norm): qwen3-1.7b's prefill (B = 2, S = 4096, causal)
   and one long context (S = 16,384); kimi-k2's attention width (64/8
   heads of 112): a (1, 4096) causal prefill and a 16-slot decode with T =
   4096; qwen3-1.7b's decode (16 slots, T = 4096) and one layer at the
   decode_32k shape (B = 128, T = 32,768, bf16 only: its caches are 17.2
   GB); MQA, MHA, G = 4 and G = 16, D = 64, 112 and 256, S and T that are
   not powers of two, lengths 0, 1 and T with rows past each length
   poisoned, a 1024 sliding window (hymba-1.5b's prefill among them) and
   non-causal. Each row names the variant ``kernel_variant`` picked (its
   count must advance), flash rows their TFLOP/s. Times of the kernel, the
   plain version and one ``scaled_dot_product_attention`` call (the
   library yardstick, never called by the port), beside the bound, and,
   for bf16 decode rows, of the simt kernel, the design before the tma
   one, held to the same tolerance; the flash autograd.Function's
   gradient against the plain one.
7. lm-serve — qwen3-1.7b at full width (28 layers, random weights from
   seed 0) through the port's entry points on the card: ``lm_init``, one
   ``make_prefill_step`` call on (2, 4096) tokens (flash launches exactly
   28 times, all the wgmma variant), the ``launch/serve.py`` loop (32 requests, 16 slots, 32 new
   tokens, a 4096-row cache; decode launches 28 times per step, all the
   tma variant; every request answered), one timed decode step at a cache of about 4000 rows
   (it and one prefill call split by ``torch.profiler`` into device busy
   time per kernel class and the device's idle share), and the whole model against itself under ``ops.set_default_impl("ref")``
   (f32 config: logits within ``MODEL_F32_RTOL`` of the largest; bf16:
   within ``MODEL_BF16_RTOL`` of the largest, and at least
   ``MODEL_BF16_GREEDY`` of the greedy tokens identical).

8. lm-kernels-2 — the MoE grouped matmul, the linear scan and RMSNorm
   against their plain PyTorch versions on the card, within the reference
   tests' tolerances (moe_gmm 1e-4 f32 and 2e-2 bf16; the scan 2e-4 in
   f32 and 2e-2 in bf16; rmsnorm 1e-5 and 2e-2), each bf16 output row also
   within ``BF16_ROW_RTOL`` of the plain version run in f32: dbrx-132b's
   prefill (C = 2560) and decode (C = 5) expert shapes, kimi-k2's (384
   experts, C = 214 and 1), the unaligned (3, 100, 130, 70), C = 70 (a
   partial 128-row tile), E = 1, C = 1, each row with its variant, TFLOP/s
   and largest difference from ``torch.bmm``'s output;
   hymba's (2, 4096, 25 heads, 16 x 128) and xlstm's 512 x 512 state at
   (1, 1024) and (2, 4096), S = 333 and 1000, strong decay, each scan row
   with its variant (mma in bf16, simt in f32) and, in bf16, the old
   design's (simt) time; norms of
   (8192, 2048), (8192, 6144), (16, 6144), 4097 rows of 1600, d = 100, one
   row, and d at the resident variant's limit and one vector past it, each
   row with its variant and the old design's (warp) time, held to the same
   tolerance.
   Times of the kernel, the plain version and the library call
   (``torch.bmm``; ``rms_norm``; none computes the scan), beside the bound
   (the scan's at its inputs' type's rate).
9. lm-serve-2 — the MoE, hybrid and SSM paths through the port's entry
   points: dbrx-132b at full width with 2 of its 40 layers (its tree from
   ``lm_param_shapes``, drawn on the card), one (2, 4096) prefill
   (``moe_gmm`` 3 launches a layer, flash 1), the serve loop of phase 7
   (3 ``moe_gmm`` and 1 decode launch per layer and step), a long-cache
   step, ``torch.profiler`` splits and the bf16 model against itself under
   ``set_default_impl("ref")`` with the share of routings that agree (the
   logit limit on the tokens every layer routed alike, greedy tokens over
   all); hymba-1.5b (32 layers) and xlstm-350m (24 layers) at full size
   from ``lm_init``: a (2, 4096) and a (1, 1024) prefill (``linear_scan``
   once per hymba layer and xlstm mLSTM block; never in decode), the serve
   loop, a step, splits, and each model against itself in f32 and bf16.
   Every launch of these paths is the Hopper design (``HOPPER_VARIANT``:
   wgmma flash and ``moe_gmm``, tma decode, mma scan).

10. schedulers — the paper's schedulers and the fused searches of
   ``core/search.py`` on the card. (a) ``fleet-scale`` at its defaults
   (fused BODS, K = 10,000, n_sel = 100, 512 candidates, 2 jobs x 5
   rounds): kernel 2.1 launches once per fused BODS decision on the
   device-resident (512, 10,000) candidate block, all ``stream``; the same
   spec under ``ops.set_default_impl("ref")`` (the plain statistics) must
   make identical decisions; wall and acquisition seconds per decision,
   the host-device synchronisations PyTorch reports inside a decision, and
   2.1 on the last block by CUDA events against its plain version and
   bound. (b) ``fleet-scale`` with the fused GA and SA: every decision is
   replayed on the CPU from the same inputs and generator state; GA's
   must be identical, SA's differences (an ``exp`` rounded otherwise can
   flip one Metropolis test) are counted with both plans' costs; seconds
   per decision beside phase 3's host GA. (c) ``paper-group-a``,
   ``paper-group-b`` and ``quickstart`` with their default BODS, and
   ``quickstart`` with RLDS (its 300 pretraining rounds timed apart) and
   DNN, all on the card: records checked, rounds to target, wall seconds.
   Each BODS run is held as (a) holds fleet-scale: 2.1 once per decision,
   all of the variant its (256, 100) block picks (``row``, K not a
   multiple of 16), identical decisions under the plain version, and 2.1
   on the last block against its plain version. The kernels line counts
   (a)'s and (c)'s launches by path and by variant.
11. service — the online scheduler service (``repro_torch.serve``) on the
   card. (a) ``online-smoke``'s tenants and traffic (horizon 20,000 s,
   interarrival 900, departures, readmissions, churn with drift) over
   fleet-scale's pool (K = 10,000, n_sel = 100), fused BODS with 512
   candidates, ``scoring_backend="cuda"``, through ``SchedulerService(spec,
   device="cuda")`` with the ``obs`` axis writing a trace, a metrics JSONL
   and an audit log, and a checkpoint every 4 events: records checked,
   every tenant accounted for, one metrics and audit row and one
   ``schedule`` and ``aggregate`` span per record. Kernel 2.1 launches once
   per fused BODS acquisition, once per live job at each admission's
   rescore ((1, K) plans copied from the host) and once per BODS cost
   estimate of the cost model (bootstrap, observe); the launches by path
   and variant, each path's last inputs held to the plain version and
   timed, the rescore's plan copy time, decision latency per admission,
   seconds per BODS decision, bytes and seconds per checkpoint save, and
   the port's ``monitoring.report`` of the trace. The same spec with every
   call of 2.1 on its plain version must give identical records and
   rescore costs. (b) ``slo-overload`` at the same pool through ``python
   -m repro_torch.serve --device cuda`` processes: an uninterrupted run, a
   run killed by ``--crash-after`` (exit 137) mid-horizon with checkpoints
   every 4 events, and ``--resume``: the resumed records equal the
   uninterrupted run's exactly, the degradation histogram is not empty and
   the faults are not inert. The kernels line counts (a)'s launches by
   path beside phases 3 and 10.

12. gym — the scheduler gym (``repro_torch.gym``) on the card. (a)
   Random and policy (the RLDS LSTM) rollouts of T = 32 rounds at K = 64
   and 256 devices (n_sel 10%, 3 jobs, the ``full`` curriculum) over E =
   1, 32 and 256 environments from one set of draws: env steps a second of
   host wall, launches per round and the device's idle share from
   torch.profiler over 4 rounds; each random rollout replayed on the CPU
   port from the same states and draws, costs within 1e-5 and plans
   identical (a flip only where its availability or top-k margin lies
   within 1e-6 relative, reported). (b) ``python -m repro_torch.gym
   train`` at the gym's published size (``--curriculum full --num-devices
   64,256 --envs 32 --rollout 32 --minibatches 4``, 8 of the documented 80
   iterations): ms per iteration by stage, every mean cost finite, trained
   and untrained eval cost (printed, not gated); ``eval`` and ``list`` on
   the saved entry. (c) The ``policy`` axis: ``rlds-warmstart`` (20 of its
   150 rounds) on that entry, records checked, the lazy pretraining never
   run and no 2.1 launch; ``quickstart``'s fused BODS run cold, saved with
   ``save_scheduler`` and run again warm-started from that entry through
   ``bods_checked`` (2.1 once per decision, all ``row`` at K = 100,
   decisions identical under the plain statistics, 2.1 on the last block
   held to its plain version). The kernels line counts (c)'s launches by
   path.

13. fleet-shard — fleet sharding (``repro_torch.core.shard``, module 7) on
   the card; each part prints one line with the card's name and power
   limit. (a) Dense scoring at bench_fleet's K = 262,144, P = 4096, n_sel
   = K/100 (int8 plans, 1.07 GB, drawn on the card, one row empty): the
   ``cuda`` and ``torch`` backends under ``emulate`` at N = 1, 2, 4 and 8
   against single-lane ``cuda``: ``max`` and ``n`` exact, scores within
   1e-5, 2.1 once per block (all ``stream``); each call's ms split into
   host block copies, copies to the card, the partials (CUDA events from
   each launch's start: the host's launch path and the kernel) and the
   combine (medians of 3); 2.1 alone on each N's last block (N = 1's is
   the whole plans), held to its plain version, beside its bound. (b)
   Index form at K = 1,000,000, P = 4096, n_sel = 10,000:
   ``random_plan_indices_sharded`` on the card at N = 1, 4, 8, every row
   n_sel distinct available ids; seconds and peak device memory per N;
   the sharded index scores within 1e-5 of the single lane's. (c)
   ``fleet-scale``'s fused SA, GA and BODS (512 candidates) split over the
   one card named 4 times: every decision's plan identical to N = 1's,
   BODS's candidate blocks bit for bit, 2.1 once per block per BODS
   decision (held to its plain version on the last block), ms per
   decision at both N. (d) ``fleet-scale`` through the spec with
   ``fleet.num_shards`` 4 and "auto": the fused schedulers fall back to
   one lane on one card (the fallbacks counted) and their records equal
   (c)'s single lane's; the host GA (``scoring_backend="cuda"``) launches
   2.1 once per block of each population it scores, every decision
   replayed at one shard: each flip printed with both plans' costs, and
   the pairs of plans whose order the sharded costs swap with the single
   lane's gap between them. The kernels line counts (a)'s, (c)'s and
   (d)'s launches by path.

14. lm-train — the LM train path (module 10.a) on the card; each part
   prints one line with the card's name and power limit. (a) qwen3-1.7b
   whole (28 layers, remat on) from phase 7's params, AdamW at lr 3e-4,
   ``make_train_step`` with 2 microbatches on one ``synth_batch`` of 2 x
   4096 tokens, 3 steps: flash attention (2.3) launched forward and again
   in each remat recompute, 28 x 2 x 2 a step, all wgmma, inside autograd
   (its backward is the autograd of its plain version); loss and grad norm
   finite, the loss after the 3 updates below step 1's; step 1 against the same step with
   every kernel on its plain version (loss, grad norm and the cosine of
   the two parameter updates, TRAIN_*); seconds a step, tokens a second,
   peak device memory and one more step under torch.profiler split by
   stage (flash forward, attention backward, cross-entropy, optimizer,
   matmul, other) with the card's idle share. (b) ``run_elastic`` over
   ``TokenBatcher`` at qwen3-1.7b's reduced size, 20 steps, with and
   without a failure injected at step 7: the final states equal bit for
   bit; ``python -m repro_torch.launch.train --arch qwen3-1.7b --reduced
   --steps 20`` (on the card by default) exits 0, and its last checkpoint
   carried into the reference's layout (``convert``) matches the
   manifest's keys, shapes and dtypes. (c) dbrx-132b's and hymba-1.5b's
   reduced train steps raise ``NoKernelGradError`` under the kernels (the
   MoE matmul and the scan have no backward pass); under
   ``set_default_impl("ref")`` dbrx's (f32) trains, its loss and grad norm
   within 1e-4 of the same step on the CPU. The kernels line counts (a)'s
   flash launches beside phase 7's.

The line before the last is the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
them; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
SUM_RTOL = 1e-5


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(report: str) -> dict:
    """Per compiled function of an ``nvcc -Xptxas -v`` report: its spill
    line (stack frame, spill stores and loads in bytes), registers, and
    any performance warning ptxas printed for it."""
    import re

    out, fn = {}, None
    for line in report.splitlines():
        warn = re.search(r"\(C\d+\) (.*) for the function '(\w+)'", line)
        if warn:
            out.setdefault(warn.group(2), {}).setdefault(
                "warnings", []).append(warn.group(1))
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            fn = entry.group(1)
            out.setdefault(fn, {})
        elif fn and "spill stores" in line:
            out[fn]["spills"] = line.strip()
        elif fn and "Used" in line and "registers" in line:
            out[fn]["registers"] = int(re.search(r"Used (\d+) registers",
                                                 line).group(1))
            fn = None
    return out


SLEEP_CYCLES = 100_000_000    # ~50-70 ms of GPU clock


def cuda_time_ms(torch, fn, inner: int, reps: int = 7,
                 hide_host: bool = True) -> float:
    """Median over ``reps`` of the mean device time of ``inner`` back-to-back
    calls, by CUDA events, after a warm-up. With ``hide_host`` a sleep kernel
    is queued first, so the host has enqueued every launch before the start
    event runs and the events time the device work, not Python's launch
    overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hide_host:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


# ---- phase 2 -------------------------------------------------------------

def make_inputs(torch, dev, P, K, density, seed, edges=False):
    """Times, centred-count weights (as the cuda backend builds them) and
    plans for one shape, made on the card from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    times = torch.rand(K, device=dev, generator=g) * 100.0 + 0.1
    counts = torch.randint(0, 6, (K,), device=dev, generator=g).double()
    weights = (2.0 * (counts - counts.mean()) + 1.0).float()
    plans = torch.rand((P, K), device=dev, generator=g) < density
    if edges:
        # +inf times (crashed devices) on devices no ordinary row selects;
        # one empty row and one row selecting every device.
        inf_cols = torch.arange(3, K, 41, device=dev)
        times[inf_cols] = torch.inf
        plans[:, inf_cols] = False
        plans[0] = False
        plans[1] = True
    return times, weights, plans.view(torch.int8)


def check_stats(torch, got, exp, weights, plans) -> float:
    got, exp = got.cpu(), exp.cpu()
    if not torch.equal(got[:, 0], exp[:, 0]):
        raise AssertionError("column 0 (masked max) differs from plain")
    if not torch.equal(got[:, 1], exp[:, 1]):
        raise AssertionError("column 1 (count) differs from plain")
    scale = torch.where(plans != 0, weights.abs()[None, :], 0.0).sum(
        1, dtype=torch.float64).clamp(min=1.0).cpu()
    err = (got[:, 2].double() - exp[:, 2].double()).abs()
    if not bool((err <= SUM_RTOL * scale).all()):
        raise AssertionError(f"column 2 off by {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def single_launch_ms(torch, prep, fn, reps: int = 21) -> float:
    """Median device time of one launch of ``fn(prep(r))``, by CUDA events
    around that launch alone, ``prep`` run first (outside the events) and a
    short sleep kernel queued before the start event to hide the host."""
    samples = []
    for r in range(reps + 2):
        x = prep(r)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES // 50)
        start.record()
        fn(x)
        end.record()
        end.synchronize()
        if r >= 2:
            samples.append(start.elapsed_time(end))
    return statistics.median(samples)


COLD_COPIES = 12    # 12 x 5.12 MB of plans at (512, 10,000): more than the L2


def phase_kernels(torch, dev) -> dict:
    """Kernel 2.1: every variant that serves each shape against the plain
    version, the picked variant's time beside the first design's (``row``),
    the plain version, the plans' host-to-device copy, the bound and the
    time of an empty kernel under the same timer; at the main path's shape
    also with the plans cold in the L2 and right after a fresh copy."""
    from repro_torch.core import scoring
    from repro_torch.kernels import sched_score as ss

    shapes = [
        # (label, P, K, density, edges)
        ("sa", 1, 10_000, 0.01, False),
        ("genetic-fleet-scale", 512, 10_000, 0.01, False),
        ("readme-fleet-block", 4096, 100_000, 0.01, False),
        ("ragged", 37, 1001, 0.10, True),
        ("edges-aligned", 64, 10_000, 0.01, True),
    ]
    floor_ms = cuda_time_ms(torch, lambda: torch.cuda._sleep(0), inner=50)
    rows = []
    for i, (label, P, K, density, edges) in enumerate(shapes):
        times, weights, plans = make_inputs(torch, dev, P, K, density,
                                            seed=1000 + i, edges=edges)
        aligned = plans.data_ptr() % 16 == 0
        variant = ss.kernel_variant(P, K, aligned)
        before = ss.launches_by_variant[variant]
        got = ss.plan_stats(times, weights, plans)
        if ss.launches_by_variant[variant] != before + 1:
            raise AssertionError(f"{label}: {variant} did not launch")
        exp = ss.plan_stats_ref(times, weights, plans)
        torch.cuda.synchronize()
        err = check_stats(torch, got, exp, weights, plans)
        checked = []
        for v in ss.VARIANTS:  # every design that serves the shape
            if ss.serves(v, P, K, aligned):
                other = ss.launch_variant(v, times, weights, plans)
                torch.cuda.synchronize()
                err = max(err, check_stats(torch, other, exp, weights, plans))
                checked.append(v)
        host_plans = (plans.cpu().numpy() != 0)  # numpy bool, as searchers hold
        big = P * K >= 10 ** 8
        kernel_ms = cuda_time_ms(
            torch, lambda: ss.plan_stats(times, weights, plans),
            inner=5 if big else 50)
        row_ms = cuda_time_ms(
            torch, lambda: ss.launch_variant("row", times, weights, plans),
            inner=5 if big else 50)
        plain_ms = cuda_time_ms(
            torch, lambda: ss.plan_stats_ref(times, weights, plans),
            inner=2 if big else 20)
        # A copy from pageable host memory blocks the host: nothing to hide.
        h2d_ms = cuda_time_ms(
            torch, lambda: scoring.h2d(host_plans.view("int8"), dev),
            inner=2 if big else 20, hide_host=False)
        nbytes = P * K + 8 * K + 12 * P
        ops = 3 * P * K
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
                    else "operations")
        row = dict(
            label=label, shape=[P, K], variant=variant,
            variants_checked=checked, max_abs_err=err,
            kernel_ms=kernel_ms, other_variant="row", other_ms=row_ms,
            floor_ms=floor_ms, plain_ms=plain_ms, h2d_ms=h2d_ms,
            bound_ms=bound_ms, bound_by=bound_by,
            selected=int((plans != 0).sum()))
        rows.append(row)
        if label == "genetic-fleet-scale":
            rows.append(cold_row(torch, dev, ss, scoring, row, times, weights,
                                 plans, host_plans, exp))
        del times, weights, plans, got, exp, host_plans
        torch.cuda.empty_cache()
    return {"plan_stats": rows, "floor_ms": floor_ms}


def cold_row(torch, dev, ss, scoring, warm, times, weights, plans,
             host_plans, exp) -> dict:
    """The main path's shape with the plans cold in the L2: launches
    rotate over ``COLD_COPIES`` copies, so each finds its plans evicted by
    the 11 launches before it; every variant that serves the shape is held
    to the plain version's ``exp`` on a copy evicted so. Also one launch at
    a time, by events around it alone: on the same plans again (warm), on
    the rotated copies (cold) and on a fresh host-to-device copy of the
    plans (as the main path launches), to show which of the two the main
    path resembles. Only what is measured here is in the row; the bound
    and the floor are the warm row's (the same inputs, the same timer)."""
    copies = [plans.clone() for _ in range(COLD_COPIES)]
    turn = iter(range(10 ** 9))
    P, K = plans.shape
    aligned = copies[0].data_ptr() % 16 == 0
    err, checked = 0.0, []
    for i, v in enumerate(ss.VARIANTS):
        if ss.serves(v, P, K, aligned):
            for c in copies[i + 1:]:  # evict copies[i] from the L2
                ss.launch_variant(v, times, weights, c)
            got = ss.launch_variant(v, times, weights, copies[i])
            torch.cuda.synchronize()
            err = max(err, check_stats(torch, got, exp, weights, copies[i]))
            checked.append(v)

    def rotated(fn):
        return lambda: fn(copies[next(turn) % COLD_COPIES])

    kernel_ms = cuda_time_ms(
        torch, rotated(lambda p: ss.plan_stats(times, weights, p)),
        inner=4 * COLD_COPIES)
    row_ms = cuda_time_ms(
        torch, rotated(lambda p: ss.launch_variant("row", times, weights, p)),
        inner=4 * COLD_COPIES)
    plain_ms = cuda_time_ms(
        torch, rotated(lambda p: ss.plan_stats_ref(times, weights, p)),
        inner=2 * COLD_COPIES)

    def launch(p):
        return ss.plan_stats(times, weights, p)

    single_warm = single_launch_ms(torch, lambda r: plans, launch)
    single_cold = single_launch_ms(
        torch, lambda r: copies[r % COLD_COPIES], launch)
    after_copy = single_launch_ms(
        torch, lambda r: scoring.h2d(host_plans.view("int8"), dev), launch)
    del copies
    return dict(
        label="genetic-fleet-scale cold", shape=warm["shape"],
        variant=warm["variant"], variants_checked=checked, max_abs_err=err,
        kernel_ms=kernel_ms, other_variant="row", other_ms=row_ms,
        floor_ms=warm["floor_ms"], plain_ms=plain_ms,
        bound_ms=warm["bound_ms"], bound_by=warm["bound_by"],
        selected=warm["selected"], copies=COLD_COPIES,
        single_launch_ms=dict(warm=single_warm, cold=single_cold,
                              after_copy=after_copy),
        after_copy_resembles=("warm" if abs(after_copy - single_warm)
                              <= abs(after_copy - single_cold) else "cold"))


# ---- phase 3 -------------------------------------------------------------

class ScoringClock:
    """Host time inside the scoring entry points (``score_plans``,
    ``score_plan_indices``) and inside their host-to-device copies
    (``h2d``), with the stream drained around each so the copy times are
    the copies'. Installed only for the measured run."""

    ENTRIES = ("score_plans", "score_plan_indices")

    def __init__(self, torch, scoring):
        self.torch, self.scoring = torch, scoring
        self.score_s = 0.0
        self.copy_s = 0.0
        self._orig = {n: getattr(scoring, n) for n in self.ENTRIES + ("h2d",)}

    def _timed(self, fn, attr):
        sync = self.torch.cuda.synchronize

        def wrapper(*a, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            setattr(self, attr, getattr(self, attr) + time.perf_counter() - t0)
            return out

        return wrapper

    def __enter__(self):
        for name in self.ENTRIES:
            setattr(self.scoring, name, self._timed(self._orig[name],
                                                    "score_s"))
        self.scoring.h2d = self._timed(self._orig["h2d"], "copy_s")
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.scoring, name, fn)
        return False


def fleet_spec(scheduler: str, backend: str):
    from repro_torch.experiment.presets import get_preset

    return get_preset("fleet-scale", scheduler=scheduler,
                      search_backend="host", scoring_backend=backend)


def check_records(records, n_sel: int, K: int) -> None:
    import numpy as np

    if not records:
        raise AssertionError("the run produced no records")
    for r in records:
        ids = np.asarray(r.device_ids)
        if ids.size != n_sel or np.unique(ids).size != n_sel:
            raise AssertionError(f"record {r.job}/{r.round_idx}: "
                                 f"{ids.size} ids, expected {n_sel} distinct")
        if ids.min() < 0 or ids.max() >= K:
            raise AssertionError("device id out of range")
        vals = (r.round_time, r.cost, r.fairness, r.accuracy, r.est_cost)
        if not all(v is not None and np.isfinite(v) for v in vals):
            raise AssertionError(f"non-finite record values {vals}")
        if r.round_time <= 0:
            raise AssertionError("round_time must be positive")


def compare_runs(a, b) -> float:
    """Identical device ids and round times; est_cost within
    ``1e-5 + 1e-5 * |est_cost|`` (the scoring tolerance)."""
    import numpy as np

    if len(a) != len(b):
        raise AssertionError(f"{len(a)} vs {len(b)} records")
    worst = 0.0
    for ra, rb in zip(a, b):
        if not np.array_equal(ra.device_ids, rb.device_ids):
            raise AssertionError(f"device_ids differ at job {ra.job} round "
                                 f"{ra.round_idx}")
        if ra.round_time != rb.round_time:
            raise AssertionError(f"round_time differs at job {ra.job} round "
                                 f"{ra.round_idx}")
        d = abs(ra.est_cost - rb.est_cost)
        worst = max(worst, d)
        if d > 1e-5 + 1e-5 * abs(rb.est_cost):
            raise AssertionError(f"est_cost differs by {d}")
    return worst


def phase_main(torch) -> dict:
    from repro_torch.core import scoring
    from repro_torch.kernels import sched_score

    spec = fleet_spec("genetic", "cuda")
    K, n_sel = spec.effective_num_devices(), spec.effective_n_sel()
    exp = spec.build(device="cuda")
    sched = exp.engine.scheduler
    decisions = 0
    schedule = sched.schedule

    def counted(ctx):
        nonlocal decisions
        decisions += 1
        return schedule(ctx)

    sched.schedule = counted
    with ScoringClock(torch, scoring) as clock:
        reset_plan_stats_counts(sched_score)
        t0 = time.perf_counter()
        result = exp.run()
        wall_s = time.perf_counter() - t0
        launches = sched_score.launches
        by_variant = dict(sched_score.launches_by_variant)
    expected = (sched.generations + 1) * decisions
    if decisions == 0 or launches != expected:
        raise AssertionError(f"plan_stats launched {launches} times for "
                             f"{decisions} decisions, expected {expected}")
    if sum(by_variant.values()) != launches:
        raise AssertionError(f"launches by variant {by_variant} do not add "
                             f"up to {launches}")
    check_records(result.records, n_sel, K)

    t0 = time.perf_counter()
    torch_run = fleet_spec("genetic", "torch").run(device="cuda")
    torch_wall_s = time.perf_counter() - t0
    est_diff = compare_runs(result.records, torch_run.records)

    greedy = fleet_spec("greedy", "cuda").run(device="cuda")
    check_records(greedy.records, n_sel, K)
    greedy_np = fleet_spec("greedy", "numpy").run(device="cuda")
    greedy_diff = compare_runs(greedy_np.records, greedy.records)
    return dict(
        preset="fleet-scale", scheduler="genetic", search_backend="host",
        K=K, n_sel=n_sel, population=sched.population,
        generations=sched.generations, rounds=len(result.records),
        decisions=decisions, launches=launches,
        launches_by_variant=by_variant,
        launches_per_decision=launches / decisions,
        wall_s=wall_s, torch_backend_wall_s=torch_wall_s,
        scoring_s=clock.score_s, copy_s=clock.copy_s,
        copy_share_of_scoring=(clock.copy_s / clock.score_s
                               if clock.score_s else None),
        torch_vs_cuda_max_est_cost_diff=est_diff,
        greedy_rounds=len(greedy.records),
        greedy_vs_numpy_max_est_cost_diff=greedy_diff)


# ---- phase 4 -------------------------------------------------------------

SCATTER_TOL = 1e-5             # relative plus absolute (tests/test_fl.py)
VGG16_FC = 4096 * 4096         # VGG16's largest leaf (fc2 weight)
VGG16_CONV = 3 * 3 * 512 * 512


def check_close(got, exp, what: str) -> float:
    """max |got - exp|, failing unless |got - exp| <= tol * (1 + |exp|)."""
    err = (got.double() - exp.double()).abs()
    if not bool((err <= SCATTER_TOL * (1.0 + exp.double().abs())).all()):
        raise AssertionError(f"{what}: off by {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def topk_stream(torch, dev, n, size, ratio, seed, idx_dtype):
    """(vals, idx, w) as the main path makes them: each device's top-k of a
    random delta row, weights from partition-size-like draws."""
    from repro_torch.optim.compression import topk_count

    g = torch.Generator(device=dev).manual_seed(seed)
    k = topk_count(ratio, size)
    flat = torch.randn((n, size), device=dev, generator=g)
    idx = torch.topk(flat.abs(), k, dim=1).indices
    vals = torch.gather(flat, 1, idx)
    w = torch.rand(n, device=dev, generator=g) + 0.5
    del flat
    return vals, idx.to(idx_dtype).contiguous(), w / w.sum()


def edge_streams(torch, dev):
    from repro_torch.kernels import scatter_add as sa

    g = torch.Generator(device=dev).manual_seed(77)

    def rand(n, k, size, lo=0, dtype=None):
        vals = torch.randn((n, k), device=dev, generator=g)
        idx = torch.randint(lo, size, (n, k), device=dev, generator=g)
        w = torch.rand(n, device=dev, generator=g) + 0.1
        return vals, idx.to(dtype or torch.int64), w

    out = []
    v, i, w = rand(3, 17, 64)
    i[:, ::4] = -1                                  # padding
    out.append(("negative-idx", v, i, w, 64))
    out.append(("repeat-in-row", *rand(4, 33, 10), 10))
    v, i, w = rand(2, 10, 8)
    i[0, 0], i[1, 3], i[1, 4] = 8, 100, 2 ** 40     # past the end
    out.append(("idx-ge-size", v, i, w, 8))
    v, i, w = rand(5, 3, 1)
    i[0, 1] = -7
    out.append(("size-1", v, i, w, 1))
    out.append(("ragged-nk-int32", *rand(7, 301, 1000, dtype=torch.int32),
                1000))
    # the edges of the tile size T: one tile, one short of it, one past it
    # (with an entry in the second tile's one float), 800 entries each
    T = sa.TILE
    out.append(("size T", *rand(2, 400, T), T))
    out.append(("size T - 1", *rand(2, 400, T - 1), T - 1))
    v, i, w = rand(2, 400, T + 1)
    i[0, :3] = T
    out.append(("size T + 1", v, i, w, T + 1))
    v, i, w = rand(10, 3000, 4 * T)
    i.fill_(T + 77)
    out.append(("every entry on one position", v, i, w, 4 * T))
    out.append(("small output, long stream", *rand(20, 1000, 1000), 1000))
    return out


CROWDED_SEEDS = 20


def crowded_gaps(torch, dev) -> dict:
    """The edge stream "every entry on one position" (10 x 3,000 randn
    entries onto one float) drawn from CROWDED_SEEDS seeds: each seed's
    kernel output held to the plain version at SCATTER_TOL, and the gap of
    each side to the float64 sum of the same terms, the max over seeds."""
    from repro_torch.kernels import scatter_add as sa

    T = sa.TILE
    gaps = {"kernel": [], "plain": [], "kernel_vs_plain": []}
    for seed in range(CROWDED_SEEDS):
        g = torch.Generator(device=dev).manual_seed(7700 + seed)
        vals = torch.randn((10, 3000), device=dev, generator=g)
        w = torch.rand(10, device=dev, generator=g) + 0.1
        idx = torch.full((10, 3000), T + 77, dtype=torch.int64, device=dev)
        got = sa.launch_variant("atomic", vals, idx, w, 4 * T)
        exp = sa.scatter_add_ref(vals, idx, w, 4 * T)
        exact = float((vals.double() * w.double()[:, None]).sum())
        gaps["kernel_vs_plain"].append(check_close(
            got, exp, f"scatter_add every entry on one position, seed "
            f"{7700 + seed}"))
        gaps["kernel"].append(abs(float(got[T + 77]) - exact))
        gaps["plain"].append(abs(float(exp[T + 77]) - exact))
    return dict(seeds=CROWDED_SEEDS, tol=SCATTER_TOL,
                **{f"max_{k}_gap": max(v) for k, v in gaps.items()},
                **{f"{k}_gaps": v for k, v in gaps.items()})


def scatter_bound(n, k, idx_bytes, size):
    nbytes = n * k * (4 + idx_bytes) + 4 * n + 4 * size
    ops = 2 * n * k                                  # multiply + add each
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def other_scatter_variant(sa, n, k, size, variant):
    """The design beside ``variant`` that the C entry takes for this shape
    (``scatter_add.serves``), or None."""
    return next((v for v in sa.VARIANTS
                 if v != variant and sa.serves(v, n, k, size)), None)


def phase_fl_kernels(torch, dev) -> dict:
    from repro_torch.configs.paper_models import lenet5
    from repro_torch.kernels import scatter_add as sa
    from repro_torch.models.cnn_zoo import cnn_init
    from repro_torch.tree import tree_leaves

    main = [("vgg16-fc r=0.01", 10, VGG16_FC, 0.01, torch.int64),
            ("vgg16-fc r=0.1", 10, VGG16_FC, 0.1, torch.int64),
            ("vgg16-conv3x3x512x512 r=0.01", 10, VGG16_CONV, 0.01,
             torch.int64),
            ("vgg16-fc r=0.01 int32", 10, VGG16_FC, 0.01, torch.int32)]
    for j, leaf in enumerate(tree_leaves(cnn_init(lenet5(), device="cpu"))):
        main.append((f"lenet5-leaf{j}{tuple(leaf.shape)} r=0.01", 5,
                     leaf.numel(), 0.01, torch.int64))
    rows = []
    cases = [(label, *topk_stream(torch, dev, n, size, ratio, 2000 + i,
                                  dtype), size, True)
             for i, (label, n, size, ratio, dtype) in enumerate(main)]
    cases += [(label, v, i, w, size, False)
              for label, v, i, w, size in edge_streams(torch, dev)]
    for label, vals, idx, w, size, is_main in cases:
        n, k = vals.shape
        variant = sa.kernel_variant(n, k, size)
        before = sa.launches_by_variant[variant]
        got = sa.scatter_add(vals, idx, w, size)
        exp = sa.scatter_add_ref(vals, idx, w, size)
        torch.cuda.synchronize()
        if sa.launches_by_variant[variant] != before + 1:
            raise AssertionError(f"scatter_add {label}: the {variant} "
                                 "variant did not launch")
        err = check_close(got, exp, f"scatter_add {label}")
        big = n * k >= 10 ** 6
        kernel_ms = cuda_time_ms(
            torch, lambda: sa.scatter_add(vals, idx, w, size),
            inner=10 if big else 50)
        # the other design that serves the shape, held to the same
        # tolerance
        other = other_scatter_variant(sa, n, k, size, variant)
        other_ms = None
        if other:
            check_close(sa.launch_variant(other, vals, idx, w, size), exp,
                        f"scatter_add {label} ({other})")
            other_ms = cuda_time_ms(
                torch, lambda: sa.launch_variant(other, vals, idx, w, size),
                inner=10 if big else 50)
        plain_ms = cuda_time_ms(
            torch, lambda: sa.scatter_add_ref(vals, idx, w, size),
            inner=5 if big else 20)
        library_ms = None
        if is_main:  # index_add_ refuses padding; main streams have none
            flat_idx = idx.reshape(-1)
            library_ms = cuda_time_ms(
                torch, lambda: torch.zeros(size, device=dev).index_add_(
                    0, flat_idx, (vals * w[:, None]).reshape(-1)),
                inner=10 if big else 50)
        bound_ms, bound_by = scatter_bound(n, k, idx.element_size(), size)
        rows.append(dict(label=label, main=is_main, n=n, k=k, size=size,
                         idx_dtype=str(idx.dtype), variant=variant,
                         max_abs_err=err, kernel_ms=kernel_ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         other_variant=other, other_ms=other_ms))
    del cases
    torch.cuda.empty_cache()
    return {"scatter_add": rows, "crowded": crowded_gaps(torch, dev)}


# ---- phase 5 -------------------------------------------------------------

# Group A's lr of 0.05 (and 0.02, 0.01) gives a NaN loss in VGG16's first
# round on this synthetic data; the reference's math diverges the same way
# (tests/test_torch_runtime.py::test_group_a_lr_diverges_alike). 0.005 is
# the largest rate tried that stays finite.
VGG16_LR = 0.005


def vgg16_spec():
    """One VGG16 job over 100 non-IID devices at group A's local epochs and
    batch size (``configs/paper_models.py::group_a``) and ``VGG16_LR``."""
    from repro_torch.experiment.spec import ExperimentSpec, JobSpec, PoolSpec

    job = JobSpec(name="paper-vgg16", model="paper-vgg16",
                  target_metric=0.55, max_rounds=2, local_epochs=5,
                  batch_size=30, lr=VGG16_LR)
    return ExperimentSpec(name="vgg16-real-fl-greedy", jobs=(job,),
                          pool=PoolSpec(num_devices=100, seed=5),
                          scheduler="greedy", runtime="real_fl",
                          non_iid=True, n_sel=10)


def check_fl_records(records, what: str) -> None:
    import numpy as np

    if not records:
        raise AssertionError(f"{what}: no records")
    for r in records:
        if not (np.isfinite(r.loss) and np.isfinite(r.accuracy)):
            raise AssertionError(f"{what}: non-finite metrics {r}")
        if not 0.0 <= r.accuracy <= 1.0:
            raise AssertionError(f"{what}: accuracy {r.accuracy}")


def run_traced(torch, spec) -> tuple:
    """Build and run ``spec`` on the card with the tracer on; returns
    (result, wall seconds, per-span-name lists of durations in ms, runtime).
    A ``fused_round`` span queues a round's training; the ``metrics_sync``
    span after it waits for the card to finish it."""
    from repro_torch.monitoring import trace

    exp = spec.build(device="cuda")
    trace.get_tracer().clear()
    trace.enable()
    try:
        t0 = time.perf_counter()
        result = exp.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        trace.disable()
    spans = {"fused_round": [], "metrics_sync": []}
    for e in trace.get_tracer().events():
        if e["name"] in spans:
            spans[e["name"]].append(e["dur"] / 1e3)
    trace.get_tracer().clear()
    check_fl_records(result.records, spec.name)
    if len(spans["fused_round"]) != len(result.records):
        raise AssertionError(f"{spec.name}: {len(spans['fused_round'])} "
                             f"fused_round spans for {len(result.records)} "
                             "records")
    return result, wall_s, spans, exp.engine.runtime


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_fl_main(torch) -> dict:
    from repro_torch.experiment.presets import get_preset
    from repro_torch.fl.aggregation import fedavg, fedavg_compressed
    from repro_torch.fl.runtime import _local_train_batch
    from repro_torch.kernels import ops, scatter_add as sa, sched_score
    from repro_torch.models.cnn_zoo import cnn_loss_and_accuracy
    from repro_torch.optim.compression import topk_count
    from repro_torch.tree import tree_leaves

    # The main path: both training runs and the compressed aggregation,
    # with every launch count at 0 just before and read just after.
    sa.launches = 0
    sa.launches_by_variant.update(dict.fromkeys(sa.VARIANTS, 0))
    sched_score.launches = 0
    two = get_preset("real-fl-two-job", scheduler="greedy", rounds=3)
    two_res, two_wall, two_spans, _ = run_traced(torch, two)
    vgg = vgg16_spec()
    vgg_res, vgg_wall, vgg_spans, rt = run_traced(torch, vgg)

    grp = rt.groups[0]
    ids = torch.as_tensor(vgg_res.records[-1].device_ids,
                          device=grp.partition.device)
    g = rt.params_of(0)
    idx = grp.partition[0][ids]
    locals_, train_s = timed(torch, lambda: _local_train_batch(
        g, grp.cfg, grp.x[0][idx], grp.y[0][idx], grp.epochs,
        grp.batch_size, grp.lr))
    w = grp.sizes[0][ids]
    ratio = 0.01
    comp, comp_s = timed(torch, lambda: fedavg_compressed(
        g, locals_, w, ratio, impl="cuda"))
    launches, plan_launches = sa.launches, sched_score.launches
    by_variant = dict(sa.launches_by_variant)
    leaves = len(tree_leaves(g))
    if launches != leaves:
        raise AssertionError(f"scatter_add launched {launches} times for "
                             f"{leaves} leaves")
    # each leaf's variant by the rule: fc2 (4096 x 4096) atomic, every bias
    # tile; the launches by variant must add up to them
    leaf_variants = [sa.kernel_variant(
        int(ids.numel()), topk_count(ratio, gl.numel()), gl.numel())
        for gl in tree_leaves(g)]
    want = {v: leaf_variants.count(v) for v in sa.VARIANTS}
    if by_variant != want:
        raise AssertionError(f"scatter_add launches by variant {by_variant},"
                             f" the leaves want {want}")
    fc2 = [v for gl, v in zip(tree_leaves(g), leaf_variants)
           if tuple(gl.shape) == (4096, 4096)]
    biases = {v for gl, v in zip(tree_leaves(g), leaf_variants)
              if gl.dim() == 1}
    if fc2 != ["atomic"] or biases != {"tile"}:
        raise AssertionError(f"fc2 took {fc2} and the biases {biases}")

    ref = fedavg_compressed(g, locals_, w, ratio, impl="ref")
    err = max(check_close(a, b, "fedavg_compressed cuda vs ref")
              for a, b in zip(tree_leaves(comp), tree_leaves(ref)))
    full = fedavg_compressed(g, locals_, w, 1.0, impl="cuda")
    plain, avg_s = timed(torch, lambda: fedavg(locals_, w))
    full_err = max(check_close(a, b, "fedavg_compressed(1.0) vs fedavg")
                   for a, b in zip(tree_leaves(full), tree_leaves(plain)))
    del ref, full

    def eval_once():
        with torch.no_grad():
            return cnn_loss_and_accuracy(plain, grp.cfg, grp.eval_x[0],
                                         grp.eval_y[0])

    _, eval_s = timed(torch, eval_once)

    # Why VGG16_LR: VGG16's first-round loss at group A's lr and between
    # (recorded, not checked).
    lr_probe = {}
    for lr in (0.05, 0.01, VGG16_LR):
        probe = vgg.replace(jobs=(dataclasses.replace(
            vgg.jobs[0], lr=lr, max_rounds=1),))
        lr_probe[str(lr)] = probe.run(device="cuda").records[0].loss

    # fedavg_compressed's device time, split into top-k and kernel.
    wn = w / w.sum()
    streams = []
    for gl, sl in zip(tree_leaves(g), tree_leaves(locals_)):
        flat = (sl - gl[None]).reshape(sl.shape[0], -1)
        k = topk_count(ratio, gl.numel())
        ix = torch.topk(flat.abs(), k, dim=1).indices
        streams.append((torch.gather(flat, 1, ix), ix, gl.numel()))

    def topk_only():
        for gl, sl in zip(tree_leaves(g), tree_leaves(locals_)):
            flat = (sl - gl[None]).reshape(sl.shape[0], -1)
            ix = torch.topk(flat.abs(), topk_count(ratio, gl.numel()),
                            dim=1).indices
            torch.gather(flat, 1, ix)

    def kernel_only():
        for v, ix, size in streams:
            ops.scatter_add(v, ix, wn, size, impl="cuda")

    total_ms = cuda_time_ms(
        torch, lambda: fedavg_compressed(g, locals_, w, ratio, impl="cuda"),
        inner=3)
    topk_ms = cuda_time_ms(torch, topk_only, inner=3)
    kernel_ms = cuda_time_ms(torch, kernel_only, inner=3)
    # each leaf's stream of this cohort: its variant beside the other
    # design (phase 4's rule), each held to the plain version
    per_leaf = []
    for v, ix, size in streams:
        n, k = v.shape
        variant = sa.kernel_variant(n, k, size)
        other = other_scatter_variant(sa, n, k, size, variant)
        exp = sa.scatter_add_ref(v, ix, wn, size)
        row = dict(size=size, k=k, variant=variant, other_variant=other)
        for key, var in (("ms", variant), ("other_ms", other)):
            if var is None:
                row[key] = None
                continue
            check_close(sa.launch_variant(var, v, ix, wn, size), exp,
                        f"fedavg_compressed leaf of {size} ({var})")
            row[key] = cuda_time_ms(
                torch, lambda: sa.launch_variant(var, v, ix, wn, size),
                inner=5)
        per_leaf.append(row)
    return dict(
        two_job=dict(preset="real-fl-two-job", scheduler="greedy",
                     rounds=len(two_res.records),
                     fused_round=len(two_spans["fused_round"]),
                     fused_round_ms=two_spans["fused_round"],
                     metrics_sync_ms=two_spans["metrics_sync"],
                     wall_s=two_wall,
                     s_per_round=two_wall / len(two_res.records),
                     accuracy=[r.accuracy for r in two_res.records]),
        vgg16=dict(spec=vgg.name, params=grp.cfg.param_count(),
                   rounds=len(vgg_res.records),
                   fused_round=len(vgg_spans["fused_round"]),
                   fused_round_ms=vgg_spans["fused_round"],
                   metrics_sync_ms=vgg_spans["metrics_sync"],
                   wall_s=vgg_wall,
                   s_per_round=vgg_wall / len(vgg_res.records),
                   accuracy=[r.accuracy for r in vgg_res.records],
                   cohort=int(ids.numel()),
                   local_sgd_s=train_s, fedavg_s=avg_s, eval_s=eval_s,
                   fedavg_compressed_s=comp_s,
                   first_round_loss_by_lr=lr_probe),
        compressed=dict(ratio=ratio, leaves=leaves, launches=launches,
                        launches_by_variant=by_variant,
                        plan_stats_launches=plan_launches,
                        max_abs_err_vs_ref=err,
                        ratio_1_max_abs_err_vs_fedavg=full_err,
                        total_ms=total_ms, topk_ms=topk_ms,
                        kernel_ms=kernel_ms, per_leaf=per_leaf))


# ---- phase 6 -------------------------------------------------------------

BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
ATTN_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 3e-2)}  # flash, decode
QWEN = dict(H=16, KV=8, D=128)  # qwen3-1.7b's attention


def tdtype(torch, name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def attn_close(got, exp, tol, what: str) -> float:
    """max |got - exp|, failing unless |got - exp| <= tol * (1 + |exp|)
    (the reference tests' atol = rtol = tol)."""
    got, exp = got.float(), exp.float()
    err = (got - exp).abs()
    if not bool(got.isfinite().all()) or not bool(
            (err <= tol * (1.0 + exp.abs())).all()):
        raise AssertionError(f"{what}: off by {float(err.max())} "
                             f"(tolerance {tol})")
    return float(err.max()) if err.numel() else 0.0


# The bf16 kernels held tightly: the plain version run in f32 on the same
# bf16-rounded inputs is the yardstick, and each output row (D values) must
# lie within BF16_ROW_RTOL of it in the row's own L2 norm. Rounding p and
# the output to bf16, as the kernels do over f32 logits, costs at most
# 4e-3 of a row in a CPU emulation at (1, 2048) causal; the plain bf16
# version, which also rounds its logits to bf16, reaches 1e-2. One key
# tile of 64 left out of a 4096-key row costs about 0.12.
BF16_ROW_RTOL = 1e-2


def bf16_row_err(torch, got, plain, args, what: str, chunk: int) -> float:
    """Largest ||got - plain_f32|| / ||plain_f32|| over the output rows,
    failing above BF16_ROW_RTOL. ``plain`` runs on the f32 copies of
    ``args``' floating tensors, ``chunk`` batch entries at a time."""
    worst = 0.0
    for b0 in range(0, got.shape[0], chunk):
        part = [a[b0:b0 + chunk].float() if a.is_floating_point()
                else a[b0:b0 + chunk] for a in args]
        exp = plain(*part).float()
        del part
        err = (got[b0:b0 + chunk].float() - exp).norm(dim=-1)
        rel = err / exp.norm(dim=-1).clamp_min(1e-30)
        worst = max(worst, float(rel.max()))
        del exp, err, rel
    if not worst <= BF16_ROW_RTOL:
        raise AssertionError(f"{what}: a row is off by {worst} of its norm "
                             f"against the f32 plain version (limit "
                             f"{BF16_ROW_RTOL})")
    return worst


def attn_bound(nbytes: float, ops: float, dtype: str):
    rate = BF16_OPS_PER_S if dtype == "bfloat16" else F32_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_pairs(S: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of one (batch, head)."""
    import numpy as np

    i = np.arange(S, dtype=np.int64)
    hi = i if causal else np.full(S, S - 1, np.int64)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(S, np.int64)
    return int((hi - lo + 1).sum())


FLASH_CASES = [
    # label, B, S, H, KV, D, causal, window, dtypes, main
    ("qwen3-1.7b prefill", 2, 4096, 16, 8, 128, True, None,
     ("bfloat16", "float32"), True),
    ("long-context", 1, 16384, 16, 8, 128, True, None, ("bfloat16",), True),
    ("MQA KV=1, S=1000", 2, 1000, 8, 1, 128, True, None,
     ("bfloat16", "float32"), False),
    ("MHA KV=H, S=777", 1, 777, 8, 8, 128, True, None,
     ("bfloat16", "float32"), False),
    ("G=4 (qwen3-8b)", 1, 2048, 32, 8, 128, True, None, ("bfloat16",), False),
    ("G=16 (glm4-9b)", 1, 1024, 32, 2, 128, True, None,
     ("bfloat16", "float32"), False),
    ("hymba-1.5b prefill (2, 4096), window 1024", 2, 4096, 25, 5, 64, True,
     1024, ("bfloat16",), True),
    ("kimi-k2 prefill (1, 4096), 64/8 heads of 112", 1, 4096, 64, 8, 112,
     True, None, ("bfloat16", "float32"), True),
    ("window 1024, 25/5 heads, D=64 (hymba)", 1, 3000, 25, 5, 64, True, 1024,
     ("bfloat16", "float32"), False),
    ("D=64, S=200", 2, 200, 8, 2, 64, True, None, ("bfloat16", "float32"),
     False),
    ("D=256, S=1000", 1, 1000, 8, 4, 256, True, None,
     ("bfloat16", "float32"), False),
    ("non-causal", 2, 500, 16, 8, 128, False, None, ("bfloat16", "float32"),
     False),
]

def decode_cases():
    """label, B, H, KV, D, T, lengths ("spread" | "edges"), dtypes, main."""
    from repro_torch.config.shapes import SHAPES

    d32 = SHAPES["decode_32k"]
    return [
        ("qwen3-1.7b 16 slots", 16, 16, 8, 128, 4096, "spread",
         ("bfloat16", "float32"), True),
        ("decode_32k layer", d32.global_batch, 16, 8, 128, d32.seq_len,
         "spread", ("bfloat16",), True),
        ("kimi-k2 16 slots, 64/8 heads of 112", 16, 64, 8, 112, 4096,
         "spread", ("bfloat16", "float32"), True),
        ("64/8 heads of 112, T=777 (kimi-k2)", 3, 64, 8, 112, 777, "edges",
         ("bfloat16", "float32"), False),
        ("MQA KV=1, T=1000", 3, 8, 1, 128, 1000, "edges",
         ("bfloat16", "float32"), False),
        ("MHA KV=H, T=777", 3, 8, 8, 128, 777, "edges",
         ("bfloat16", "float32"), False),
        ("G=4 (qwen3-8b)", 4, 32, 8, 128, 2048, "edges", ("bfloat16",), False),
        ("G=16 (glm4-9b)", 4, 32, 2, 128, 1500, "edges",
         ("bfloat16", "float32"), False),
        ("25/5 heads, D=64, T=1024 ring (hymba)", 3, 25, 5, 64, 1024,
         "edges", ("bfloat16", "float32"), False),
        ("D=256, T=900", 3, 8, 4, 256, 900, "edges", ("bfloat16", "float32"),
         False),
    ]


def decode_lengths(torch, dev, B, T, kind, g):
    if kind == "spread":  # evenly over [1, T], shuffled
        lin = torch.linspace(1, T, B, device=dev).round().int()
        return lin[torch.randperm(B, device=dev, generator=g)].contiguous()
    base = torch.tensor([0, 1, T], dtype=torch.int32, device=dev)
    extra = torch.randint(2, T, (max(B - 3, 0),), device=dev, generator=g)
    return torch.cat([base, extra.int()])[:B].contiguous()


def sdpa_decode(torch, q, k, v, length):
    """The library yardstick: one scaled_dot_product_attention call, the G
    query heads of a kv-head as G query rows against its cache, with a
    boolean length mask."""
    import torch.nn.functional as F

    B, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    mask = (torch.arange(T, device=q.device)[None, :]
            < length[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(
        q.view(B, KV, H // KV, D), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask)


def decode_as(torch, da, variant, q, k, v, length):
    """One launch of the named decode variant (the old design, ``simt``,
    beside the one ``kernel_variant`` picks), never counted."""
    out = torch.empty_like(q)
    da.launch_variant(variant, q, k, v, length, out)
    return out


def gmm_as(torch, gmm, variant, x, w):
    """One launch of the named MoE grouped-matmul variant through the C
    entry, on the wrapper's inputs: the variant ``kernel_variant`` passes
    over, timed beside the one it picks (never counted in the wrapper's
    launches)."""
    E, C, din = x.shape
    out = torch.empty((E, C, w.shape[2]), dtype=x.dtype, device=x.device)
    rc = gmm._entry()(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                      gmm.DTYPES[x.dtype], gmm.VARIANTS.index(variant), E, C,
                      din, w.shape[2], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_gmm {variant} launch failed: CUDA error {rc}")
    return out


def phase_lm_kernels(torch, dev) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(1300)
    flash_rows, decode_rows = [], []
    for label, B, S, H, KV, D, causal, window, dtypes, main in FLASH_CASES:
        for dname in dtypes:
            dt = tdtype(torch, dname)
            q = torch.randn((B, S, H, D), device=dev, generator=g, dtype=dt)
            k = torch.randn((B, S, KV, D), device=dev, generator=g, dtype=dt)
            v = torch.randn((B, S, KV, D), device=dev, generator=g, dtype=dt)
            variant = fa.kernel_variant(dt, B, S, H, KV, D, window)
            before = fa.launches_by_variant[variant]
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            exp = fa.attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            if fa.launches_by_variant[variant] != before + 1:
                raise AssertionError(f"flash {label} {dname}: the {variant} "
                                     "variant did not launch")
            err = attn_close(got, exp, ATTN_TOL[dname][0],
                             f"flash {label} {dname}")
            del exp
            row_err = None
            if dname == "bfloat16":
                row_err = bf16_row_err(
                    torch, got, lambda *a: fa.attention_ref(
                        *a, causal=causal, window=window), (q, k, v),
                    f"flash {label} {dname}", chunk=B)
            del got
            big = B * S >= 8192
            kernel_ms = cuda_time_ms(
                torch, lambda: fa.flash_attention(q, k, v, causal, window),
                inner=3 if big else 10, reps=5)
            plain_ms = cuda_time_ms(
                torch, lambda: fa.attention_ref(q, k, v, causal, window),
                inner=1 if big else 3, reps=3)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa = dict(is_causal=causal, enable_gqa=True)
            if window is not None:  # a boolean mask, built once; SDPA's
                # fused paths take no mask with enable_gqa, so K and V are
                # expanded to the H heads once, outside the timing
                idx = torch.arange(S, device=dev)
                keep = idx[:, None] - idx[None, :] < window
                if causal:
                    keep &= idx[:, None] >= idx[None, :]
                kt, vt = (x.repeat_interleave(H // KV, dim=1)
                          for x in (kt, vt))
                sdpa = dict(attn_mask=keep)
            library_ms = cuda_time_ms(
                torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                              **sdpa),
                inner=3 if big else 10, reps=5)
            del qt, kt, vt, sdpa
            pairs = flash_pairs(S, causal, window)
            nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * \
                k.element_size()
            bound_ms, bound_by = attn_bound(nbytes, 4 * D * pairs * H * B,
                                            dname)
            flash_rows.append(dict(
                label=label, dtype=dname, main=main, variant=variant,
                shape=[B, S, H, KV, D], causal=causal, window=window,
                max_abs_err=err, bf16_row_err_vs_f32=row_err,
                kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                pairs=pairs * B * H,
                tflops=4 * D * pairs * H * B / (kernel_ms * 1e9)))
            del q, k, v
            torch.cuda.empty_cache()
    for label, B, H, KV, D, T, kind, dtypes, main in decode_cases():
        for dname in dtypes:
            dt = tdtype(torch, dname)
            q = torch.randn((B, H, D), device=dev, generator=g, dtype=dt)
            k = torch.randn((B, T, KV, D), device=dev, generator=g, dtype=dt)
            v = torch.randn((B, T, KV, D), device=dev, generator=g, dtype=dt)
            length = decode_lengths(torch, dev, B, T, kind, g)
            variant = da.kernel_variant(dt, B, H, KV, D, T)
            before = da.launches_by_variant[variant]
            got = da.decode_attention(q, k, v, length)
            exp = da.decode_attention_ref(q, k, v, length)
            torch.cuda.synchronize()
            if da.launches_by_variant[variant] != before + 1:
                raise AssertionError(f"decode {label} {dname}: the {variant} "
                                     "variant did not launch")
            tol = ATTN_TOL[dname][1]
            err = attn_close(got, exp, tol, f"decode {label} {dname}")
            del exp
            big = B * T >= 10 ** 6
            # times before any rows are poisoned: the plain version, the
            # library call and, in bf16, the old design (simt)
            plain_ms = cuda_time_ms(
                torch, lambda: da.decode_attention_ref(q, k, v, length),
                inner=1 if big else 5, reps=3)
            library_ms = cuda_time_ms(
                torch, lambda: sdpa_decode(torch, q, k, v, length),
                inner=2 if big else 10, reps=3)
            other = "simt" if variant != "simt" else None
            other_ms = None
            if other:  # the old design, held to the plain version too
                attn_close(decode_as(torch, da, other, q, k, v, length),
                           da.decode_attention_ref(q, k, v, length), tol,
                           f"decode {label} {dname} ({other})")
                other_ms = cuda_time_ms(
                    torch, lambda: decode_as(torch, da, other, q, k, v,
                                             length),
                    inner=5 if big else 20, reps=5)
            row_err = None
            if dname == "bfloat16":  # 16 sequences at a time: f32 copies
                row_err = bf16_row_err(
                    torch, got, da.decode_attention_ref, (q, k, v, length),
                    f"decode {label} {dname}", chunk=16)
            if not main:  # rows past each length must not matter
                for b, n in enumerate(length.tolist()):
                    if 0 < n < T:
                        k[b, n:] = 1e4
                        v[b, n:] = float("nan")
                again = da.decode_attention(q, k, v, length)
                if not torch.equal(again, got):
                    raise AssertionError(f"decode {label} {dname}: rows past "
                                         "the length changed the output")
                del again
            del got
            kernel_ms = cuda_time_ms(
                torch, lambda: da.decode_attention(q, k, v, length),
                inner=5 if big else 20, reps=5)
            rows = sum(min(n, T) if n > 0 else T for n in length.tolist())
            nbytes = (2 * rows * KV * D + 2 * B * H * D) * k.element_size()
            bound_ms, bound_by = attn_bound(nbytes, 4 * D * H * rows, dname)
            decode_rows.append(dict(
                label=label, dtype=dname, main=main, variant=variant,
                shape=[B, H, KV, D, T],
                lengths=kind, max_abs_err=err, bf16_row_err_vs_f32=row_err,
                kernel_ms=kernel_ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, other_variant=other, other_ms=other_ms,
                bound_share=bound_ms / kernel_ms, cache_rows_read=rows))
            del q, k, v, length
            torch.cuda.empty_cache()
    grad = flash_grad_check(torch, dev)
    return {"flash_attention": flash_rows, "decode_attention": decode_rows,
            "flash_grad_max_abs_err": grad}


def flash_grad_check(torch, dev) -> float:
    """The autograd.Function's gradient (kernel forward, plain backward)
    against the plain version's autograd, within 5e-4."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(1301)
    leaves = [torch.randn(s, device=dev, generator=g).requires_grad_()
              for s in ((2, 256, 8, 64), (2, 256, 2, 64), (2, 256, 2, 64))]
    (fa.flash_attention(*leaves) ** 2).sum().backward()
    plain = [t.detach().clone().requires_grad_() for t in leaves]
    (fa.attention_ref(*plain) ** 2).sum().backward()
    return max(attn_close(a.grad, b.grad, 5e-4, "flash gradient")
               for a, b in zip(leaves, plain))


# ---- phase 7 -------------------------------------------------------------

SERVE = dict(requests=32, slots=16, max_new=32, cache_len=4096)
PREFILL = (2, 4096)            # (B, S) of the prefill call
LONG_CACHE = 4000              # lengths of the timed long-cache decode step
# The whole f32 model, kernels against plain versions: each kernel is held
# to 2e-5 of its plain version, and 28 layers of residual stream carry that
# forward; logits are held to 1e-3 of the largest |logit|.
MODEL_F32_RTOL = 1e-3
# bf16: each op rounds its output (2^-8 relative) through 28 layers, and
# the two paths round p after differing sums; the gap was 0.14 on logits
# up to 15.2 (0.9%) with every greedy token the same, on the NVIDIA H100.
MODEL_BF16_RTOL = 3e-2
MODEL_BF16_GREEDY = 0.9


def filled_state(torch, dev, cfg, B, T, seed):
    from repro_torch.models.transformer import init_decode_state

    state = init_decode_state(cfg, B, T, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    for t in state.get("kv", {}).values():
        for i in range(t.shape[0]):  # one layer at a time: no f32 temporary
            t[i].copy_(torch.randn(t[i].shape, device=dev, generator=g))
    return state


def kernel_class(name: str) -> str:
    if any(f"flash_{v}_kernel" in name for v in ("wgmma", "mma", "f32")):
        return "flash_attention"
    if any(f"{n}_kernel" in name for n in ("decode", "decode_ring",
                                            "combine")):
        return "decode_attention"
    if any(f"gmm_{v}_kernel" in name for v in ("wgmma", "mma", "f32")):
        return "moe_gmm"
    if any(f"{n}_kernel" in name for n in ("chunk_state", "state_pass",
                                            "chunk_out")) or \
            "scan_kernel<" in name or "scan_kernelI" in name:
        return "linear_scan"
    if "rmsnorm_kernel" in name:
        return "rmsnorm"
    if "plan_stats_" in name:
        return "plan_stats"
    if any(s in name.lower() for s in ("gemm", "xmma", "cutlass", "nvjet",
                                       "gemv")):
        return "matmul"
    return "other"


def busy_ms_of(spans) -> float:
    """ms of the union of (start, end) intervals in us."""
    busy_us, last = 0.0, None
    for start, end in sorted(spans):
        if last is None or start > last:
            busy_us += end - start
            last = end
        elif end > last:
            busy_us += end - last
            last = end
    return busy_us / 1e3


def device_split(torch, fn, calls: int) -> dict:
    """``calls`` calls of ``fn`` under torch.profiler: host wall time (ending
    in a synchronise), the device's busy time (the union of its kernel and
    copy intervals), the idle share, and device ms per kernel class."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_class, launches = [], {}, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        cls = kernel_class(e.name)
        by_class[cls] = by_class.get(cls, 0.0) + (end - start) / 1e3
        launches += 1
    busy_ms = busy_ms_of(spans)
    return dict(calls=calls, wall_ms=wall_ms, device_events=launches,
                device_busy_ms=busy_ms if spans else None,
                device_idle_share=(1.0 - busy_ms / wall_ms) if spans else None,
                device_ms_by_class={k: v for k, v in sorted(
                    by_class.items(), key=lambda kv: -kv[1])})


def logits_agree(torch, got, exp):
    got, exp = got.float(), exp.float()
    return dict(max_abs_err=float((got - exp).abs().max()),
                max_abs_logit=float(exp.abs().max()),
                greedy_same=float((got.argmax(-1) == exp.argmax(-1))
                                  .float().mean()))


def check_bf16_agree(name, d):
    if not (d["max_abs_err"] <= MODEL_BF16_RTOL * d["max_abs_logit"]
            and d["greedy_same"] >= MODEL_BF16_GREEDY):
        raise AssertionError(f"{name}: kernels and plain versions differ by "
                             f"{d['max_abs_err']} (largest logit "
                             f"{d['max_abs_logit']}), greedy tokens the same "
                             f"at {d['greedy_same']}")


def check_f32_agree(name, d):
    if not d["max_abs_err"] <= MODEL_F32_RTOL * d["max_abs_logit"]:
        raise AssertionError(f"{name}: kernels and plain versions differ by "
                             f"{d['max_abs_err']} (largest logit "
                             f"{d['max_abs_logit']})")


def phase_lm_serve(torch, dev, keep: dict) -> dict:
    """Phase 7; ``keep["qwen3_params"]`` gets the f32 params, moved to the
    host, for phase 14."""
    from repro_torch.config.registry import get_arch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.transformer import compute_params, lm_init

    cfg = get_arch("qwen3-1.7b")
    t0 = time.perf_counter()
    params = lm_init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cparams = compute_params(cfg, params)
    L = cfg.num_layers
    g = torch.Generator(device=dev).manual_seed(1400)
    prefill = make_prefill_step(cfg)
    B, S = PREFILL
    toks = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                         generator=g)
    # warm-up (first-use costs), not counted
    prefill(cparams, {"tokens": toks[:1, :256]})
    serve(cfg, cparams, requests=2, slots=2, max_new=2, cache_len=64,
          device=dev)

    # The main path, with both counts at 0 just before and read just after.
    fa.launches = da.launches = 0
    fa.launches_by_variant = dict.fromkeys(fa.VARIANTS, 0)
    da.launches_by_variant = dict.fromkeys(da.VARIANTS, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = prefill(cparams, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    flash_launches = fa.launches
    flash_variants = dict(fa.launches_by_variant)
    if flash_variants["wgmma"] != flash_launches:
        raise AssertionError(f"the prefill's flash launches were not all "
                             f"the wgmma variant: {flash_variants}")
    res = serve(cfg, cparams, device=dev, **SERVE)
    decode_launches, flash_after = da.launches, fa.launches
    decode_variants = dict(da.launches_by_variant)
    if decode_variants["tma"] != decode_launches:
        raise AssertionError(f"the serve loop's decode launches were not all "
                             f"the tma variant: {decode_variants}")
    if flash_launches != L or flash_after != L:
        raise AssertionError(f"flash launched {flash_launches} times in one "
                             f"prefill call, expected {L}")
    if decode_launches != L * res.steps:
        raise AssertionError(f"decode launched {decode_launches} times in "
                             f"{res.steps} steps, expected {L} per step")
    if len(res.tokens) != SERVE["requests"] or any(
            len(t) != SERVE["max_new"] for t in res.tokens):
        raise AssertionError("a request was not answered in full")
    if not all(0 <= x < cfg.vocab_size for t in res.tokens for x in t):
        raise AssertionError("token id out of the vocabulary")
    if tuple(logits.shape) != (B, S, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError("prefill logits malformed")
    del logits
    prefill_ms = [cuda_time_ms(torch, lambda: prefill(cparams,
                                                      {"tokens": toks}),
                               inner=1, reps=3, hide_host=False)]

    # One timed decode step at a long cache (lengths about 4000).
    state = filled_state(torch, dev, cfg, SERVE["slots"], SERVE["cache_len"],
                         1401)
    lengths = (LONG_CACHE + torch.arange(SERVE["slots"], device=dev)).int()
    step_toks = torch.randint(0, cfg.vocab_size, (SERVE["slots"],),
                              device=dev, generator=g).int()
    step = make_serve_step(cfg)
    long_ms = cuda_time_ms(torch, lambda: step(cparams, state, step_toks,
                                               lengths),
                           inner=5, reps=3, hide_host=False)
    # Where a step's and a prefill call's time goes (profiler, after the
    # timed runs).
    step_split = device_split(
        torch, lambda: step(cparams, state, step_toks, lengths), calls=3)
    prefill_split = device_split(
        torch, lambda: prefill(cparams, {"tokens": toks}), calls=1)
    del state

    # The whole model under ops.set_default_impl("ref") on the same inputs.
    import dataclasses

    def both(fn):
        got = fn()
        ops.set_default_impl("ref")
        try:
            exp = fn()
        finally:
            ops.set_default_impl("cuda")
        return got, exp

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    short = toks[:1, :2048]
    got, exp = both(lambda: make_prefill_step(cfg32)(params,
                                                     {"tokens": short}))
    f32_prefill = logits_agree(torch, got, exp)
    del got, exp
    st32 = filled_state(torch, dev, cfg32, 4, 1024, 1402)
    len32 = torch.tensor([1, 300, 777, 1024], dtype=torch.int32, device=dev)
    tok32 = torch.randint(0, cfg.vocab_size, (4,), device=dev,
                          generator=g).int()
    st_ref = {"kv": {n: t.clone() for n, t in st32["kv"].items()}}
    got = make_serve_step(cfg32)(params, st32, tok32, len32)[0]
    ops.set_default_impl("ref")
    try:
        exp = make_serve_step(cfg32)(params, st_ref, tok32, len32)[0]
    finally:
        ops.set_default_impl("cuda")
    f32_decode = logits_agree(torch, got, exp)
    del st32, st_ref, got, exp
    for name, d in (("f32 prefill", f32_prefill), ("f32 decode", f32_decode)):
        check_f32_agree(name, d)
    got, exp = both(lambda: prefill(cparams, {"tokens": toks}))
    bf16_prefill = logits_agree(torch, got, exp)
    del got, exp
    stb = filled_state(torch, dev, cfg, SERVE["slots"], SERVE["cache_len"],
                       1403)
    stb_ref = {"kv": {n: t.clone() for n, t in stb["kv"].items()}}
    got = step(cparams, stb, step_toks, lengths)[0]
    ops.set_default_impl("ref")
    try:
        exp = step(cparams, stb_ref, step_toks, lengths)[0]
    finally:
        ops.set_default_impl("cuda")
    bf16_decode = logits_agree(torch, got, exp)
    del stb, stb_ref, got, exp
    for name, d in (("bf16 prefill", bf16_prefill),
                    ("bf16 decode", bf16_decode)):
        check_bf16_agree(name, d)
    from repro_torch.tree import tree_map

    keep["qwen3_params"] = tree_map(lambda t: t.cpu(), params)
    del params, cparams
    torch.cuda.empty_cache()
    served = sum(len(t) for t in res.tokens)
    return dict(
        arch=cfg.name, params=cfg.param_count(), init_s=init_s,
        prefill=dict(batch=B, seq=S, first_call_s=prefill_s,
                     ms=prefill_ms[0],
                     tokens_per_s=B * S / (prefill_ms[0] / 1e3),
                     flash_launches=flash_launches,
                     flash_launches_by_variant=flash_variants),
        serve=dict(SERVE, steps=res.steps, tokens=served, wall_s=res.seconds,
                   tokens_per_s=served / res.seconds,
                   ms_per_step=res.seconds / res.steps * 1e3,
                   decode_launches=decode_launches,
                   decode_launches_by_variant=decode_variants,
                   decode_launches_per_step=decode_launches / res.steps),
        long_cache_step=dict(slots=SERVE["slots"], lengths=LONG_CACHE,
                             ms=long_ms, profile=step_split),
        prefill_profile=prefill_split,
        f32_vs_plain=dict(prefill=f32_prefill, decode=f32_decode,
                          rtol=MODEL_F32_RTOL),
        bf16_vs_plain=dict(prefill=bf16_prefill, decode=bf16_decode,
                           rtol=MODEL_BF16_RTOL,
                           min_greedy_same=MODEL_BF16_GREEDY))


# ---- phase 8 -------------------------------------------------------------

# The reference kernel tests' tolerances, as |got - exp| <= tol (1 + |exp|):
# moe_gmm 1e-4 (f32) and 2e-2 (bf16), tests/test_kernels_moe.py; the scan
# 2e-4 in f32, tests/test_kernels_ssm.py (bf16 outputs round to 2^-9 of
# their size, so they are held to 2e-2 against the plain bf16 version and
# row by row to BF16_ROW_RTOL against the plain version in f32); rmsnorm
# 1e-5 and 2e-2, tests/test_kernels_rmsnorm.py.
GMM_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SCAN_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
NORM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BOTH = ("bfloat16", "float32")


def gmm_cases():
    """label, E, C, din, dout, dtypes, main. C is the MoE block's capacity
    for the path's token counts (moe.capacity)."""
    from repro_torch.config.registry import get_arch
    from repro_torch.models.moe import capacity

    dbrx, kimi = get_arch("dbrx-132b"), get_arch("kimi-k2-1t-a32b")
    d, f = dbrx.d_model, dbrx.d_ff
    return [
        ("dbrx prefill (2 x 4096), gate/up", 16, capacity(dbrx, 8192), d, f,
         BOTH, True),
        ("dbrx prefill (2 x 4096), down", 16, capacity(dbrx, 8192), f, d,
         ("bfloat16",), True),
        ("dbrx decode (16 slots), gate/up", 16, capacity(dbrx, 16), d, f,
         BOTH, True),
        ("kimi-k2 prefill (8192 tokens), gate/up", 384, capacity(kimi, 8192),
         kimi.d_model, kimi.d_ff, ("bfloat16",), False),
        ("kimi-k2 decode (16 slots), gate/up", 384, capacity(kimi, 16),
         kimi.d_model, kimi.d_ff, ("bfloat16",), False),
        ("unaligned (3, 100, 130, 70)", 3, 100, 130, 70, BOTH, False),
        ("C = 70 (3, 70, 256, 384)", 3, 70, 256, 384, BOTH, False),
        ("E = 1", 1, 256, 512, 128, BOTH, False),
        ("C = 1", 8, 1, 1024, 1024, BOTH, False),
    ]


SCAN_CASES = [
    # label, B, S, H, Dk, Dv, decay range, dtypes, main
    ("hymba prefill (2, 4096), 25 heads, 16 x 128", 2, 4096, 25, 16, 128,
     (0.3, 1.0), BOTH, True),
    ("xlstm prefill (1, 1024), 4 heads, 512 x 512", 1, 1024, 4, 512, 512,
     (0.5, 1.0), BOTH, True),
    ("xlstm (2, 4096), 512 x 512", 2, 4096, 4, 512, 512, (0.5, 1.0),
     ("bfloat16",), False),
    ("S = 333", 1, 333, 3, 16, 128, (0.5, 1.0), BOTH, False),
    ("S = 1000", 2, 1000, 2, 64, 64, (0.5, 1.0), BOTH, False),
    ("strong decay", 2, 200, 2, 8, 16, (0.01, 0.2), BOTH, False),
]

NORM_CASES = [
    # label, shape, dtypes
    ("(8192, 2048)", (8192, 2048), BOTH),
    ("(8192, 6144)", (8192, 6144), ("bfloat16",)),
    ("(16, 6144)", (16, 6144), ("bfloat16",)),
    ("odd rows, d = 1600", (4097, 1600), BOTH),
    ("d = 100 (no 16-byte vectors)", (33, 100), BOTH),
    ("one row", (1, 6144), BOTH),
    # the resident variant's widest rows (2048 vectors) and one vector past
    ("bf16 d at the resident limit", (300, 16384), ("bfloat16",)),
    ("bf16 d at the resident limit, few rows", (16, 16384), ("bfloat16",)),
    ("bf16 d one vector past the limit", (300, 16392), ("bfloat16",)),
    ("f32 d at the resident limit", (300, 8192), ("float32",)),
    ("f32 d one vector past the limit", (300, 8196), ("float32",)),
]


def scan_f64(torch, q, k, v, a):
    """The recurrence step by step in float64: the exact yardstick."""
    q, k, v, a = (t.double() for t in (q, k, v, a))
    B, S, H, Dk = q.shape
    St = torch.zeros((B, H, Dk, v.shape[-1]), dtype=torch.float64,
                     device=q.device)
    nt = torch.zeros((B, H, Dk), dtype=torch.float64, device=q.device)
    ys = []
    for t in range(S):
        St = a[:, t, :, None, None] * St + k[:, t, :, :, None] * \
            v[:, t, :, None, :]
        nt = a[:, t, :, None] * nt + k[:, t]
        den = torch.einsum("bhk,bhk->bh", q[:, t], nt).abs().clamp(min=1.0)
        ys.append(torch.einsum("bhk,bhkv->bhv", q[:, t], St) / den[..., None])
    return torch.stack(ys, 1)


def rel_err(got, exact) -> float:
    """max |got - exact| / (1 + |exact|)."""
    return float(((got.double() - exact).abs() / (1 + exact.abs())).max())


def phase_lm_kernels_2(torch, dev) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssm_scan as ss

    g = torch.Generator(device=dev).manual_seed(1500)
    gmm_rows, scan_rows, norm_rows = [], [], []
    for label, E, C, din, dout, dtypes, main in gmm_cases():
        for dname in dtypes:
            dt = tdtype(torch, dname)
            x = torch.randn((E, C, din), device=dev, generator=g, dtype=dt)
            w = torch.randn((E, din, dout), device=dev, generator=g, dtype=dt)
            w.mul_(din ** -0.5)           # the models' 1/sqrt(fan-in)
            variant = gmm.kernel_variant(dt, E, C, din, dout)
            before = gmm.launches_by_variant[variant]
            got = gmm.moe_gmm(x, w)
            exp = gmm.moe_gmm_ref(x, w)
            torch.cuda.synchronize()
            if gmm.launches_by_variant[variant] != before + 1:
                raise AssertionError(f"moe_gmm {label} {dname}: the "
                                     f"{variant} variant did not launch")
            err = attn_close(got, exp, GMM_TOL[dname], f"moe_gmm {label}")
            # the library call's output beside the kernel's (0: bit for bit)
            vs_library = float((got.float() - torch.bmm(x, w).float())
                               .abs().max())
            del exp
            row_err = None
            if dname == "bfloat16":
                chunk = max(1, int(1e9 // (4 * din * dout)))
                row_err = bf16_row_err(torch, got, gmm.moe_gmm_ref, (x, w),
                                       f"moe_gmm {label}", chunk=chunk)
            del got
            flops = 2.0 * E * C * din * dout
            big = flops >= 1e12
            kernel_ms = cuda_time_ms(torch, lambda: gmm.moe_gmm(x, w),
                                     inner=1 if big else 10,
                                     reps=3 if big else 5)
            plain_ms = cuda_time_ms(torch, lambda: gmm.moe_gmm_ref(x, w),
                                    inner=1 if big else 10,
                                    reps=3 if big else 5)
            library_ms = cuda_time_ms(torch, lambda: torch.bmm(x, w),
                                      inner=1 if big else 10,
                                      reps=3 if big else 5)
            # the bf16 variant the rule passes over, where it can serve too
            other = {"mma": "wgmma", "wgmma": "mma"}.get(variant)
            other_ms = None
            if other and din % 8 == 0 and dout % 8 == 0:
                other_ms = cuda_time_ms(
                    torch, lambda: gmm_as(torch, gmm, other, x, w),
                    inner=1 if big else 10, reps=3 if big else 5)
            nbytes = (E * C * din + E * din * dout + E * C * dout) * \
                x.element_size()
            bound_ms, bound_by = attn_bound(nbytes, flops, dname)
            gmm_rows.append(dict(
                label=label, dtype=dname, main=main, variant=variant,
                shape=[E, C, din, dout], max_abs_err=err,
                max_abs_diff_vs_library=vs_library,
                bf16_row_err_vs_f32=row_err,
                kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                other_variant=other if other_ms is not None else None,
                other_ms=other_ms, tflops=flops / (kernel_ms * 1e9)))
            del x, w
            torch.cuda.empty_cache()
    for label, B, S, H, Dk, Dv, (lo, hi), dtypes, main in SCAN_CASES:
        for dname in dtypes:
            dt = tdtype(torch, dname)
            q = torch.randn((B, S, H, Dk), device=dev, generator=g, dtype=dt)
            k = (0.5 * torch.randn((B, S, H, Dk), device=dev,
                                   generator=g)).to(dt)
            v = torch.randn((B, S, H, Dv), device=dev, generator=g, dtype=dt)
            a = lo + (hi - lo) * torch.rand((B, S, H), device=dev,
                                            generator=g)
            variant = ss.kernel_variant(dt, B, S, H, Dk, Dv)
            before = ss.launches_by_variant[variant]
            got, state = ss.linear_scan(q, k, v, a,
                                        want_final_state=not main)
            exp, exp_state = ss.linear_scan_chunked_ref(q, k, v, a)
            torch.cuda.synchronize()
            if ss.launches_by_variant[variant] != before + 1:
                raise AssertionError(f"linear_scan {label} {dname}: the "
                                     f"{variant} variant did not launch")
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"linear_scan {label}: non-finite output")
            err = attn_close(got, exp, SCAN_TOL[dname],
                             f"linear_scan {label}")
            vs_f64 = None
            if dname == "float32":  # both against the exact recurrence
                ora = scan_f64(torch, q, k, v, a)
                vs_f64 = dict(kernel=rel_err(got, ora),
                              plain=rel_err(exp, ora))
                del ora
            if state is not None:  # the closed-form final state, in f32
                for s_, e in zip(state, exp_state):
                    attn_close(s_, e, SCAN_TOL["float32"] if dname ==
                               "float32" else SCAN_TOL["bfloat16"],
                               f"linear_scan {label} final state")
            plain_out = exp
            del exp, exp_state, state
            row_err = None
            if dname == "bfloat16":
                row_err = bf16_row_err(
                    torch, got, lambda *t: ss.linear_scan_chunked_ref(*t)[0],
                    (q, k, v, a), f"linear_scan {label}", chunk=1)
            big = B * S * H * Dk * Dv >= 10 ** 9
            kernel_ms = cuda_time_ms(
                torch, lambda: ss.linear_scan(q, k, v, a,
                                              want_final_state=False),
                inner=1 if big else 5, reps=3 if big else 5)
            plain_ms = cuda_time_ms(
                torch, lambda: ss.linear_scan_chunked_ref(q, k, v, a),
                inner=1, reps=3, hide_host=False)
            # the old design (simt) beside the one the rule picks
            other = "simt" if variant != "simt" else None
            other_ms = None
            if other:
                y_old = torch.empty_like(got)
                ss.launch_variant(other, q, k, v, a.contiguous(), y_old)
                attn_close(y_old, plain_out, SCAN_TOL[dname],
                           f"linear_scan {label} ({other})")
                other_ms = cuda_time_ms(
                    torch, lambda: ss.launch_variant(other, q, k, v, a, y_old),
                    inner=1 if big else 5, reps=3 if big else 5)
                del y_old
            del got, plain_out
            # the recurrence's own work: S update and q.S per token and
            # head, at the inputs' type's rate (bf16: the tensor cores)
            ops = B * S * H * (4.0 * Dk * Dv + 4.0 * Dk + 2.0 * Dv)
            nbytes = B * S * H * ((2 * Dk + 2 * Dv) * q.element_size() + 4)
            bound_ms, bound_by = attn_bound(nbytes, ops, dname)
            scan_rows.append(dict(
                label=label, dtype=dname, main=main, variant=variant,
                chunk=(ss.chunk_length(Dk, Dv) if variant == "mma"
                       else None),
                shape=[B, S, H, Dk, Dv], decay=[lo, hi], max_abs_err=err,
                bf16_row_err_vs_f32=row_err, rel_err_vs_f64=vs_f64,
                kernel_ms=kernel_ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=bound_by, other_variant=other, other_ms=other_ms))
            del q, k, v, a
            torch.cuda.empty_cache()
    for label, shape, dtypes in NORM_CASES:
        for dname in dtypes:
            dt = tdtype(torch, dname)
            x = (2 * torch.randn(shape, device=dev, generator=g)).to(dt)
            s = 1 + 0.1 * torch.randn(shape[-1:], device=dev, generator=g)
            variant = rn.kernel_variant(dt, *shape)
            before = rn.launches_by_variant[variant]
            got = rn.rmsnorm(x, s)
            exp = rn.rmsnorm_ref(x, s)
            torch.cuda.synchronize()
            if rn.launches_by_variant[variant] != before + 1:
                raise AssertionError(f"rmsnorm {label} {dname}: the "
                                     f"{variant} variant did not launch")
            err = attn_close(got, exp, NORM_TOL[dname], f"rmsnorm {label}")
            # the old design (warp) beside the one the rule picks, held to
            # the same tolerance
            other = "warp" if variant != "warp" else None
            y_old = None
            if other:
                y_old = torch.empty_like(x)
                rn.launch_variant(other, x, s, y_old)
                attn_close(y_old, exp, NORM_TOL[dname],
                           f"rmsnorm {label} ({other})")
            row_err = None
            if dname == "bfloat16":
                row_err = bf16_row_err(
                    torch, got, lambda xf: rn.rmsnorm_ref(xf, s), (x,),
                    f"rmsnorm {label}", chunk=shape[0])
            del got, exp
            s_lib = s.to(dt)
            kernel_ms = cuda_time_ms(torch, lambda: rn.rmsnorm(x, s),
                                     inner=20)
            plain_ms = cuda_time_ms(torch, lambda: rn.rmsnorm_ref(x, s),
                                    inner=20)
            library_ms = cuda_time_ms(
                torch, lambda: F.rms_norm(x, shape[-1:], s_lib, 1e-6),
                inner=20)
            other_ms = None
            if other:
                other_ms = cuda_time_ms(
                    torch, lambda: rn.launch_variant(other, x, s, y_old),
                    inner=20)
            n = x.numel()
            bound_ms, bound_by = attn_bound(
                2 * n * x.element_size() + 4 * shape[-1], 4.0 * n, "float32")
            norm_rows.append(dict(
                label=label, dtype=dname, shape=list(shape), variant=variant,
                max_abs_err=err, bf16_row_err_vs_f32=row_err,
                kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, other_variant=other,
                other_ms=other_ms))
            del x, s, s_lib, y_old
    torch.cuda.empty_cache()
    return {"moe_gmm": gmm_rows, "linear_scan": scan_rows,
            "rmsnorm": norm_rows}


# ---- phase 9 -------------------------------------------------------------

DBRX_LAYERS = 2                # of 40: two layers at full width fit a card
HYMBA_PREFILL = (2, 4096)
XLSTM_PREFILL = (1, 1024)      # its sLSTM steps one token at a time
SELF_CHECK = (1, 2048)         # dbrx's prefill self-check
# hymba's and xlstm's self-checks run the sequential oracle scan, one
# token at a time: shorter prompts (xlstm's sLSTM steps token by token too)
SELF_CHECK_LEN = {"hymba-1.5b": 1024, "xlstm-350m": 256}


def draw_params(torch, cfg, dev, seed: int):
    """``cfg``'s param tree from ``lm_param_shapes``, drawn on the card from
    ``seed``: every matrix normal with std 1/sqrt(fan-in) (the embedding
    1/sqrt(d_model), as lm_init draws it), norm scales ones, the SSD decay
    base zeros; float32."""
    from repro_torch.models.transformer import lm_param_shapes

    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(name, t):
        out = torch.empty(t.shape, dtype=torch.float32, device=dev)
        if name in ("scale", "q_norm", "k_norm"):
            return out.fill_(1.0)
        if name == "a_log":
            return out.zero_()
        fan_in = t.shape[-1] if name == "embedding" else t.shape[-2]
        return out.normal_(0.0, fan_in ** -0.5, generator=g)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return draw(name, tree)

    return walk(lm_param_shapes(cfg))


class RouteLog:
    """Records the expert ids ``models/moe.py::route`` picks, call by call,
    while installed (the smoke's own instrumentation)."""

    def __init__(self, moe_mod):
        self.moe, self.orig, self.ids = moe_mod, moe_mod.route, []

    def __enter__(self):
        def logged(cfg, p, xf):
            w, ids = self.orig(cfg, p, xf)
            self.ids.append(ids.sort(dim=-1).values)
            return w, ids
        self.moe.route = logged
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig
        return False


class SequentialScan:
    """While installed, the plain scan (``set_default_impl("ref")``) is the
    sequential oracle ``linear_scan_ref`` rather than the chunked form: the
    smoke's own yardstick for the recurrent models."""

    def __init__(self, ss):
        self.ss, self.orig = ss, ss.linear_scan_chunked_ref

    def __enter__(self):
        self.ss.linear_scan_chunked_ref = (
            lambda q, k, v, a, chunk=128: self.ss.linear_scan_ref(q, k, v, a))
        return self

    def __exit__(self, *exc):
        self.ss.linear_scan_chunked_ref = self.orig
        return False


# hymba and xlstm amplify the rounding of their scans. The plain scan in
# chunks (the reference's data path, 1e-5 off the exact recurrence in f32:
# phase 8's rel_err_vs_f64) and the sequential oracle are two forms of the
# same math, yet their whole models' logits differ (plain_vs_oracle
# below), by far more than MODEL_F32_RTOL at hymba-1.5b; in bf16 the two
# forms' greedy tokens part (the "not gated" records). The whole-model
# limits of phase 7, from qwen3-1.7b, cannot hold between such forms. So
# the recurrent models' f32 prefill is held to the exact recurrence: the
# kernels' logits no further from the sequential-oracle model than the
# plain model is, plus MODEL_F32_RTOL of the largest logit; in bf16 each
# block is held on its own (blockwise_prefill, blockwise_decode).
def check_vs_oracle(torch, name, got, exp, ora, rtol) -> dict:
    vs_plain = logits_agree(torch, got, exp)
    kern = logits_agree(torch, got, ora)
    plain = logits_agree(torch, exp, ora)
    limit = plain["max_abs_err"] + rtol * kern["max_abs_logit"]
    if not kern["max_abs_err"] <= limit:
        raise AssertionError(f"{name}: the kernels' logits are "
                             f"{kern['max_abs_err']} from the sequential "
                             f"oracle's, the plain version's "
                             f"{plain['max_abs_err']} (limit {limit})")
    return dict(vs_plain=vs_plain, kernels_vs_oracle=kern,
                plain_vs_oracle=plain, limit=limit)


def _row_err(torch, got, exp) -> float:
    got, exp = got.float(), exp.float()
    return float(((got - exp).norm(dim=-1)
                  / exp.norm(dim=-1).clamp_min(1e-30)).max())


def _check_blocks(name, errs) -> dict:
    if not max(errs) <= BF16_ROW_RTOL:
        raise AssertionError(f"{name}: block {errs.index(max(errs))}'s "
                             f"output is off by {max(errs)} of a row's norm "
                             f"(limit {BF16_ROW_RTOL})")
    return dict(max_row_err=max(errs), row_err_by_block=errs)


def blockwise_prefill(torch, ops, cfg, params, tokens, name) -> dict:
    """Each block's prefill output through the kernels against the same
    block under ``set_default_impl("ref")``, both fed the kernels' hidden
    state: every output row within BF16_ROW_RTOL of its norm."""
    from repro_torch.models import transformer as tf

    x = tf._embed(cfg, params, tokens)
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)[None, :].expand(B, S)
    errs = []
    for i in range(tf.num_blocks(cfg)):
        p = tf._layer(params["blocks"], i)
        got = tf._block_apply(cfg, p, x, pos)
        exp = with_impl(ops, "ref", lambda: tf._block_apply(cfg, p, x, pos))
        errs.append(_row_err(torch, got, exp))
        x = got
    return _check_blocks(name, errs)


def blockwise_decode(torch, ops, cfg, params, dev, name, seed) -> dict:
    """One decode step of 16 slots (lengths 37 b), block by block as in
    blockwise_prefill; each block's plain run gets a copy of its state."""
    from repro_torch.models import transformer as tf

    def clone(tree):
        if isinstance(tree, dict):
            return {k: clone(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(clone(v) for v in tree)
        return tree.clone()

    B = SERVE["slots"]
    g = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B,), device=dev, generator=g)
    state = tf.init_decode_state(cfg, B, SERVE["cache_len"], device=dev)
    length = (37 * torch.arange(B, device=dev)).int()
    x = tf._embed(cfg, params, toks[:, None])
    errs = []
    for i in range(tf.num_blocks(cfg)):
        p, st = tf._layer(params["blocks"], i), tf._layer(state, i)
        st_ref = clone(st)
        got, new = tf._block_decode(cfg, p, x, st, length)
        exp, _ = with_impl(ops, "ref", lambda: tf._block_decode(
            cfg, p, x, st_ref, length))
        errs.append(_row_err(torch, got, exp))
        tf._store(st, new)
        x = got
    return _check_blocks(name, errs)


def with_impl(ops, impl, fn):
    ops.set_default_impl(impl)
    try:
        return fn()
    finally:
        ops.set_default_impl("cuda")


def serve_checked(cfg, cparams, dev, serve):
    res = serve(cfg, cparams, device=dev, **SERVE)
    if len(res.tokens) != SERVE["requests"] or any(
            len(t) != SERVE["max_new"] for t in res.tokens):
        raise AssertionError(f"{cfg.name}: a request was not answered in full")
    if not all(0 <= x < cfg.vocab_size for t in res.tokens for x in t):
        raise AssertionError(f"{cfg.name}: token id out of the vocabulary")
    served = sum(len(t) for t in res.tokens)
    return res, dict(SERVE, steps=res.steps, tokens=served,
                     wall_s=res.seconds, tokens_per_s=served / res.seconds,
                     ms_per_step=res.seconds / res.steps * 1e3)


def check_logits(cfg, logits, shape):
    if tuple(logits.shape) != tuple(shape) + (cfg.vocab_size,) or not bool(
            logits.isfinite().all()):
        raise AssertionError(f"{cfg.name}: prefill logits malformed")


def decode_twins(torch, cfg, params, dev, ops, steps: int, seed: int):
    """``steps`` decode steps of 16 slots from one state, through the
    kernels and under ``set_default_impl("ref")``: the last logits of
    each. Slot b starts at length 37 b (sliding windows wrap)."""
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.transformer import init_decode_state

    step = make_serve_step(cfg)
    B = SERVE["slots"]
    g = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (steps, B), device=dev,
                         generator=g).int()
    out = []
    for impl in ("cuda", "ref"):
        state = init_decode_state(cfg, B, SERVE["cache_len"], device=dev)
        length = (37 * torch.arange(B, device=dev)).int()
        logits = None
        for i in range(steps):
            logits = with_impl(ops, impl, lambda: step(
                params, state, toks[i], length)[0])
            length = length + 1
        out.append(logits)
        del state
    return out


#: The variant every bf16 launch of each kernel on the models' paths takes.
HOPPER_VARIANT = {"moe_gmm": "wgmma", "linear_scan": "mma",
                  "flash_attention": "wgmma", "decode_attention": "tma"}


def drive_path(torch, dev, cfg, cparams, shape, per_prefill, per_step, g):
    """The model's main path through the entry points, every launch count
    at 0 just before and read just after: one prefill of ``shape`` tokens
    and the serve loop; each kernel must launch ``per_prefill`` times in
    the prefill and ``per_step`` times in each serve step (absent: 0).
    Then the prefill's and a long-cache step's times and device splits."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    counters = {"moe_gmm": gmm, "linear_scan": ss, "flash_attention": fa,
                "decode_attention": da}
    prefill = make_prefill_step(cfg)
    B, S = shape
    toks = torch.randint(0, cfg.vocab_size, (B, S), device=dev, generator=g)
    prefill(cparams, {"tokens": toks[:1, :128]})       # warm-up, not counted
    serve(cfg, cparams, requests=2, slots=2, max_new=2, cache_len=64,
          device=dev)

    for c in counters.values():
        c.launches = 0
        c.launches_by_variant = dict.fromkeys(c.VARIANTS, 0)
    first_ms, _ = timed_ms(torch, lambda: check_logits(
        cfg, prefill(cparams, {"tokens": toks}), (B, S)))
    at_prefill = {n: c.launches for n, c in counters.items()}
    variants_at_prefill = {n: dict(c.launches_by_variant)
                           for n, c in counters.items()}
    res, serve_row = serve_checked(cfg, cparams, dev, serve)
    at_end = {n: c.launches for n, c in counters.items()}
    variants_at_end = {n: dict(c.launches_by_variant)
                       for n, c in counters.items()}
    # bf16 models: every launch, prefill and steps, on the Hopper designs
    for n, by in variants_at_end.items():
        if by[HOPPER_VARIANT[n]] != at_end[n]:
            raise AssertionError(f"{cfg.name}: the {n} launches were not "
                                 f"all the {HOPPER_VARIANT[n]} variant: {by}")
    for n in counters:
        want = per_prefill.get(n, 0)
        if at_prefill[n] != want or \
                at_end[n] != want + res.steps * per_step.get(n, 0):
            raise AssertionError(
                f"{cfg.name}: {n} launched {at_prefill[n]} times in the "
                f"prefill and {at_end[n]} by the end of {res.steps} steps; "
                f"expected {want} and {per_step.get(n, 0)} a step")

    ms, _ = timed_ms(torch, lambda: prefill(cparams, {"tokens": toks}))
    prefill_split = device_split(
        torch, lambda: prefill(cparams, {"tokens": toks}), calls=1)
    step = make_serve_step(cfg)
    state = filled_state(torch, dev, cfg, SERVE["slots"], SERVE["cache_len"],
                         1602)
    lengths = (LONG_CACHE + torch.arange(SERVE["slots"], device=dev)).int()
    step_toks = torch.randint(0, cfg.vocab_size, (SERVE["slots"],),
                              device=dev, generator=g).int()
    step_ms = cuda_time_ms(torch, lambda: step(cparams, state, step_toks,
                                               lengths),
                           inner=5, reps=3, hide_host=False)
    step_split = device_split(
        torch, lambda: step(cparams, state, step_toks, lengths), calls=3)
    record = dict(
        arch=cfg.name, layers=cfg.num_layers,
        prefill=dict(batch=B, seq=S, first_call_ms=first_ms, ms=ms,
                     tokens_per_s=B * S / (ms / 1e3), launches=at_prefill,
                     launches_by_variant=variants_at_prefill),
        serve=dict(serve_row, launches=at_end,
                   launches_by_variant=variants_at_end),
        long_cache_step=dict(slots=SERVE["slots"], lengths=LONG_CACHE,
                             ms=step_ms, profile=step_split),
        prefill_profile=prefill_split)
    return record, toks, (state, step_toks, lengths)


def moe_self_check(torch, ops, cfg, cparams, toks, step_args) -> dict:
    """The bf16 MoE model against itself under ``set_default_impl("ref")``,
    with both runs' routing recorded (``routed_agree``)."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import moe as moe_mod

    prefill, step = make_prefill_step(cfg), make_serve_step(cfg)
    short = toks[:SELF_CHECK[0], :SELF_CHECK[1]]
    with RouteLog(moe_mod) as got_log:
        got = prefill(cparams, {"tokens": short})
    with RouteLog(moe_mod) as exp_log:
        exp = with_impl(ops, "ref",
                        lambda: prefill(cparams, {"tokens": short}))
    pre = routed_agree(torch, got, exp, got_log.ids, exp_log.ids)
    del got, exp
    state, step_toks, lengths = step_args
    st_ref = {"kv": {n: t.clone() for n, t in state["kv"].items()}}
    with RouteLog(moe_mod) as got_log:
        got = step(cparams, state, step_toks, lengths)[0]
    with RouteLog(moe_mod) as exp_log:
        exp = with_impl(ops, "ref", lambda: step(cparams, st_ref, step_toks,
                                                 lengths)[0])
    dec = routed_agree(torch, got, exp, got_log.ids, exp_log.ids)
    for name, d in (("prefill", pre), ("decode", dec)):
        check_bf16_agree(f"{cfg.name} bf16 {name}", d["routed_alike"])
        if d["all"]["greedy_same"] < MODEL_BF16_GREEDY:
            raise AssertionError(f"{cfg.name} bf16 {name}: greedy tokens the "
                                 f"same at {d['all']['greedy_same']}")
    return dict(prefill=pre, decode=dec, rtol=MODEL_BF16_RTOL,
                min_greedy_same=MODEL_BF16_GREEDY)


def recurrent_self_check(torch, dev, ops, cfg, params, cparams, short
                         ) -> dict:
    """hymba's and xlstm's checks (see check_vs_oracle). f32: the whole
    model's prefill against the plain model and the sequential oracle, its
    decode against the plain. bf16: block by block on the kernels' own
    hidden states (gated), the whole model reported."""
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.launch.steps import make_prefill_step

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    checks = {}
    for name, c, p in (("f32", cfg32, params), ("bf16", cfg, cparams)):
        pf = make_prefill_step(c)
        got = pf(p, {"tokens": short})
        exp = with_impl(ops, "ref", lambda: pf(p, {"tokens": short}))
        with SequentialScan(ss):
            ora = with_impl(ops, "ref", lambda: pf(p, {"tokens": short}))
        if name == "f32":
            checks["f32 prefill"] = check_vs_oracle(
                torch, f"{cfg.name} f32 prefill", got, exp, ora,
                MODEL_F32_RTOL)
        else:
            checks["bf16 prefill, whole model (not gated)"] = dict(
                vs_plain=logits_agree(torch, got, exp),
                plain_vs_oracle=logits_agree(torch, exp, ora))
        del got, exp, ora
        got, exp = decode_twins(torch, c, p, dev, ops, steps=3, seed=1603)
        d = logits_agree(torch, got, exp)
        if name == "f32":
            check_f32_agree(f"{cfg.name} f32 decode", d)
            checks["f32 decode"] = d
        else:
            checks["bf16 decode, whole model (not gated)"] = d
        del got, exp
    checks["bf16 prefill, per block"] = blockwise_prefill(
        torch, ops, cfg, cparams, short, f"{cfg.name} bf16 prefill")
    checks["bf16 decode, per block"] = blockwise_decode(
        torch, ops, cfg, cparams, dev, f"{cfg.name} bf16 decode", seed=1604)
    return dict(checks, f32_rtol=MODEL_F32_RTOL,
                bf16_block_row_rtol=BF16_ROW_RTOL)


def phase_lm_serve_2(torch, dev) -> dict:
    from repro_torch.config.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import compute_params, lm_init
    from repro_torch.tree import tree_leaves

    g = torch.Generator(device=dev).manual_seed(1600)
    out = {}
    # dbrx-132b, 2 of its 40 layers at full width: the MoE path
    full = get_arch("dbrx-132b")
    cfg = dataclasses.replace(full, num_layers=DBRX_LAYERS)
    t0 = time.perf_counter()
    params = draw_params(torch, cfg, dev, seed=1601)
    cparams = compute_params(cfg, params)
    n_params = sum(t.numel() for t in tree_leaves(params))
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    L = cfg.num_layers
    rec, toks, step_args = drive_path(
        torch, dev, cfg, cparams, PREFILL,
        {"moe_gmm": 3 * L, "flash_attention": L},
        {"moe_gmm": 3 * L, "decode_attention": L}, g)
    out["dbrx"] = dict(rec, of_layers=full.num_layers, params=n_params,
                       init_on_card_s=init_s,
                       bf16_vs_plain=moe_self_check(torch, ops, cfg, cparams,
                                                    toks, step_args))
    del cparams, toks, step_args
    torch.cuda.empty_cache()

    # hymba-1.5b and xlstm-350m at full size: the hybrid and SSM paths
    for arch, shape in (("hymba-1.5b", HYMBA_PREFILL),
                        ("xlstm-350m", XLSTM_PREFILL)):
        cfg = get_arch(arch)
        t0 = time.perf_counter()
        params = lm_init(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        cparams = compute_params(cfg, params)
        L = cfg.num_layers
        if cfg.family.value == "hybrid":
            per_prefill = {"linear_scan": L, "flash_attention": L}
            per_step = {"decode_attention": L}
        else:  # xLSTM: one scan per mLSTM block; no kernel in decode
            per_prefill, per_step = {"linear_scan": L // 2}, {}
        rec, toks, step_args = drive_path(torch, dev, cfg, cparams, shape,
                                          per_prefill, per_step, g)
        del step_args
        out[arch.split("-")[0]] = dict(
            rec, params=sum(t.numel() for t in tree_leaves(params)),
            init_s=init_s, vs_plain=recurrent_self_check(
                torch, dev, ops, cfg, params, cparams,
                toks[:1, :SELF_CHECK_LEN[arch]]))
        del params, cparams, toks
        torch.cuda.empty_cache()
    return out


def variant_keys(row: dict) -> dict:
    """The variant, TFLOP/s and the other design's time of a kernel's main
    row, where it has them."""
    return {k: row[k] for k in ("variant", "tflops", "other_variant",
                                "other_ms") if row.get(k) is not None}


def timed_ms(torch, fn):
    out, s = timed(torch, fn)
    return s * 1e3, out


def routed_agree(torch, got, exp, got_ids, exp_ids) -> dict:
    """Logits of a MoE model against its plain run: over all tokens, and
    over the tokens every MoE layer routed to the same experts in both (a
    token whose bf16 router logits sit near a tie may take other experts
    in the two runs, which moves its output by a whole expert's share).
    Also the share of (token, layer) routings that agree."""
    if len(got_ids) != len(exp_ids) or not got_ids:
        raise AssertionError("the two runs routed a different number of "
                             "MoE layers")
    same = torch.stack([(a == b).all(-1) for a, b in zip(got_ids, exp_ids)])
    alike = same.all(0)                        # (tokens,)
    V = got.shape[-1]
    g2, e2 = got.reshape(-1, V), exp.reshape(-1, V)
    return dict(all=logits_agree(torch, g2, e2),
                routed_alike=logits_agree(torch, g2[alike], e2[alike]),
                routing_agree=float(same.float().mean()),
                tokens_routed_alike=float(alike.float().mean()),
                tokens=int(alike.numel()))


# ---- phase 10 ------------------------------------------------------------

class SearchLog:
    """For one run, wraps a search entry point of ``repro_torch.core.search``
    (``bods_acquire``, ``ga_search`` or ``sa_search``): counts its calls,
    sums the host seconds inside them (each returns a host plan, so each
    ends synchronised), counts the host-device synchronisations PyTorch
    reports inside them (``torch.cuda.set_sync_debug_mode("warn")``) and
    keeps each decision's plan. With ``replay_device`` every call runs again
    there on the same inputs, from a copy of the generator's state; both
    plans are kept, and where they differ both plans' Formula-2 costs."""

    def __init__(self, torch, search, name, replay_device=None):
        self.torch, self.search, self.name = torch, search, name
        self.replay_device = replay_device
        self.calls, self.seconds, self.syncs = 0, 0.0, 0
        self.replay_seconds = 0.0
        self.plans, self.replays, self.differ = [], [], []
        self.last = None
        self._orig = getattr(search, name)

    def _wrapper(self, rng, *args, **kw):
        import copy
        import warnings

        import numpy as np

        torch, fn = self.torch, self._orig
        self.last = (args, kw)
        state = copy.deepcopy(rng.bit_generator.state)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                out = fn(rng, *args, **kw)
                self.seconds += time.perf_counter() - t0
            finally:
                torch.cuda.set_sync_debug_mode("default")
        self.syncs += sum("synchroniz" in str(w.message) for w in caught)
        self.calls += 1
        plan = out[0] if isinstance(out, tuple) else out
        self.plans.append(np.array(plan))
        if self.replay_device is not None:
            twin = np.random.Generator(type(rng.bit_generator)())
            twin.bit_generator.state = state
            t0 = time.perf_counter()
            other = fn(twin, *args, **dict(kw, device=self.replay_device))
            self.replay_seconds += time.perf_counter() - t0
            self.replays.append(np.array(other))
            if not np.array_equal(plan, other):
                self.differ.append(self._costs(args, kw, plan, other))
        return out

    def _costs(self, args, kw, plan, other) -> dict:
        import numpy as np

        from repro_torch.core import scoring

        times, counts = args[0], args[1]
        c = scoring.score_plans(
            times, counts, np.stack([plan, other]), backend="numpy",
            **{k: kw[k] for k in ("alpha", "beta", "time_scale",
                                  "fairness_scale", "delta_fairness")})
        return dict(decision=self.calls - 1, cuda_cost=float(c[0]),
                    cpu_cost=float(c[1]))

    def __enter__(self):
        setattr(self.search, self.name, self._wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.search, self.name, self._orig)
        return False

    def device_split(self, calls: int = 3) -> dict:
        """The last decision's inputs, decided ``calls`` more times under
        torch.profiler (``device_split``): the device's busy time and idle
        share inside a decision, device ms by kernel class."""
        import numpy as np

        args, kw = self.last
        return device_split(self.torch, lambda: self._orig(
            np.random.default_rng(0), *args, **kw), calls)

    def per_decision(self) -> dict:
        n = max(self.calls, 1)
        return dict(decisions=self.calls, search_s_per_decision=self.seconds / n,
                    syncs_per_decision=self.syncs / n)


def reset_plan_stats_counts(ss) -> None:
    ss.launches = 0
    ss.launches_by_variant.update(dict.fromkeys(ss.VARIANTS, 0))


def bods_run(torch, spec, impl: str) -> dict:
    """``spec`` (fused BODS) on the card under ``ops.set_default_impl(impl)``:
    the records, the acquisition's log, the wall seconds, 2.1's launches by
    variant, and the last candidate block's inputs to the statistics
    (times, centred counts, plans)."""
    from repro_torch.core import search
    from repro_torch.kernels import ops
    from repro_torch.kernels import sched_score as ss

    block = {}
    dense_stats = search._dense_stats

    def keep_block(times, counts_c, plans):
        block.update(times=times, counts_c=counts_c, plans=plans)
        return dense_stats(times, counts_c, plans)

    exp = spec.build(device="cuda")
    ops.set_default_impl(impl)
    search._dense_stats = keep_block
    try:
        with SearchLog(torch, search, "bods_acquire") as log:
            reset_plan_stats_counts(ss)
            t0 = time.perf_counter()
            result = exp.run()
            wall_s = time.perf_counter() - t0
            launches = ss.launches
            by_variant = dict(ss.launches_by_variant)
    finally:
        search._dense_stats = dense_stats
        ops.set_default_impl("cuda")
    return dict(records=result.records, log=log, wall_s=wall_s,
                launches=launches, by_variant=by_variant, block=block,
                result=result)


def bods_checked(torch, spec, what: str) -> dict:
    """``spec`` (fused BODS) run by ``bods_run`` with kernel 2.1 and again
    under its plain version. Fails unless 2.1 launched once per decision,
    every launch in the variant the last block picks, the records hold
    n_sel distinct available devices, the plain run launched nothing and
    made identical decisions, and 2.1 agrees with its plain version on the
    last block (``block_kernel_row``)."""
    from repro_torch.kernels import sched_score as ss

    main = bods_run(torch, spec, "cuda")
    log = main["log"]
    if log.calls == 0 or main["launches"] != log.calls:
        raise AssertionError(f"{what}: plan_stats launched {main['launches']} "
                             f"times for {log.calls} fused BODS decisions")
    kernel = block_kernel_row(torch, ss, main["block"])
    if main["by_variant"].get(kernel["variant"]) != main["launches"]:
        raise AssertionError(f"{what}: launches by variant "
                             f"{main['by_variant']}: expected all "
                             f"{kernel['variant']}")
    check_records(main["records"], spec.effective_n_sel(),
                  spec.effective_num_devices())
    plain = bods_run(torch, spec, "ref")
    if plain["launches"] != 0:
        raise AssertionError(f"{what}: the plain run launched the kernel")
    identical_decisions(log, plain["log"], f"{what}, kernel vs plain")
    return dict(main=main, plain=plain, kernel=kernel,
                est_diff=compare_runs(main["records"], plain["records"]))


def block_kernel_row(torch, ss, block) -> dict:
    """Kernel 2.1 on the main path's last candidate block (times, centred
    counts, plans): ``kernel_row`` on the weights the path gives it."""
    return kernel_row(torch, ss, block["times"],
                      2.0 * block["counts_c"] + 1.0, block["plans"])


def kernel_row(torch, ss, times, weights, plans) -> dict:
    """Kernel 2.1 on one block of the main path: held to its plain version
    (check_stats), timed by CUDA events beside the plain version, with the
    bound of phase 2."""
    times = times.clone()
    plans = plans.contiguous().view(torch.int8)
    P, K = plans.shape
    variant = ss.kernel_variant(P, K, plans.data_ptr() % 16 == 0)
    exp = ss.plan_stats_ref(times, weights, plans)
    got = ss.launch_variant(variant, times, weights, plans)
    torch.cuda.synchronize()
    err = check_stats(torch, got, exp, weights, plans)
    kernel_ms = cuda_time_ms(
        torch, lambda: ss.launch_variant(variant, times, weights, plans),
        inner=50)
    plain_ms = cuda_time_ms(
        torch, lambda: ss.plan_stats_ref(times, weights, plans), inner=20)
    nbytes = P * K + 8 * K + 12 * P
    ops = 3 * P * K
    return dict(shape=[P, K], variant=variant, max_abs_err=err,
                kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=max(nbytes / HBM_BYTES_PER_S,
                             ops / F32_OPS_PER_S) * 1e3,
                bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                          >= ops / F32_OPS_PER_S else "operations"),
                library_ms=None, selected=int((plans != 0).sum()))


def identical_decisions(a: "SearchLog", b: "SearchLog", what: str) -> None:
    import numpy as np

    if a.calls != b.calls or not all(
            np.array_equal(x, y) for x, y in zip(a.plans, b.plans)):
        raise AssertionError(f"{what}: decisions differ")


def phase_schedulers(torch, dev, host_ga_s_per_decision: float) -> dict:
    """Phase 10: the paper's schedulers and the fused searches on the card
    (see the module docstring)."""
    from repro_torch.core import search
    from repro_torch.experiment.presets import get_preset
    from repro_torch.kernels import sched_score as ss

    # warm-up (cuBLAS/cuSOLVER handles, first-use costs), not counted
    get_preset("quickstart", max_rounds=1).run(device="cuda")

    # (a) fleet-scale at its defaults: fused BODS, 2.1 on the block
    spec = get_preset("fleet-scale")
    if (spec.scheduler, spec.effective_search_backend()) != ("bods", "fused"):
        raise AssertionError("fleet-scale no longer defaults to fused bods")
    K, n_sel = spec.effective_num_devices(), spec.effective_n_sel()
    run = bods_checked(torch, spec, "fleet-scale fused BODS")
    main, plain, kernel = run["main"], run["plain"], run["kernel"]
    log = main["log"]
    if kernel["variant"] != "stream":
        raise AssertionError(f"fleet-scale's block picked {kernel['variant']}"
                             ", expected stream")
    fleet = dict(
        preset="fleet-scale", scheduler="bods", search_backend="fused",
        K=K, n_sel=n_sel, candidates=spec.fleet.candidates,
        rounds=len(main["records"]), launches=main["launches"],
        launches_by_variant=main["by_variant"],
        launches_per_decision=main["launches"] / log.calls,
        wall_s=main["wall_s"], wall_s_per_decision=main["wall_s"] / log.calls,
        plain_wall_s=plain["wall_s"],
        plain_search_s_per_decision=(plain["log"].seconds
                                     / plain["log"].calls),
        decisions_identical_to_plain=True,
        kernel_vs_plain_max_est_cost_diff=run["est_diff"],
        **log.per_decision(), kernel=kernel, split=log.device_split())

    # (b) fleet-scale with the fused GA and SA, each decision replayed on
    # the CPU from the same inputs and generator state
    searches = []
    for sched, name in (("genetic", "ga_search"), ("sa", "sa_search")):
        spec = get_preset("fleet-scale", scheduler=sched)
        exp = spec.build(device="cuda")
        with SearchLog(torch, search, name, replay_device="cpu") as slog:
            t0 = time.perf_counter()
            result = exp.run()
            wall_s = time.perf_counter() - t0
        check_records(result.records, n_sel, K)
        if sched == "genetic" and slog.differ:
            raise AssertionError(f"fused GA: {len(slog.differ)} decisions "
                                 "differ from the CPU's")
        searches.append(dict(
            scheduler=sched, rounds=len(result.records),
            wall_s=wall_s - slog.replay_seconds, **slog.per_decision(),
            cpu_s_per_decision=slog.replay_seconds / slog.calls,
            host_ga_s_per_decision=host_ga_s_per_decision,
            decisions_differing_from_cpu=len(slog.differ),
            differing=slog.differ, split=slog.device_split()))

    # (c) the paper's scheduler plane on the card; each BODS run is held
    # to the plain version as (a) is
    plane = []
    for preset, sched in (("paper-group-a", "bods"), ("paper-group-b", "bods"),
                          ("quickstart", "bods"), ("quickstart", "rlds"),
                          ("quickstart", "dnn")):
        spec = get_preset(preset, scheduler=sched)
        pretrain, bods = {"s": 0.0}, {}
        if sched == "bods":
            run = bods_checked(torch, spec, f"{preset} fused BODS")
            result, wall_s = run["main"]["result"], run["main"]["wall_s"]
            launches = run["main"]["launches"]
            bods = dict(launches_by_variant=run["main"]["by_variant"],
                        decisions_identical_to_plain=True,
                        kernel_vs_plain_max_est_cost_diff=run["est_diff"],
                        plain_wall_s=run["plain"]["wall_s"],
                        kernel=run["kernel"], **run["main"]["log"].per_decision())
        else:
            exp = spec.build(device="cuda")
            s = exp.engine.scheduler
            if sched == "rlds":
                pretrain_fn = s._pretrain

                def timed_pretrain(*a, _fn=pretrain_fn):
                    t0 = time.perf_counter()
                    _fn(*a)
                    torch.cuda.synchronize()
                    pretrain["s"] = time.perf_counter() - t0

                s._pretrain = timed_pretrain
            reset_plan_stats_counts(ss)
            t0 = time.perf_counter()
            result = exp.run()
            wall_s = time.perf_counter() - t0
            launches = ss.launches
            check_records(result.records, spec.effective_n_sel(),
                          spec.effective_num_devices())
            if launches != 0:
                raise AssertionError(f"{preset}/{sched}: {launches} plan_stats "
                                     "launches without a fused BODS decision")
        summary = result.summary
        plane.append(dict(
            preset=preset, scheduler=sched, rounds=len(result.records),
            wall_s=wall_s, pretrain_s=pretrain["s"],
            wall_s_without_pretrain=wall_s - pretrain["s"],
            rounds_to_target={j: (v["rounds"] if v["time_to_target"]
                                  is not None else None)
                              for j, v in summary.items()},
            time_to_target={j: v["time_to_target"]
                            for j, v in summary.items()},
            plan_stats_launches=launches, **bods))
    return dict(fleet_bods=fleet, fleet_searches=searches, paper=plane)


# ---- phase 11 ------------------------------------------------------------
#
# The online scheduler service at fleet size: online-smoke's tenants and
# traffic (and slo-overload's, for the kill -9 arm) over fleet-scale's
# pool, fused BODS, every rescore through the cuda scoring backend.

SERVICE_K, SERVICE_N_SEL, SERVICE_CANDIDATES = 10_000, 100, 512
SERVICE_CHECKPOINT_EVERY = 4
SERVICE_TIMEOUT_S = 400       # each `python -m repro_torch.serve` process


def service_spec(preset: str, obs_dir=None):
    from repro_torch.experiment.presets import get_preset

    spec = get_preset(preset).replace(fleet=dict(
        num_devices=SERVICE_K, n_sel=SERVICE_N_SEL,
        candidates=SERVICE_CANDIDATES, scoring_backend="cuda"))
    if (spec.scheduler, spec.effective_search_backend()) != ("bods", "fused"):
        raise AssertionError(f"{preset} no longer defaults to fused bods")
    if obs_dir is not None:
        spec = spec.replace(obs=dict(
            trace_path=str(obs_dir / "trace.json"),
            metrics_path=str(obs_dir / "metrics.jsonl"),
            audit_path=str(obs_dir / "audit.jsonl")))
    return spec


class RescoreLog:
    """Wraps one service's ``_rescore`` (the advisory cost of every live
    job's plan at each admission): counts its calls, kernel 2.1's launches
    inside them and their host seconds; times the host-to-device copies
    of the plans (int8) inside them with the stream drained around each;
    keeps the last ``plan_stats_cuda`` inputs."""

    def __init__(self, torch, service):
        from repro_torch.core import scoring
        from repro_torch.kernels import sched_score as ss

        self.calls = self.launches = self.copies = 0
        self.seconds = self.copy_s = 0.0
        self.last = None
        rescore = service._rescore
        h2d, plan_stats = scoring.h2d, scoring.plan_stats_cuda

        def timed_h2d(array, device):
            if array.dtype.name != "int8":
                return h2d(array, device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = h2d(array, device)
            torch.cuda.synchronize()
            self.copy_s += time.perf_counter() - t0
            self.copies += 1
            return out

        def kept_stats(times, counts, plans, device="cuda"):
            self.last = (times, counts, plans)
            return plan_stats(times, counts, plans, device=device)

        def logged(now):
            scoring.h2d, scoring.plan_stats_cuda = timed_h2d, kept_stats
            n0, t0 = ss.launches, time.perf_counter()
            try:
                return rescore(now)
            finally:
                self.seconds += time.perf_counter() - t0
                self.launches += ss.launches - n0
                self.calls += 1
                scoring.h2d, scoring.plan_stats_cuda = h2d, plan_stats

        service._rescore = logged


class SaveLog:
    """Times each ``save_service_checkpoint`` (state gathering, the npz and
    manifest writes, the rename and keep-last-N) and sizes what it wrote."""

    def __init__(self, persistence):
        self.persistence = persistence
        self.orig = persistence.save_service_checkpoint
        self.seconds, self.bytes = [], []

    def _save(self, service, event_idx):
        t0 = time.perf_counter()
        path = self.orig(service, event_idx)
        self.seconds.append(time.perf_counter() - t0)
        self.bytes.append(sum(f.stat().st_size
                              for f in Path(path).iterdir()))
        return path

    def __enter__(self):
        self.persistence.save_service_checkpoint = self._save
        return self

    def __exit__(self, *exc):
        self.persistence.save_service_checkpoint = self.orig
        return False


def record_rows(records) -> list:
    from repro_torch.experiment.spec import _record_to_dict

    return [_record_to_dict(r) for r in records]


def service_run(torch, spec, plain: bool, ckpt_dir=None) -> dict:
    """One ``SchedulerService(spec, device="cuda")`` run: its records,
    report, 2.1's launches in all, by variant, inside the fused BODS
    acquisitions and inside the rescores, the decisions (``SearchLog``),
    checkpoint saves and the last candidate block. With ``plain`` every
    call of 2.1 (the acquisition's and the cuda scoring backend's) runs
    its plain version on the same device tensors instead."""
    from repro_torch.core import search
    from repro_torch.kernels import ops
    from repro_torch.kernels import sched_score as ss
    from repro_torch.serve import persistence
    from repro_torch.serve.service import SchedulerService

    svc = SchedulerService(
        spec, device="cuda", checkpoint_dir=ckpt_dir,
        checkpoint_every=SERVICE_CHECKPOINT_EVERY if ckpt_dir else 0)
    rescores = RescoreLog(torch, svc)
    block, acq = {}, [0]
    dense_stats, plan_stats = search._dense_stats, ops.sched_plan_stats

    def keep_block(times, counts_c, plans):
        block.update(times=times, counts_c=counts_c, plans=plans)
        acq[0] += 1
        return dense_stats(times, counts_c, plans)

    def plain_stats(times, weights, plans, impl="ref"):
        return plan_stats(times, weights, plans, impl="ref")

    search._dense_stats = keep_block
    if plain:
        ops.set_default_impl("ref")
        ops.sched_plan_stats = plain_stats
    try:
        with SearchLog(torch, search, "bods_acquire") as log, \
                SaveLog(persistence) as saves:
            reset_plan_stats_counts(ss)
            t0 = time.perf_counter()
            report = svc.run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = ss.launches
            by_variant = dict(ss.launches_by_variant)
    finally:
        search._dense_stats, ops.sched_plan_stats = dense_stats, plan_stats
        ops.set_default_impl("cuda")
    return dict(svc=svc, report=report, records=svc.engine.records,
                wall_s=wall_s, launches=launches, by_variant=by_variant,
                acquisitions=acq[0], rescores=rescores, log=log,
                saves=saves, block=block)


def check_tenants(svc) -> None:
    """Every tenant of the trace is in the metrics, and each tenant's round
    count is the number of records of its jobs."""
    import collections

    arrived = {ev.tenant for ev in svc.trace if ev.kind == "arrive"}
    tenants = svc.metrics.tenants
    if arrived != set(tenants):
        raise AssertionError(f"tenants {sorted(arrived ^ set(tenants))} "
                             "missing from one side")
    per = collections.Counter(svc._job_tenant[r.job]
                              for r in svc.engine.records)
    if per != {t: s.rounds for t, s in tenants.items() if s.rounds}:
        raise AssertionError("tenant round counts do not match the records")


def rescore_kernel_row(torch, ss, log: RescoreLog) -> dict:
    """Kernel 2.1 on the last rescore's (1, K) inputs against its plain
    version and timed (``block_kernel_row``)."""
    import numpy as np

    times, counts_c, plans = log.last
    dev = torch.device("cuda")
    return block_kernel_row(torch, ss, dict(
        times=torch.from_numpy(np.asarray(times, np.float32)).to(dev),
        counts_c=torch.from_numpy(np.asarray(counts_c, np.float32)).to(dev),
        plans=torch.from_numpy(np.asarray(plans).astype(np.int8)).to(dev)))


def serve_cli(args, cwd, timeout=SERVICE_TIMEOUT_S):
    """``python -m repro_torch.serve --device cuda <args>`` in a process of
    its own; returns (exit code, seconds, its standard error's tail)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve", "--device", "cuda",
         *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=timeout)
    return out.returncode, time.perf_counter() - t0, out.stderr[-3000:]


def chaos_arms(torch) -> dict:
    """(b): slo-overload at the service's pool through the CLI: an
    uninterrupted run, a run hard-killed (``--crash-after``, exit 137)
    mid-horizon with checkpoints every ``SERVICE_CHECKPOINT_EVERY``
    events, and ``--resume`` of its directory. The resumed records must
    equal the uninterrupted run's exactly, and the ladder must degrade."""
    import tempfile

    import numpy as np

    from repro_torch.serve.traffic import trace_from_spec

    spec = service_spec("slo-overload")
    trace = trace_from_spec(spec.arrivals, len(spec.jobs), SERVICE_K)
    # mid-horizon, and past a checkpoint boundary (odd)
    crash_after = (len(trace) // 2) | 1
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        spec.save(str(tmp / "spec.json"))
        rc, ref_s, err = serve_cli(["--spec", "spec.json", "--records-out",
                                    "ref.json"], tmp)
        if rc != 0:
            raise AssertionError(f"uninterrupted run exited {rc}:\n{err}")
        rc, crash_s, err = serve_cli(
            ["--spec", "spec.json", "--checkpoint-dir", "ckpt",
             "--checkpoint-every", str(SERVICE_CHECKPOINT_EVERY),
             "--crash-after", str(crash_after)], tmp)
        if rc != 137:
            raise AssertionError(f"crash arm exited {rc}, expected 137:\n"
                                 f"{err}")
        steps = sorted(int(p.name.split("_")[1])
                       for p in (tmp / "ckpt").glob("step_*"))
        rc, resume_s, err = serve_cli(["--resume", "ckpt", "--records-out",
                                       "res.json"], tmp)
        if rc != 0:
            raise AssertionError(f"resumed run exited {rc}:\n{err}")
        ref = json.loads((tmp / "ref.json").read_text())
        res = json.loads((tmp / "res.json").read_text())
    if ref != res:
        n = sum(a != b for a, b in zip(ref, res))
        raise AssertionError(f"kill -9 + resume diverged: {len(ref)} vs "
                             f"{len(res)} records, {n} differ")
    rungs = {}
    for r in ref:
        rungs[r["rung"]] = rungs.get(r["rung"], 0) + 1
        vals = (r["accuracy"], r["loss"], r["round_time"], r["cost"])
        if not all(v is not None and np.isfinite(v) for v in vals):
            raise AssertionError(f"non-finite record values {vals}")
        if len(set(r["device_ids"])) != len(r["device_ids"]):
            raise AssertionError("a record repeats a device id")
    if sum(v for k, v in rungs.items() if k != "full") == 0:
        raise AssertionError("the degradation histogram is empty")
    dropped = sum(len(r["dropped"]) for r in ref)
    corrupt = sum(len(r["corrupt_ids"]) for r in ref)
    if dropped == 0 or corrupt == 0:
        raise AssertionError(f"faults inert: dropped={dropped} "
                             f"corrupt={corrupt}")
    return dict(preset="slo-overload", K=SERVICE_K, n_sel=SERVICE_N_SEL,
                events=len(trace), crash_after=crash_after,
                checkpoint_every=SERVICE_CHECKPOINT_EVERY,
                steps_on_disk_at_crash=steps, rounds=len(ref),
                records_identical=True, rung_counts=rungs, dropped=dropped,
                corrupt=corrupt, uninterrupted_s=ref_s, crash_s=crash_s,
                resume_s=resume_s)


def phase_service(torch) -> dict:
    """Phase 11 (a): the scheduler service on the card (see the module
    docstring); ``chaos_arms`` is (b)."""
    import tempfile

    from repro_torch.kernels import sched_score as ss
    from repro_torch.monitoring import report as rpt

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        spec = service_spec("online-smoke", obs_dir=tmp)
        main = service_run(torch, spec, False, ckpt_dir=str(tmp / "ckpt"))
        svc, report, log = main["svc"], main["report"], main["log"]
        records, rescores = main["records"], main["rescores"]
        check_records(records, SERVICE_N_SEL, SERVICE_K)
        check_tenants(svc)
        metrics = rpt.load_metrics(spec.obs.metrics_path)
        audit = rpt.load_metrics(spec.obs.audit_path)
        if len(metrics) != len(records) or len(audit) != len(records):
            raise AssertionError(f"{len(metrics)} metrics rows and "
                                 f"{len(audit)} audit rows for "
                                 f"{len(records)} records")
        summary = rpt.summarize(spec.obs.trace_path, spec.obs.metrics_path)
    phases = summary["phases"]
    for name in ("schedule", "aggregate"):
        if phases.get(name, {}).get("count") != len(records):
            raise AssertionError(f"{name} spans do not match the records")
    served = sum(phases[n]["total_ms"] for n in
                 ("serve_advance", "handle_event", "checkpoint_write")
                 if n in phases) / 1e3
    # 2.1 launches on three paths: once per fused BODS acquisition, once
    # per live job at each admission's rescore (1, K), and BODS's own cost
    # estimates through the cuda scoring backend (its bootstrap and each
    # round's observe)
    acq = main["acquisitions"]
    if log.calls == 0 or acq != log.calls:
        raise AssertionError(f"{acq} acquisition launches of plan_stats "
                             f"for {log.calls} fused BODS decisions")
    if rescores.launches == 0 or rescores.launches != rescores.copies:
        raise AssertionError(f"{rescores.launches} rescore launches for "
                             f"{rescores.copies} plan copies")
    observe = main["launches"] - acq - rescores.launches
    if observe < len(records):
        raise AssertionError(f"{observe} cost-model launches for "
                             f"{len(records)} observed rounds")
    block = block_kernel_row(torch, ss, main["block"])
    rescore = rescore_kernel_row(torch, ss, rescores)

    # the same spec with every call of 2.1 on its plain version
    plain = service_run(torch, service_spec("online-smoke"), True)
    if plain["launches"] != 0:
        raise AssertionError("the plain run launched plan_stats")
    if record_rows(plain["records"]) != record_rows(records):
        raise AssertionError("records differ from the plain run's")
    if plain["svc"].rescore_costs != svc.rescore_costs:
        raise AssertionError("rescore costs differ from the plain run's")

    lat = report.decision_latency
    saves = main["saves"]
    service = dict(
        preset="online-smoke", scheduler="bods", search_backend="fused",
        K=SERVICE_K, n_sel=SERVICE_N_SEL, candidates=SERVICE_CANDIDATES,
        events=len(svc.trace), arrivals=report.arrivals,
        admissions=report.decision_latency["count"],
        readmissions=report.readmissions, departures=report.departures,
        churn_events=report.churn_events, rounds=len(records),
        tenants=len(svc.metrics.tenants), wall_s=main["wall_s"],
        plain_wall_s=plain["wall_s"],
        decision_latency_p50_ms=lat["p50_s"] * 1e3,
        decision_latency_p99_ms=lat["p99_s"] * 1e3,
        bods_decisions=log.calls,
        bods_s_per_decision=log.seconds / log.calls,
        bods_syncs_per_decision=log.syncs / log.calls,
        launches=main["launches"],
        launches_by_path={"acquisition": acq, "rescore": rescores.launches,
                          "bods cost model": observe},
        launches_by_variant=main["by_variant"],
        rescores=rescores.calls,
        rescore_ms_per_admission=rescores.seconds / rescores.calls * 1e3,
        rescore_plan_copies=rescores.copies,
        rescore_plan_copy_ms=rescores.copy_s / rescores.copies * 1e3,
        checkpoint_saves=len(saves.seconds),
        checkpoint_bytes=(statistics.median(saves.bytes)
                          if saves.bytes else None),
        checkpoint_s=(statistics.median(saves.seconds)
                      if saves.seconds else None),
        checkpoint_s_max=max(saves.seconds) if saves.seconds else None,
        records_identical_to_plain=True,
        rescore_costs_identical_to_plain=True,
        span_coverage_of_run=served / main["wall_s"],
        report_coverage=summary["coverage"],
        recompiles=summary["recompiles"],
        phase_p50_ms={n: p["p50_ms"] for n, p in phases.items()},
        phase_count={n: p["count"] for n, p in phases.items()},
        bods_block=block, rescore_block=rescore)
    return service


# ---- phase 12 ------------------------------------------------------------
#
# The scheduler gym on the card: environment throughput, REINFORCE training
# through ``python -m repro_torch.gym`` at the gym's published size, and the
# ``policy`` axis warm-starting RLDS and fused BODS from zoo entries.

GYM_SIZES = ((64, 1), (64, 32), (64, 256), (256, 1), (256, 32), (256, 256))
GYM_T = 32                 # rounds per rollout
GYM_PROFILE_STEPS = 4      # rounds under torch.profiler per rollout
GYM_JOBS = 3
GYM_CURRICULUM = "full"
GYM_TRAIN = ("--curriculum", "full", "--num-devices", "64,256", "--envs",
             "32", "--rollout", "32", "--minibatches", "4", "--iters", "8")
GYM_WARM_ROUNDS = 20       # rlds-warmstart's depth (the preset runs 150)
GYM_TIMEOUT_S = 400        # each `python -m repro_torch.gym` process
FLIP_RTOL = 1e-6


class RoundLog:
    """Wraps ``repro_torch.gym.env._apply_round`` for one run: keeps each
    round's plans (E, K), occupancy clocks and launch instants on the host,
    and its ``StepOut`` costs."""

    def __init__(self, env):
        self.env, self.rows = env, []
        self._orig = env._apply_round

    def _wrapper(self, cfg, state, plan, *draws):
        now = self.env.release_instant(cfg, state)
        new, out = self._orig(cfg, state, plan, *draws)
        self.rows.append(dict(plan=plan.cpu(), busy=state.busy_until.cpu(),
                              now=now.cpu(), cost=out.cost.cpu()))
        return new, out

    def __enter__(self):
        self.env._apply_round = self._wrapper
        return self

    def __exit__(self, *exc):
        self.env._apply_round = self._orig
        return False


def gym_flip_margin(torch, row, other, gumbel, e: int, n_sel: int) -> dict:
    """Why env ``e``'s plan may differ between two devices at this round:
    the relative distance from the availability threshold ``now + 1e-6``
    of the nearest device whose choice differs, and the top-k margin (the
    gap between the n_sel-th and next Gumbel key among the available)."""
    busy, now = row["busy"][e].double(), float(row["now"][e])
    scale = max(1.0, abs(now))
    moved = row["plan"][e] != other["plan"][e]
    avail_margin = float((busy[moved] - (now + 1e-6)).abs().min()) / scale
    keys = torch.where(busy <= now + 1e-6, gumbel[e].double().cpu(),
                       -torch.inf)
    top = torch.sort(keys, descending=True).values
    gap = float(top[n_sel - 1] - top[n_sel]) if keys.numel() > n_sel else 0.0
    topk_margin = gap / max(1.0, abs(float(top[n_sel - 1])))
    return dict(avail_margin=avail_margin, topk_margin=topk_margin)


def gym_replay(torch, genv, cfg, states, noise, card: RoundLog) -> dict:
    """The random rollout again on the CPU port from the same states and
    draws: costs within 1e-5, plans identical; a flip counts only where
    its availability or top-k margin lies within ``FLIP_RTOL``, and that
    env is compared no further."""
    from repro_torch.tree import tree_map

    cpu_states = tree_map(lambda x: x.cpu(), states)
    cpu_noise = tuple(x.cpu() for x in noise)
    with RoundLog(genv) as cpu:
        genv.random_rollout(cfg, cpu_states, GYM_T, noise=cpu_noise)
    E = states.busy_until.shape[0]
    live = torch.ones(E, dtype=torch.bool)
    flips, cost_err = [], 0.0
    for t, (a, b) in enumerate(zip(card.rows, cpu.rows)):
        differ = (a["plan"] != b["plan"]).any(-1) & live
        for e in torch.nonzero(differ).flatten().tolist():
            m = gym_flip_margin(torch, a, b, cpu_noise[2][:, t], e,
                                cfg.n_sel)
            if min(m.values()) > FLIP_RTOL:
                raise AssertionError(f"gym replay: env {e} round {t} plan "
                                     f"differs from the CPU's, margins {m}")
            flips.append(dict(env=e, round=t, **m))
        live &= ~differ
        ca, cb = a["cost"][live].double(), b["cost"][live].double()
        err = (ca - cb).abs()
        if not bool((err <= 1e-5 * cb.abs().clamp(min=1.0)).all()):
            raise AssertionError(f"gym replay: round {t} costs differ by "
                                 f"{float(err.max())}")
        cost_err = max(cost_err, float(err.max()) if err.numel() else 0.0)
    return dict(flips=flips, envs_compared_to_end=int(live.sum()),
                max_cost_err=cost_err)


def gym_rollouts(torch) -> list:
    """Phase 12 (a): random and policy rollouts at each (K, E) of
    ``GYM_SIZES`` on the card from one set of draws: env steps (E x T
    rounds) a second of host wall, launches per round and the device's
    idle share from torch.profiler over ``GYM_PROFILE_STEPS`` rounds; each
    random rollout replayed on the CPU (``gym_replay``)."""
    from repro_torch.core.schedulers.rlds import init_policy
    from repro_torch.gym import env as genv
    from repro_torch.gym.scenarios import CURRICULA

    dev = torch.device("cuda")
    scen = CURRICULA[GYM_CURRICULUM]
    params = init_policy(torch.Generator().manual_seed(0), dev)
    rows = []
    for K, E in GYM_SIZES:
        cfg = genv.EnvConfig(num_devices=K, num_jobs=GYM_JOBS,
                             n_sel=max(1, round(0.1 * K)))
        gen = torch.Generator(device=dev).manual_seed(K * 1000 + E)
        states = genv.batch_reset(cfg, scen, gen, E, device=dev)
        noise = genv.draw_noise(gen, (E, GYM_T, K), dev)
        head = tuple(x[:, :GYM_PROFILE_STEPS] for x in noise)
        for kind in ("random", "policy"):
            if kind == "random":
                def run(T=GYM_T, nz=noise):
                    return genv.random_rollout(cfg, states, T, noise=nz)
            else:
                def run(T=GYM_T, nz=noise):
                    return genv.policy_rollout(cfg, params, states, T,
                                               noise=nz)
            run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, out = run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            if not bool(torch.isfinite(out.cost).all()):
                raise AssertionError(f"gym {kind} K={K} E={E}: non-finite "
                                     "costs")
            split = device_split(torch, lambda: run(GYM_PROFILE_STEPS, head),
                                 1)
            row = dict(kind=kind, K=K, E=E, T=GYM_T, n_sel=cfg.n_sel,
                       wall_s=wall_s, env_steps_per_s=E * GYM_T / wall_s,
                       ms_per_round=wall_s / GYM_T * 1e3,
                       launches_per_round=(split["device_events"]
                                           / GYM_PROFILE_STEPS),
                       device_idle_share=split["device_idle_share"],
                       device_busy_ms_per_round=(
                           split["device_busy_ms"] / GYM_PROFILE_STEPS
                           if split["device_busy_ms"] is not None else None),
                       mean_cost=float(out.cost.mean()))
            if kind == "random":
                with RoundLog(genv) as card:
                    run()
                row["cpu_replay"] = gym_replay(torch, genv, cfg, states,
                                               noise, card)
            rows.append(row)
    return rows


def gym_cli(args, cwd) -> tuple:
    """``python -m repro_torch.gym *args`` on the card: its stdout and wall
    seconds; fails on a non-zero exit."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.gym", *args],
                         cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=GYM_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"python -m repro_torch.gym {args[0]} exited "
                             f"{out.returncode}: {out.stderr[-3000:]}")
    return out.stdout, wall_s


def gym_train(zoo: str, name: str) -> dict:
    """Phase 12 (b): training through the CLI at the gym's published size
    (``GYM_TRAIN``, the reference CLI's documented command with 8 of its 80
    iterations), then ``eval`` and ``list`` on the saved entry."""
    import math
    import re

    text, train_s = gym_cli(("train", "--name", name, *GYM_TRAIN, "--zoo",
                             zoo, "--device", "cuda"), ROOT)
    iters = [dict(iter=int(m[1]), stage=int(m[2]), mean_cost=float(m[3]),
                  ms=float(m[4])) for m in re.finditer(
        r"iter +(\d+) stage (\d+) mean_cost=(\S+) \((\d+) ms\)", text)]
    if len(iters) != 8 or not all(math.isfinite(i["mean_cost"])
                                  for i in iters):
        raise AssertionError(f"gym train: iterations {iters}")
    ev = re.search(r"trained mean_cost=(\S+) +untrained=(\S+)", text)
    by_stage = {}
    for i in iters:
        by_stage.setdefault(i["stage"], []).append(i["ms"])
    ev_text, eval_s = gym_cli(("eval", "--name", name, "--curriculum",
                               "full", "--num-devices", "64", "--zoo", zoo,
                               "--device", "cuda"), ROOT)
    evaluation = json.loads(ev_text)
    if not math.isfinite(evaluation["eval"]["mean_cost"]):
        raise AssertionError(f"gym eval: {evaluation}")
    listing, _ = gym_cli(("list", "--zoo", zoo), ROOT)
    if name not in listing:
        raise AssertionError(f"gym list: {listing!r}")
    sizes = GYM_TRAIN[GYM_TRAIN.index("--num-devices") + 1].split(",")
    return dict(args=list(GYM_TRAIN), process_s=train_s,
                ms_per_iter_by_stage={
                    f"K={sizes[s]}": ms for s, ms in by_stage.items()},
                mean_cost_by_iter=[i["mean_cost"] for i in iters],
                eval_trained_cost=float(ev[1]),
                eval_untrained_cost=float(ev[2]),
                eval_cli=evaluation["eval"], eval_process_s=eval_s)


def phase_gym(torch) -> dict:
    """Phase 12: the scheduler gym on the card (see the module docstring).
    (c) ``rlds-warmstart`` on (b)'s entry, and ``quickstart``'s fused BODS
    cold, saved to the zoo and run again warm through ``bods_checked``."""
    import tempfile

    from repro_torch.experiment.presets import get_preset
    from repro_torch.gym import PolicyZoo
    from repro_torch.kernels import sched_score as ss

    rollouts = gym_rollouts(torch)
    with tempfile.TemporaryDirectory() as zoo:
        train = gym_train(zoo, "rlds-full")

        spec = get_preset("rlds-warmstart", policy="rlds-full",
                          policy_dir=zoo, max_rounds=GYM_WARM_ROUNDS)
        exp = spec.build(device="cuda")
        sched = exp.engine.scheduler
        if not sched._pretrained:
            raise AssertionError("the warm-started RLDS is not pretrained")

        def no_pretrain(*a):
            raise AssertionError("rlds-warmstart ran the lazy pretraining")

        sched._pretrain = no_pretrain
        reset_plan_stats_counts(ss)
        t0 = time.perf_counter()
        result = exp.run()
        wall_s = time.perf_counter() - t0
        check_records(result.records, spec.effective_n_sel(),
                      spec.effective_num_devices())
        if ss.launches != 0:
            raise AssertionError(f"rlds-warmstart: {ss.launches} plan_stats "
                                 "launches")
        warm_rlds = dict(preset="rlds-warmstart", max_rounds=GYM_WARM_ROUNDS,
                         rounds=len(result.records), wall_s=wall_s,
                         s_per_round=wall_s / len(result.records),
                         plan_stats_launches=0, pretrain_ran=False)

        spec = get_preset("quickstart")
        if (spec.scheduler, spec.effective_search_backend()) != ("bods",
                                                                 "fused"):
            raise AssertionError("quickstart no longer defaults to fused bods")
        cold = spec.build(device="cuda")
        t0 = time.perf_counter()
        cold_result = cold.run()
        cold_s = time.perf_counter() - t0
        check_records(cold_result.records, spec.effective_n_sel(),
                      spec.effective_num_devices())
        PolicyZoo(zoo).save_scheduler("bods-quickstart", cold.engine.scheduler,
                                      meta={"preset": "quickstart"})
        warm = spec.replace(policy="bods-quickstart", policy_dir=zoo)
        run = bods_checked(torch, warm, "quickstart warm-started BODS")
    if run["kernel"]["variant"] != "row":
        raise AssertionError(f"quickstart's block picked "
                             f"{run['kernel']['variant']}, expected row")
    main = run["main"]
    warm_bods = dict(
        preset="quickstart", scheduler="bods", search_backend="fused",
        cold_rounds=len(cold_result.records), cold_wall_s=cold_s,
        rounds=len(main["records"]), wall_s=main["wall_s"],
        plain_wall_s=run["plain"]["wall_s"], launches=main["launches"],
        launches_by_variant=main["by_variant"],
        decisions_identical_to_plain=True,
        kernel_vs_plain_max_est_cost_diff=run["est_diff"],
        kernel=run["kernel"], **main["log"].per_decision())
    return dict(rollouts=rollouts, train=train, warm_rlds=warm_rlds,
                warm_bods=warm_bods)


# ---- phase 13 ------------------------------------------------------------
#
# Fleet sharding (module 7): the fleet axis of scoring in blocks, kernel
# 2.1 once per block; the fused searches split over one card named N times;
# fleet-scale through the spec with fleet.num_shards set.

SHARD_DENSE_K, SHARD_DENSE_P = 262_144, 4096    # bench_fleet's DENSE_MAX_K
SHARD_INDEX_K, SHARD_INDEX_P, SHARD_INDEX_SEL = 1_000_000, 4096, 10_000
SHARD_COUNTS = (1, 2, 4, 8)
SHARD_INDEX_COUNTS = (1, 4, 8)
SHARD_SEARCH_N = 4
SHARD_REPS = 3


class ShardClock:
    """Host time inside one sharded scoring call, split into the host block
    copies (``shard._dense_block``), the copies to the card (``shard.h2d``,
    the stream drained after each), the partials (CUDA events from just
    before each ``shard._partial_stats_dense`` to its end: the host's launch
    path and the kernel, or the plain version) and the combine
    (``shard._combine``, after a drain). Keeps the last block's inputs.
    Installed only around the measured calls."""

    NAMES = ("_dense_block", "h2d", "_partial_stats_dense", "_combine")

    def __init__(self, torch, shard):
        self.torch, self.shard = torch, shard
        self._orig = {n: getattr(shard, n) for n in self.NAMES}
        self.reset()

    def reset(self):
        self.block_s = self.h2d_s = self.combine_s = 0.0
        self.events, self.last = [], None

    def partials_ms(self) -> float:
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)

    def __enter__(self):
        torch, o = self.torch, self._orig

        def copying(fn, attr):
            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                setattr(self, attr, getattr(self, attr)
                        + time.perf_counter() - t0)
                return out
            return wrapper

        def partial(times_b, w_b, plans_b, impl):
            self.last = (times_b, w_b, plans_b)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = o["_partial_stats_dense"](times_b, w_b, plans_b, impl)
            end.record()
            self.events.append((start, end))
            return out

        def combine(parts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = o["_combine"](parts)
            self.combine_s += time.perf_counter() - t0
            return out

        self.shard._dense_block = copying(o["_dense_block"], "block_s")
        self.shard.h2d = copying(o["h2d"], "h2d_s")
        self.shard._partial_stats_dense = partial
        self.shard._combine = combine
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.shard, name, fn)
        return False


def shard_dense_inputs(torch, dev):
    """bench_fleet's dense size on the host: (K,) times and counts, (P, K)
    int8 plans of n_sel = K/100 devices a row (row 0 empty), drawn on the
    card from a seed."""
    K, P = SHARD_DENSE_K, SHARD_DENSE_P
    g = torch.Generator(device=dev).manual_seed(1700)
    times = torch.rand(K, device=dev, generator=g) * 100.0 + 0.1
    counts = torch.randint(0, 6, (K,), device=dev, generator=g)
    plans = torch.zeros((P, K), dtype=torch.int8, device=dev)
    for r0 in range(0, P, 1024):
        keys = torch.rand((min(1024, P - r0), K), device=dev, generator=g)
        plans[r0:r0 + 1024].scatter_(
            1, keys.topk(K // 100, dim=1, sorted=False).indices, 1)
        del keys
    plans[0] = 0
    out = (times.double().cpu().numpy(), counts.double().cpu().numpy(),
           plans.cpu().numpy())
    del plans
    torch.cuda.empty_cache()
    return out


def shard_dense(torch, dev, smi: str) -> dict:
    """(a) Dense scoring at K = 262,144, P = 4096 under ``emulate`` at each
    N with the ``cuda`` and ``torch`` backends against single-lane
    ``cuda``: scores within 1e-5, ``max`` and ``n`` exact, 2.1 once per
    block, each call split by ``ShardClock`` (medians of ``SHARD_REPS``),
    2.1 on each N's last block held to its plain version and timed alone
    (N = 1's block is the whole plans)."""
    import numpy as np

    from repro_torch.core import scoring, shard
    from repro_torch.kernels import sched_score as ss

    times, counts, plans = shard_dense_inputs(torch, dev)
    counts_c = counts - counts.mean()
    kw = dict(alpha=4.0, beta=0.25, time_scale=3.0, fairness_scale=0.09,
              delta_fairness=True)
    coef = (kw["alpha"], kw["beta"], kw["time_scale"], kw["fairness_scale"],
            kw["delta_fairness"])
    reset_plan_stats_counts(ss)
    t0 = time.perf_counter()
    want_stats = scoring.plan_stats_cuda(times, counts_c, plans, device=dev)
    single_s = time.perf_counter() - t0
    want = scoring._score_from_stats(want_stats, counts_c, *coef)
    want_t = np.where(want_stats[:, 0] > -1e29, want_stats[:, 0], -np.inf)
    launches = {"single lane": ss.launches}
    by_variant = dict(ss.launches_by_variant)
    rows, last = [], None
    for N in SHARD_COUNTS:
        for backend in ("cuda", "torch"):
            calls = []
            with ShardClock(torch, shard) as clock:
                for _ in range(SHARD_REPS):
                    clock.reset()
                    reset_plan_stats_counts(ss)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    stats = shard.plan_stats_sharded(
                        times, counts_c, plans, "dense", N,
                        executor="emulate", backend=backend, device=dev)
                    got = scoring._score_from_stats(stats, counts_c, *coef)
                    wall = time.perf_counter() - t0
                    calls.append(dict(wall_ms=wall * 1e3,
                                      host_block_ms=clock.block_s * 1e3,
                                      h2d_ms=clock.h2d_s * 1e3,
                                      partials_ms=clock.partials_ms(),
                                      combine_ms=clock.combine_s * 1e3))
                    if not (np.array_equal(stats[:, 0], want_t)
                            and np.array_equal(stats[:, 1],
                                               want_stats[:, 1])):
                        raise AssertionError(f"N={N} {backend}: max or n "
                                             "differs from the single lane")
                    rel = float(np.max(np.abs(got - want) / np.maximum(
                        np.abs(want), 1e-12)))
                    if rel > 1e-5:
                        raise AssertionError(f"N={N} {backend}: scores off "
                                             f"by {rel} relative")
                    n_launch = ss.launches
                    if n_launch != (N if backend == "cuda" else 0):
                        raise AssertionError(f"N={N} {backend}: 2.1 launched "
                                             f"{n_launch} times")
                    for v, n in ss.launches_by_variant.items():
                        by_variant[v] += n
                    launches[f"N={N} {backend}"] = (
                        launches.get(f"N={N} {backend}", 0) + n_launch)
            med = {k: statistics.median(c[k] for c in calls)
                   for k in calls[0]}
            row = dict(N=N, backend=backend, block=[
                SHARD_DENSE_P, shard.shard_sizes(SHARD_DENSE_K, N)[0]],
                scores_max_rel_diff=rel, max_and_n_exact=True,
                launches_per_call=N if backend == "cuda" else 0, **med)
            if backend == "cuda":
                # 2.1 alone on the call's last block, held to its plain
                # version (N = 1: the whole plans)
                row["kernel"] = kernel_row(torch, ss, *clock.last)
                if row["kernel"]["variant"] != "stream":
                    raise AssertionError(f"N={N}: the last block picked "
                                         f"{row['kernel']['variant']}")
            rows.append(row)
            del clock
    return dict(card=smi, K=SHARD_DENSE_K, P=SHARD_DENSE_P,
                n_sel=SHARD_DENSE_K // 100, plans_bytes=int(plans.nbytes),
                executor="emulate", reps=SHARD_REPS,
                single_lane_cuda_ms=single_s * 1e3, calls=rows,
                launches=sum(launches.values()), launches_by_call=launches,
                launches_by_variant=by_variant,
                kernel=max((r["kernel"] for r in rows if "kernel" in r),
                           key=lambda k: k["max_abs_err"]))


def shard_index(torch, dev, smi: str) -> dict:
    """(b) Index form at K = 1e6, P = 4096, n_sel = 10,000: candidates from
    ``random_plan_indices_sharded`` on the card at each N (valid rows:
    n_sel distinct available ids), seconds and peak device memory; the
    sharded index scores within 1e-5 of the single lane's."""
    import numpy as np

    from repro_torch.core import scoring, shard

    K, P, S = SHARD_INDEX_K, SHARD_INDEX_P, SHARD_INDEX_SEL
    rng = np.random.default_rng(1701)
    avail = rng.random(K) < 0.9
    times = rng.uniform(0.1, 100.0, K)
    counts = rng.integers(0, 6, K).astype(np.float64)
    avail_t = torch.from_numpy(avail).to(dev)
    kw = dict(alpha=4.0, beta=0.25, time_scale=3.0, fairness_scale=0.09,
              delta_fairness=True)
    rows = []
    for N in SHARD_INDEX_COUNTS:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        idx = shard.random_plan_indices_sharded(
            np.random.default_rng(N), avail, S, P, N, device=dev)
        draw_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        ids = torch.from_numpy(idx).to(dev).long()
        srt = ids.sort(dim=1).values
        valid = (idx.shape == (P, S)
                 and bool((srt[:, 1:] != srt[:, :-1]).all())
                 and int(ids.min()) >= 0 and int(ids.max()) < K
                 and bool(avail_t[ids].all()))
        if not valid:
            raise AssertionError(f"N={N}: invalid candidate rows")
        del ids, srt
        t0 = time.perf_counter()
        got = scoring.score_plan_indices(times, counts, idx, backend="torch",
                                         num_shards=N, device=dev, **kw)
        score_s = time.perf_counter() - t0
        want = scoring.score_plan_indices(times, counts, idx,
                                          backend="torch", device=dev, **kw)
        rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                           1e-12)))
        if rel > 1e-5:
            raise AssertionError(f"N={N}: index scores off by {rel}")
        rows.append(dict(N=N, block=shard.shard_sizes(K, N)[0], valid=True,
                         draw_s=draw_s, peak_bytes=int(peak),
                         score_s=score_s, scores_max_rel_diff=rel))
    return dict(card=smi, K=K, P=P, n_sel=S, executor="emulate",
                draws=rows)


class ShardedSearch:
    """Runs every call of a search entry point of ``repro_torch.core.search``
    with ``num_shards=n`` on ``devices`` (the one card named n times)."""

    def __init__(self, search, name, n, devices):
        self.search, self.name = search, name
        self.n, self.devices = n, devices
        self._orig = getattr(search, name)

    def __enter__(self):
        orig, n, devices = self._orig, self.n, self.devices

        def sharded(*a, **kw):
            return orig(*a, **dict(kw, num_shards=n, devices=devices))

        setattr(self.search, self.name, sharded)
        return self

    def __exit__(self, *exc):
        setattr(self.search, self.name, self._orig)
        return False


def search_run(torch, scheduler: str, n: int, dev) -> dict:
    """fleet-scale's fused ``scheduler`` on the card, its search split over
    ``[dev] * n`` (n = 1: the single lane): the records, each decision's
    plan, 2.1's launches by variant, BODS's candidate blocks by decision
    and the last block's inputs to the statistics."""
    from repro_torch.core import search
    from repro_torch.experiment.presets import get_preset
    from repro_torch.kernels import sched_score as ss

    name = {"bods": "bods_acquire", "genetic": "ga_search",
            "sa": "sa_search"}[scheduler]
    spec = get_preset("fleet-scale", scheduler=scheduler)
    exp = spec.build(device=str(dev))
    blocks, stats_in = [], {}
    cands_fn, dense_stats = search.bods_candidates, search._dense_stats

    def keep_cands(*a, **kw):
        out = cands_fn(*a, **kw)
        blocks.append(out.clone())
        return out

    def keep_stats(times, counts_c, plans):
        stats_in.update(times=times, counts_c=counts_c, plans=plans)
        return dense_stats(times, counts_c, plans)

    search.bods_candidates, search._dense_stats = keep_cands, keep_stats
    try:
        with ShardedSearch(search, name, n, [dev] * n), \
                SearchLog(torch, search, name) as log:
            reset_plan_stats_counts(ss)
            t0 = time.perf_counter()
            result = exp.run()
            wall_s = time.perf_counter() - t0
            launches, by_variant = ss.launches, dict(ss.launches_by_variant)
    finally:
        search.bods_candidates, search._dense_stats = cands_fn, dense_stats
    check_records(result.records, spec.effective_n_sel(),
                  spec.effective_num_devices())
    per = max(len(blocks) // max(log.calls, 1), 1)
    return dict(records=result.records, log=log, wall_s=wall_s,
                launches=launches, by_variant=by_variant,
                blocks=[torch.cat(blocks[i:i + per])
                        for i in range(0, len(blocks), per)],
                stats_in=stats_in)


def shard_searches(torch, dev, smi: str) -> dict:
    """(c) fleet-scale's fused SA, GA and BODS (512 candidates) split over
    the one card named 4 times, against the single lane: identical plans
    decision by decision (BODS also its candidate blocks, bit for bit), 2.1
    once per block per BODS decision (held to its plain version on the last
    block), ms per decision at both N."""
    from repro_torch.kernels import sched_score as ss

    out, single = {}, {}
    for sched in ("sa", "genetic", "bods"):
        one = search_run(torch, sched, 1, dev)
        many = search_run(torch, sched, SHARD_SEARCH_N, dev)
        single[sched] = one
        identical_decisions(one["log"], many["log"],
                            f"fused {sched}, N={SHARD_SEARCH_N} vs 1")
        est_diff = compare_runs(one["records"], many["records"])
        row = dict(decisions=one["log"].calls,
                   ms_per_decision_n1=one["log"].seconds / one["log"].calls
                   * 1e3,
                   ms_per_decision_n4=many["log"].seconds / many["log"].calls
                   * 1e3,
                   plans_identical=True, max_est_cost_diff=est_diff)
        if sched == "bods":
            calls = many["log"].calls
            if one["launches"] != calls or \
                    many["launches"] != SHARD_SEARCH_N * calls:
                raise AssertionError(
                    f"BODS: 2.1 launched {one['launches']} and "
                    f"{many['launches']} times for {calls} decisions")
            if len(one["blocks"]) != calls or len(many["blocks"]) != calls \
                    or not all(torch.equal(a, b) for a, b in
                               zip(one["blocks"], many["blocks"])):
                raise AssertionError("BODS: candidate blocks differ at N="
                                     f"{SHARD_SEARCH_N}")
            kernel = block_kernel_row(torch, ss, many["stats_in"])
            if many["by_variant"].get(kernel["variant"]) != many["launches"]:
                raise AssertionError(f"BODS launches by variant "
                                     f"{many['by_variant']}")
            row.update(candidate_blocks_identical=True,
                       launches_n1=one["launches"],
                       launches_by_variant_n1=one["by_variant"],
                       launches_n4=many["launches"],
                       launches_by_variant_n4=many["by_variant"],
                       kernel=kernel)
        out[sched] = row
    return dict(card=smi, preset="fleet-scale", N=SHARD_SEARCH_N,
                devices=f"[cuda:0] * {SHARD_SEARCH_N}", **out), single


def host_ga_replayed(torch, spec, dev) -> dict:
    """``spec`` (the host GA, ``scoring_backend="cuda"``) on the card with
    every decision replayed at ``num_shards=1`` from the same inputs and
    generator state: the records, the decisions, 2.1's launches in the run
    and in the replays, each decision that differs with both plans'
    Formula-2 costs (float64, numpy backend) and their margin, and, for
    every population the run scores, the pairs of plans whose order the
    sharded costs swap against the single lane's (``compared``): a GA
    decision flips through its tournaments, so the near ties show there,
    not in the margin between the two final plans."""
    import copy

    import numpy as np

    from repro_torch.core import scoring
    from repro_torch.kernels import sched_score as ss

    exp = spec.build(device=str(dev))
    sched = exp.engine.scheduler
    cm = sched.cost_model
    schedule = sched.schedule
    cost_batch = cm.cost_batch
    log = dict(decisions=0, replay_launches=0, flips=[], replay_s=0.0)
    pairs = dict(calls=0, score_max_rel_diff=0.0, order_flips=0,
                 max_single_gap_of_flipped=0.0, exact_ties_broken=0)

    def compared(times, counts, plans, backend=None):
        """The sharded costs, beside the single lane's on the same plans
        (the plain ``torch`` backend: no launch): their largest relative
        difference, and every pair of plans whose order they swap, with
        the single lane's gap between the two."""
        got = cost_batch(times, counts, plans, backend=backend)
        if cm.num_shards == 1:
            return got
        t0 = time.perf_counter()
        one = scoring.score_plans(
            times, counts, plans, alpha=cm.alpha, beta=cm.beta,
            time_scale=cm.time_scale, fairness_scale=cm.fairness_scale,
            delta_fairness=cm.delta_fairness, backend="torch", device=dev)
        swapped = (np.sign(got[:, None] - got[None, :])
                   != np.sign(one[:, None] - one[None, :]))
        gap = np.abs(one[:, None] - one[None, :])[swapped]
        pairs["calls"] += 1
        pairs["score_max_rel_diff"] = max(pairs["score_max_rel_diff"], float(
            np.max(np.abs(got - one) / np.maximum(np.abs(one), 1e-12))))
        pairs["order_flips"] += int(swapped.sum()) // 2
        pairs["exact_ties_broken"] += int((gap == 0.0).sum()) // 2
        if gap.size:
            pairs["max_single_gap_of_flipped"] = max(
                pairs["max_single_gap_of_flipped"], float(gap.max()))
        log["replay_s"] += time.perf_counter() - t0
        return got

    cm.cost_batch = compared

    def replayed(ctx):
        state = copy.deepcopy(sched.rng.bit_generator.state)
        plan = schedule(ctx)
        after = copy.deepcopy(sched.rng.bit_generator.state)
        est = sched.last_estimated_cost
        sched.rng.bit_generator.state = state
        n, before = cm.num_shards, ss.launches
        cm.num_shards = 1
        t0 = time.perf_counter()
        try:
            other = schedule(ctx)
        finally:
            cm.num_shards = n
        log["replay_s"] += time.perf_counter() - t0
        sched.last_estimated_cost = est
        log["replay_launches"] += ss.launches - before
        sched.rng.bit_generator.state = after
        if not np.array_equal(plan, other):
            c = scoring.score_plans(
                ctx.expected_times, ctx.counts, np.stack([plan, other]),
                alpha=cm.alpha, beta=cm.beta, time_scale=cm.time_scale,
                fairness_scale=cm.fairness_scale,
                delta_fairness=cm.delta_fairness, backend="numpy")
            log["flips"].append(dict(
                decision=log["decisions"], sharded_cost=float(c[0]),
                single_cost=float(c[1]), margin=float(abs(c[0] - c[1])),
                relative_margin=float(abs(c[0] - c[1])
                                      / max(abs(c[1]), 1e-12))))
        log["decisions"] += 1
        return plan

    sched.schedule = replayed
    reset_plan_stats_counts(ss)
    t0 = time.perf_counter()
    result = exp.run()
    wall_s = time.perf_counter() - t0
    log["population"] = sched.population
    return dict(result=result, wall_s=wall_s - log["replay_s"],
                launches=ss.launches - log["replay_launches"],
                by_variant=dict(ss.launches_by_variant),
                generations=sched.generations, score_pairs=pairs, **log)


def shard_spec(torch, dev, smi: str, single: dict) -> dict:
    """(d) fleet-scale through ``ExperimentSpec.build/run`` with
    ``fleet.num_shards`` 4 and "auto": the fused schedulers fall back to one
    lane on one card (counted) and their records equal the single lane's
    from (c); the host GA scores through 2.1 once per block, every decision
    replayed at one shard, each flip printed with its cost margin."""
    import dataclasses

    from repro_torch.core import search, shard
    from repro_torch.experiment.presets import get_preset

    fused = {}
    for sched in ("sa", "genetic", "bods"):
        for n in (SHARD_SEARCH_N, "auto"):
            spec = get_preset("fleet-scale", scheduler=sched)
            spec = spec.replace(fleet=dataclasses.replace(spec.fleet,
                                                          num_shards=n))
            before = search.fallbacks
            result = spec.run(device=str(dev))
            est_diff = compare_runs(single[sched]["records"], result.records)
            fused[f"{sched} num_shards={n}"] = dict(
                resolved=spec.effective_num_shards(),
                fallbacks=search.fallbacks - before,
                records_equal_single_lane=True, max_est_cost_diff=est_diff)
    base = get_preset("fleet-scale", scheduler="genetic",
                      search_backend="host", scoring_backend="cuda")
    sharded = base.replace(fleet=dataclasses.replace(
        base.fleet, num_shards=SHARD_SEARCH_N))
    run = host_ga_replayed(torch, sharded, dev)
    decisions = run["decisions"]
    per_call = SHARD_SEARCH_N * (run["generations"] + 1)
    if run["launches"] != per_call * decisions or \
            run["replay_launches"] != (run["generations"] + 1) * decisions:
        raise AssertionError(
            f"host GA: 2.1 launched {run['launches']} (+"
            f"{run['replay_launches']} in the replays) for {decisions} "
            "decisions")
    check_records(run["result"].records, base.effective_n_sel(),
                  base.effective_num_devices())
    t0 = time.perf_counter()
    single_run = base.run(device=str(dev))
    single_s = time.perf_counter() - t0
    a, b = single_run.records, run["result"].records
    first = next((i for i, (x, y) in enumerate(zip(a, b))
                  if list(x.device_ids) != list(y.device_ids)), None)
    return dict(card=smi, preset="fleet-scale", fused=fused, host_ga=dict(
        num_shards=SHARD_SEARCH_N, block=[
            run["population"], shard.shard_sizes(
                base.effective_num_devices(), SHARD_SEARCH_N)[0]],
        decisions=decisions, wall_s=run["wall_s"], single_lane_wall_s=single_s,
        launches=run["launches"], launches_per_decision=run["launches"]
        / decisions, launches_by_variant=run["by_variant"],
        replay_launches=run["replay_launches"], flips=run["flips"],
        score_pairs=run["score_pairs"],
        records_identical_to_single_lane=first is None,
        first_differing_record=first))


def phase_fleet_shard(torch, dev, smi: str) -> dict:
    """Phase 13: fleet sharding on the card (see the module docstring).
    Prints each part's line as it finishes."""
    from repro_torch.core import search

    t0 = time.perf_counter()
    search.fallbacks = 0
    dense = shard_dense(torch, dev, smi)
    emit(dict(phase="fleet-shard-dense", **dense))
    index = shard_index(torch, dev, smi)
    emit(dict(phase="fleet-shard-index", **index))
    searches, single = shard_searches(torch, dev, smi)
    emit(dict(phase="fleet-shard-search", **searches))
    spec = shard_spec(torch, dev, smi, single)
    emit(dict(phase="fleet-shard-spec", **spec))
    return dict(dense=dense, index=index, searches=searches, spec=spec,
                seconds=time.perf_counter() - t0)


# ---- phase 14 ------------------------------------------------------------

TRAIN_BATCH = (2, 4096)        # (global batch, seq) of the full-width steps
TRAIN_MICROBATCHES = 2
TRAIN_STEPS = 3
TRAIN_LR = 3e-4
# Step 1 on the card against the same step with every kernel on its plain
# version (bf16 compute): the loss's and the grad norm's relative gaps and
# the cosine of the two parameter updates.
# Set from a first run of this phase (NVIDIA H100 80GB HBM3, 700 W): gaps
# of 1.4e-6 and 6.4e-4, a cosine of 0.9891. AdamW's first update is about
# lr times the sign of the gradient, so each entry whose sign the two bf16
# paths flip costs twice its share of the cosine: 0.989 is about 0.5% of
# the entries.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GNORM_RTOL = 5e-3
TRAIN_UPDATE_COS = 0.98
ELASTIC_STEPS = 20
ELASTIC_FAIL_AT = 7
ELASTIC_SAVE_EVERY = 5
GUARD_LOSS_RTOL = 1e-4         # dbrx (reduced, f32) under "ref": card vs CPU
TRAIN_TIMEOUT_S = 300          # the `python -m repro_torch.launch.train` run


TRAIN_RANGES = ("train/forward_backward", "train/clip", "train/optimizer")


def train_bucket(e) -> str:
    """The stage of a profiled CPU op that launched kernels, from its own
    and its parents' names; None where no stage range encloses it."""
    while e is not None:
        name = e.name
        if "_FlashBackward" in name:
            return "attention backward"
        if name in ("train/clip", "train/optimizer"):
            return "optimizer"
        if name in ("aten::logsumexp", "aten::gather") or \
                "LogsumexpBackward" in name or "GatherBackward" in name:
            return "cross-entropy"
        e = e.cpu_parent
    return None


def train_split(torch, fn) -> dict:
    """One call of ``fn`` (a train step) under torch.profiler: wall ms (the
    profiler's overhead included), the device's busy ms (the union of its
    kernel intervals) and device ms by stage: flash forward (forward and
    remat recompute), attention backward (the autograd of the plain
    version), cross-entropy (logsumexp and the label gather, forward and
    backward), optimizer (clip and update), matmul and other; by kernel
    class over every kernel; and the kernels the profiler linked to no CPU
    op. The idle share is the caller's, against an unprofiled step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_stage, by_class, by_name, linked = [], {}, {}, {}, {}
    for e in prof.events():
        if getattr(e, "is_user_annotation", False) or e.name in TRAIN_RANGES:
            continue  # a record_function range drawn on the card's timeline
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            ms = (e.time_range.end - e.time_range.start) / 1e3
            cls = kernel_class(e.name)
            by_class[cls] = by_class.get(cls, 0.0) + ms
            by_name[e.name] = by_name.get(e.name, 0.0) + ms
            continue
        for k in e.kernels:
            stage = train_bucket(e)
            if stage is None:
                cls = kernel_class(k.name)
                stage = {"flash_attention": "flash forward",
                         "matmul": "matmul"}.get(cls, "other")
            by_stage[stage] = by_stage.get(stage, 0.0) + k.duration / 1e3
            linked[k.name] = linked.get(k.name, 0.0) + k.duration / 1e3
    # device time the profiler linked to no CPU op, by kernel name
    unlinked = sorted(((n, t - linked.get(n, 0.0)) for n, t in by_name.items()),
                      key=lambda nt: -nt[1])[:8]
    busy_ms = busy_ms_of(spans)
    return dict(profiled_wall_ms=wall_ms, device_events=len(spans),
                device_busy_ms=busy_ms if spans else None,
                device_ms_by_stage={k: v for k, v in sorted(
                    by_stage.items(), key=lambda kv: -kv[1])},
                device_ms_by_class={k: v for k, v in sorted(
                    by_class.items(), key=lambda kv: -kv[1])},
                unlinked_ms_top={n[:80]: t for n, t in unlinked if t > 0})


def train_full_width(torch, dev, smi: str, host_params) -> dict:
    """(a): qwen3-1.7b whole (remat on) from phase 7's params, AdamW,
    TRAIN_STEPS steps on one synth_batch of TRAIN_BATCH in
    TRAIN_MICROBATCHES microbatches; step 1 first under the plain
    versions."""
    from repro_torch.config.base import (OptimizerConfig, ShapeConfig,
                                         TrainConfig)
    from repro_torch.config.registry import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step, synth_batch
    from repro_torch.models.transformer import lm_loss
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_arch("qwen3-1.7b"), remat=True)
    L = cfg.num_layers
    B, S = TRAIN_BATCH
    step, opt_init = make_train_step(cfg, TrainConfig(
        optimizer=OptimizerConfig(name="adamw", lr=TRAIN_LR),
        microbatches=TRAIN_MICROBATCHES))
    batch = synth_batch(cfg, ShapeConfig("train", S, B, "train"), seed=0,
                        device=dev)
    params = tree_map(lambda t: t.to(dev), host_params)
    torch.cuda.synchronize()

    # Step 1 with every kernel on its plain version: its update, on the host.
    ops.set_default_impl("ref")
    try:
        t0 = time.perf_counter()
        p_ref, o_ref, m_ref = step(params, opt_init(params), batch)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
    finally:
        ops.set_default_impl("cuda")
    ref_loss, ref_gnorm = float(m_ref["loss"]), float(m_ref["grad_norm"])
    u_ref = [(a - b).cpu() for a, b in zip(tree_leaves(p_ref),
                                           tree_leaves(params))]
    del p_ref, o_ref, m_ref
    torch.cuda.empty_cache()

    # The main path, flash's counts at 0 just before and read just after.
    opt_state = opt_init(params)
    fa.launches = 0
    fa.launches_by_variant = dict.fromkeys(fa.VARIANTS, 0)
    losses, gnorms, step_s, step_peak_gb = [], [], [], []
    p0 = params
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        step_s.append(time.perf_counter() - t0)
        step_peak_gb.append(torch.cuda.max_memory_allocated(dev) / 1e9)
        if i == 0:
            dot = nu = nr = 0.0
            for a, b, r in zip(tree_leaves(params), tree_leaves(p0), u_ref):
                u = a - b
                r = r.to(dev)
                dot += float(torch.sum(u * r, dtype=torch.float64))
                nu += float(torch.sum(u * u, dtype=torch.float64))
                nr += float(torch.sum(r * r, dtype=torch.float64))
            del p0, u, r
            cos = dot / max((nu * nr) ** 0.5, 1e-300)
    launches = fa.launches
    variants = dict(fa.launches_by_variant)
    peak_gb = max(step_peak_gb)
    del u_ref
    with torch.no_grad():  # the loss after the last update
        final_loss = float(lm_loss(cfg, params, batch))
    # Where a step's time goes (one more step under the profiler, after the
    # counted run).
    state = {"p": params, "o": opt_state}

    def one():
        state["p"], state["o"], _ = step(state["p"], state["o"], batch)

    split = train_split(torch, one)
    if split["device_busy_ms"] is not None:
        split["device_idle_share"] = 1.0 - split["device_busy_ms"] / (
            statistics.median(step_s) * 1e3)
    del state, params, opt_state, batch
    torch.cuda.empty_cache()
    expected = L * 2 * TRAIN_MICROBATCHES * TRAIN_STEPS
    loss_gap = abs(losses[0] - ref_loss) / abs(ref_loss)
    gnorm_gap = abs(gnorms[0] - ref_gnorm) / abs(ref_gnorm)
    faults = []
    if launches != expected or variants["wgmma"] != launches:
        faults.append(f"flash launched {launches} times in {TRAIN_STEPS} "
                      f"train steps ({variants}), expected {expected}, all "
                      "wgmma")
    if not all(math.isfinite(x) for x in losses + gnorms + [final_loss]):
        faults.append(f"non-finite loss or grad norm: {losses}, {gnorms}")
    if not final_loss < losses[0]:
        faults.append(f"the loss did not fall over {TRAIN_STEPS} steps on "
                      f"one batch: {losses} then {final_loss}")
    if not (loss_gap <= TRAIN_LOSS_RTOL and gnorm_gap <= TRAIN_GNORM_RTOL
            and cos >= TRAIN_UPDATE_COS):
        faults.append(f"step 1 against the plain versions: loss {losses[0]} "
                      f"vs {ref_loss}, grad norm {gnorms[0]} vs {ref_gnorm}, "
                      f"update cosine {cos}")
    tokens = B * S
    out = dict(
        arch=cfg.name, params=cfg.param_count(), batch=B, seq=S,
        microbatches=TRAIN_MICROBATCHES, remat=True, optimizer="adamw",
        lr=TRAIN_LR, losses=losses, final_loss=final_loss,
        grad_norms=gnorms, step_s=step_s,
        s_per_step=statistics.median(step_s),
        tokens_per_s=tokens / statistics.median(step_s),
        peak_memory_gb=peak_gb, step_peak_memory_gb=step_peak_gb,
        flash_launches=launches,
        flash_launches_per_step=launches / TRAIN_STEPS,
        flash_launches_by_variant=variants,
        vs_plain=dict(ref_step_s=ref_s, ref_loss=ref_loss,
                      ref_grad_norm=ref_gnorm, loss_rel_gap=loss_gap,
                      grad_norm_rel_gap=gnorm_gap, update_cosine=cos,
                      limits=dict(loss=TRAIN_LOSS_RTOL,
                                  grad_norm=TRAIN_GNORM_RTOL,
                                  cosine=TRAIN_UPDATE_COS)),
        profile=split, nvidia_smi=smi)
    if faults:  # print what was measured, then fail
        emit(dict(phase="lm-train (a) failed", **out))
        raise AssertionError("; ".join(faults))
    return out


def train_elastic(torch, dev, smi: str, tmp: Path) -> dict:
    """(b): run_elastic over TokenBatcher at qwen3-1.7b's reduced size on
    the card, ELASTIC_STEPS steps, with and without a failure at
    ELASTIC_FAIL_AT: the final states equal bit for bit. Then the training
    CLI at the same size, and one of its checkpoints restored and carried
    into the reference's layout (checked against the manifest)."""
    import importlib

    from repro_torch import convert
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.config.base import OptimizerConfig, TrainConfig
    from repro_torch.launch.elastic import (ElasticConfig, FailureInjector,
                                            run_elastic)
    from repro_torch.launch.serve import REDUCED_MODULES
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import TokenBatcher
    from repro_torch.models.transformer import lm_init
    from repro_torch.tree import tree_flatten_with_paths, tree_leaves
    import numpy as np

    cfg = importlib.import_module(REDUCED_MODULES["qwen3-1.7b"]).reduced()
    step, opt_init = make_train_step(cfg, TrainConfig(
        optimizer=OptimizerConfig(name="adamw", lr=TRAIN_LR)))

    def make_state():
        params = lm_init(cfg, seed=0, device=dev)
        return (params, opt_init(params))

    def step_fn(state, batch):
        p, o, m = step(*state, batch)
        return (p, o), m

    runs = {}
    for name, fail in (("clean", ()), ("failed", (ELASTIC_FAIL_AT,))):
        inj = FailureInjector(fail_at_steps=fail)
        losses = []
        t0 = time.perf_counter()
        out = run_elastic(
            make_state=make_state, step_fn=step_fn,
            batch_iter=TokenBatcher(cfg, 8, 128, device=dev),
            num_steps=ELASTIC_STEPS,
            config=ElasticConfig(save_every=ELASTIC_SAVE_EVERY,
                                 checkpoint_dir=str(tmp / name)),
            injector=inj, on_step=lambda i, m: losses.append(m["loss"]))
        runs[name] = dict(out=out, losses=losses, injected=inj.injected,
                          wall_s=time.perf_counter() - t0)
    a, b = runs["clean"]["out"], runs["failed"]["out"]
    if b["restarts"] != 1 or runs["failed"]["injected"] != [ELASTIC_FAIL_AT]:
        raise AssertionError(f"run_elastic: {b['restarts']} restarts, "
                             f"injected {runs['failed']['injected']}")
    same = all(torch.equal(x, y) for x, y in zip(tree_leaves(a["state"]),
                                                  tree_leaves(b["state"])))
    if not same:
        raise AssertionError("run_elastic after a failure at step "
                             f"{ELASTIC_FAIL_AT} ended in another state")
    # The CLI, on the card by default.
    ck = tmp / "cli"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-1.7b", "--reduced", "--steps", str(ELASTIC_STEPS),
         "--ckpt-dir", str(ck)], cwd=ROOT, capture_output=True, text=True,
        timeout=TRAIN_TIMEOUT_S, env=dict(os.environ, PYTHONPATH=str(SRC)))
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"python -m repro_torch.launch.train exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    # Its last checkpoint, restored and carried into the reference's layout.
    step_no, (params, opt), _ = load_checkpoint(str(ck), make_state())
    ref_tree = (convert.lm_params_to_reference(params),
                convert.lm_opt_state_to_reference(opt))
    manifest = json.loads((ck / f"step_{step_no:010d}" /
                           "manifest.json").read_text())
    flat = tree_flatten_with_paths(ref_tree)
    layout_ok = ([k for k, _ in flat] == manifest["keys"]
                 and [list(np.shape(v)) for _, v in flat]
                 == manifest["shapes"]
                 and [np.asarray(v).dtype.name for _, v in flat]
                 == manifest["dtypes"]
                 and all(isinstance(v, np.ndarray) for _, v in flat))
    if step_no != ELASTIC_STEPS or not layout_ok:
        raise AssertionError(f"the CLI's checkpoint (step {step_no}) does "
                             "not carry into the reference's layout")
    return dict(arch=cfg.name, steps=ELASTIC_STEPS,
                fail_at=ELASTIC_FAIL_AT, save_every=ELASTIC_SAVE_EVERY,
                clean_wall_s=runs["clean"]["wall_s"],
                failed_wall_s=runs["failed"]["wall_s"],
                restarts=b["restarts"], steps_replayed=b["steps_replayed"],
                final_state_equal=same,
                first_loss=runs["clean"]["losses"][0],
                last_loss=runs["clean"]["losses"][-1],
                cli_s=cli_s, cli_tail=proc.stdout.strip().splitlines()[-1],
                checkpoint_leaves=len(flat), reference_layout=layout_ok,
                nvidia_smi=smi)


def train_guard(torch, dev, smi: str) -> dict:
    """(c): dbrx-132b's and hymba-1.5b's reduced train step on the card
    raises the kernels' NoKernelGradError under ``cuda``; under ``ref``
    dbrx's (f32) trains, its loss and grad norm within GUARD_LOSS_RTOL of
    the same step on the CPU."""
    import importlib

    from repro_torch.config.base import (OptimizerConfig, ShapeConfig,
                                         TrainConfig)
    from repro_torch.kernels import NoKernelGradError, ops
    from repro_torch.launch.serve import REDUCED_MODULES
    from repro_torch.launch.steps import make_train_step, synth_batch
    from repro_torch.models.transformer import lm_init

    tc = TrainConfig(optimizer=OptimizerConfig(name="adamw", lr=TRAIN_LR),
                     microbatches=2)
    shape = ShapeConfig("train", 64, 4, "train")
    raised = {}
    for arch in ("dbrx-132b", "hymba-1.5b"):
        cfg = dataclasses.replace(importlib.import_module(
            REDUCED_MODULES[arch]).reduced(), dtype="float32")
        step, opt_init = make_train_step(cfg, tc)
        params = lm_init(cfg, seed=0, device=dev)
        try:
            step(params, opt_init(params), synth_batch(cfg, shape,
                                                       device=dev))
        except NoKernelGradError as e:
            raised[arch] = str(e)
        else:
            raise AssertionError(f"{arch}: a train step through kernels "
                                 "without a backward pass did not raise")
    # dbrx (the last cfg is hymba's)
    cfg = dataclasses.replace(importlib.import_module(
        REDUCED_MODULES["dbrx-132b"]).reduced(), dtype="float32")
    step, opt_init = make_train_step(cfg, tc)
    out = {}
    for where in ("cuda", "cpu"):
        params = lm_init(cfg, seed=0, device=where)
        batch = synth_batch(cfg, shape, device=where)
        ops.set_default_impl("ref")
        try:
            _, _, m = step(params, opt_init(params), batch)
        finally:
            ops.set_default_impl("cuda")
        out[where] = {k: float(v) for k, v in m.items()}
    gaps = {k: abs(out["cuda"][k] - out["cpu"][k]) / abs(out["cpu"][k])
            for k in ("loss", "grad_norm")}
    if not all(g <= GUARD_LOSS_RTOL for g in gaps.values()):
        raise AssertionError(f"dbrx under impl='ref': card {out['cuda']} "
                             f"vs CPU {out['cpu']}")
    return dict(raised={k: v[:120] for k, v in raised.items()},
                ref_card=out["cuda"], ref_cpu=out["cpu"], rel_gaps=gaps,
                rtol=GUARD_LOSS_RTOL, nvidia_smi=smi)


def phase_lm_train(torch, dev, smi: str, host_params) -> dict:
    import tempfile

    full = train_full_width(torch, dev, smi, host_params)
    emit(dict(phase="lm-train (a)", **{k: v for k, v in full.items()}))
    with tempfile.TemporaryDirectory(prefix="lm_train_") as tmp:
        elastic = train_elastic(torch, dev, smi, Path(tmp))
    emit(dict(phase="lm-train (b)", **elastic))
    guard = train_guard(torch, dev, smi)
    emit(dict(phase="lm-train (c)", **guard))
    return dict(full=full, elastic=elastic, guard=guard)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every phase's details here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {SRC}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    device = dict(phase="device", nvidia_smi=smi,
                  name=torch.cuda.get_device_name(0),
                  count=torch.cuda.device_count(), torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=build_s,
                  libraries=[p.name for p in libs.values()],
                  build_seconds={n: log["seconds"]
                                 for n, log in build.build_log.items()},
                  ptxas={n: ptxas_report(log["ptxas"])
                         for n, log in build.build_log.items()})
    emit(device)

    kern = phase_kernels(torch, dev)
    emit(dict(phase="kernels-2.1", **kern))
    main_path = phase_main(torch)
    emit(dict(phase="main", **main_path))
    fl_kern = phase_fl_kernels(torch, dev)
    emit(dict(phase="fl-kernels", **fl_kern))
    fl_main = phase_fl_main(torch)
    emit(dict(phase="fl-main", **fl_main))
    lm_kern = phase_lm_kernels(torch, dev)
    emit(dict(phase="lm-kernels", **lm_kern))
    keep = {}
    lm_serve = phase_lm_serve(torch, dev, keep)
    emit(dict(phase="lm-serve", **lm_serve))
    lm_kern2 = phase_lm_kernels_2(torch, dev)
    emit(dict(phase="lm-kernels-2", **lm_kern2))
    lm_serve2 = phase_lm_serve_2(torch, dev)
    emit(dict(phase="lm-serve-2", **lm_serve2))
    scheds = phase_schedulers(torch, dev,
                              main_path["wall_s"] / main_path["decisions"])
    emit(dict(phase="schedulers", **scheds))
    service = phase_service(torch)
    emit(dict(phase="service", **service))
    kill9 = chaos_arms(torch)
    emit(dict(phase="service-kill9", **kill9))
    gym = phase_gym(torch)
    emit(dict(phase="gym", **gym))
    fleet_shard = phase_fleet_shard(torch, dev, smi)
    lm_train = phase_lm_train(torch, dev, smi, keep.pop("qwen3_params"))
    at = next(r for r in kern["plan_stats"]
              if r["label"] == "genetic-fleet-scale")
    fc = next(r for r in fl_kern["scatter_add"]
              if r["label"] == "vgg16-fc r=0.01")
    bods_fleet = scheds["fleet_bods"]
    paper_bods = [r for r in scheds["paper"] if r["scheduler"] == "bods"]
    by_path = {"main (host genetic)": main_path["launches"],
               "schedulers fleet-scale (fused bods)": bods_fleet["launches"],
               **{f"schedulers {r['preset']} (fused bods)":
                  r["plan_stats_launches"] for r in paper_bods},
               **{f"service online-smoke ({path})": n
                  for path, n in service["launches_by_path"].items()},
               "gym quickstart warm-started (fused bods)":
                   gym["warm_bods"]["launches"],
               "gym rlds-warmstart": gym["warm_rlds"]["plan_stats_launches"],
               "fleet-shard dense scoring K=262,144 (13a)":
                   fleet_shard["dense"]["launches"],
               f"fleet-shard fused bods N={SHARD_SEARCH_N} (13c)":
                   fleet_shard["searches"]["bods"]["launches_n4"],
               "fleet-shard fused bods N=1 (13c)":
                   fleet_shard["searches"]["bods"]["launches_n1"],
               f"fleet-shard host genetic N={SHARD_SEARCH_N} (13d)":
                   fleet_shard["spec"]["host_ga"]["launches"],
               "fleet-shard host genetic replays N=1 (13d)":
                   fleet_shard["spec"]["host_ga"]["replay_launches"]}
    gym_bods = gym["warm_bods"]
    shard_rows = [fleet_shard["dense"]["kernel"],
                  fleet_shard["searches"]["bods"]["kernel"]]
    kernels = [dict(
        name="plan_stats", route="cuda",
        source="src/repro_torch/kernels/csrc/sched_score.cu",
        replaces="src/repro/kernels/sched_score.py:39",
        launches=sum(by_path.values()), launches_by_path=by_path,
        bods_block=bods_fleet["kernel"],
        paper_bods_blocks={f"{r['preset']}/bods": r["kernel"]
                           for r in paper_bods},
        service_blocks={"bods": service["bods_block"],
                        "rescore": service["rescore_block"]},
        gym_bods_block=gym_bods["kernel"],
        fleet_shard_blocks={"dense last block (13a)": shard_rows[0],
                            "fused bods block (13c)": shard_rows[1]},
        max_abs_err=max([r["max_abs_err"] for r in kern["plan_stats"]]
                        + [r["kernel"]["max_abs_err"]
                           for r in [bods_fleet, gym_bods] + paper_bods]
                        + [service["bods_block"]["max_abs_err"],
                           service["rescore_block"]["max_abs_err"]]
                        + [r["max_abs_err"] for r in shard_rows]),
        ms=at["kernel_ms"], plain_ms=at["plain_ms"], h2d_ms=at["h2d_ms"],
        bound_ms=at["bound_ms"], bound_by=at["bound_by"], library_ms=None,
        launches_by_variant={
            v: n + sum(r["launches_by_variant"].get(v, 0)
                       for r in [bods_fleet, service, gym_bods] + paper_bods)
            + sum(d.get(v, 0) for d in (
                fleet_shard["dense"]["launches_by_variant"],
                fleet_shard["searches"]["bods"]["launches_by_variant_n1"],
                fleet_shard["searches"]["bods"]["launches_by_variant_n4"],
                fleet_shard["spec"]["host_ga"]["launches_by_variant"]))
            for v, n in main_path["launches_by_variant"].items()},
        floor_ms=kern["floor_ms"], shapes=kern["plan_stats"],
        **variant_keys(at)), dict(
        name="scatter_add", route="cuda",
        source="src/repro_torch/kernels/csrc/scatter_add.cu",
        replaces="src/repro/kernels/scatter_add.py:35",
        launches=fl_main["compressed"]["launches"],
        max_abs_err=max(r["max_abs_err"] for r in fl_kern["scatter_add"]),
        ms=fc["kernel_ms"], plain_ms=fc["plain_ms"],
        bound_ms=fc["bound_ms"], bound_by=fc["bound_by"],
        library_ms=fc["library_ms"],
        launches_by_variant=fl_main["compressed"]["launches_by_variant"],
        crowded={k: v for k, v in fl_kern["crowded"].items()
                 if not k.endswith("_gaps")},
        shapes=fl_kern["scatter_add"], **variant_keys(fc))]
    flash_by_path = {
        "lm-serve qwen3-1.7b prefill (7)": lm_serve["prefill"]["flash_launches"],
        f"lm-train qwen3-1.7b {TRAIN_STEPS} steps, forward and remat "
        "recompute (14a)": lm_train["full"]["flash_launches"]}
    for name, cu, line, label, by_path in (
            ("flash_attention", "flash_attention.cu", "flash_attention.py:35",
             "qwen3-1.7b prefill", flash_by_path),
            ("decode_attention", "decode_attention.cu",
             "decode_attention.py:22", "qwen3-1.7b 16 slots",
             {"lm-serve qwen3-1.7b serve loop (7)":
              lm_serve["serve"]["decode_launches"]})):
        rows = lm_kern[name]
        at = next(r for r in rows
                  if r["label"] == label and r["dtype"] == "bfloat16")
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{cu}",
            replaces=f"src/repro/kernels/{line}",
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=at["kernel_ms"], plain_ms=at["plain_ms"],
            bound_ms=at["bound_ms"], bound_by=at["bound_by"],
            library_ms=at["library_ms"], shapes=rows, **variant_keys(at)))
    scan_launches = sum(lm_serve2[m]["serve"]["launches"]["linear_scan"]
                        for m in ("hymba", "xlstm"))
    for name, cu, line, label, launches in (
            ("moe_gmm", "moe_gmm.cu", "moe_gmm.py:20",
             "dbrx prefill (2 x 4096), gate/up",
             lm_serve2["dbrx"]["serve"]["launches"]["moe_gmm"]),
            ("linear_scan", "linear_scan.cu", "ssm_scan.py:31",
             "hymba prefill (2, 4096), 25 heads, 16 x 128", scan_launches),
            ("rmsnorm", "rmsnorm.cu", "rmsnorm.py:17", "(8192, 6144)", 0)):
        rows = lm_kern2[name]
        at = next(r for r in rows
                  if r["label"] == label and r["dtype"] == "bfloat16")
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{cu}",
            replaces=f"src/repro/kernels/{line}", launches=launches,
            on_main_path=name != "rmsnorm",  # no model calls rmsnorm
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=at["kernel_ms"], plain_ms=at["plain_ms"],
            bound_ms=at["bound_ms"], bound_by=at["bound_by"],
            library_ms=at["library_ms"], shapes=rows, **variant_keys(at)))
    emit(dict(phase="kernels", kernels=kernels))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(device=device, kernels=kernels, main=main_path,
                 fl_main=fl_main, lm_kernels=lm_kern, lm_serve=lm_serve,
                 lm_kernels_2=lm_kern2, lm_serve_2=lm_serve2,
                 schedulers=scheds, service=service,
                 service_kill9=kill9, gym=gym, fleet_shard=fleet_shard,
                 lm_train=lm_train),
            indent=1, default=str))
    print(json.dumps({"kernels": [{k: v for k, v in kr.items()
                                   if k != "shapes"} for kr in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
