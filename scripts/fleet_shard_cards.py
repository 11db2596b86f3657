#!/usr/bin/env python3
"""Fleet sharding across the cards of one host: the ``shard_map`` executor
(one block of the fleet axis per card) against ``emulate`` (the blocks in
turn on one card) and against the single lane.

    python3 scripts/fleet_shard_cards.py [--out FILE]

Needs at least two CUDA cards and ``nvcc``; N is the card count. Checks,
failing on any miss:

- dense scoring at bench_fleet's K = 262,144, P = 4096 (``chip_smoke``'s
  phase 13 plans): ``plan_stats_sharded`` under ``shard_map`` equal to
  ``emulate`` bit for bit, on the ``cuda`` (kernel 2.1 once per block)
  and ``torch`` backends; the first call on the other cards pays their
  first-use costs, so each executor is called twice and both times kept;
- index draws at K = 1e6, P = 4096, n_sel = 10,000: the same rows under
  both executors (each block's generator is seeded by (seed, shard id));
- ``fleet-scale`` through the spec at ``fleet.num_shards`` = N: the fused
  SA, GA and BODS split over the cards (no fallback), records equal to
  the single lane's, 2.1 once per block per BODS decision; the host GA
  (``scoring_backend="cuda"``) with the blocks on the cards, records equal
  to the same spec run under ``emulate`` on one card.

Prints one JSON line per part and the card's name and power limit last.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def spec_run(torch, ss, search, sched, n, **kw):
    """fleet-scale's ``sched`` at ``fleet.num_shards=n`` on the cards: the
    records, wall seconds, 2.1 launches and fallbacks of the run."""
    from repro_torch.experiment.presets import get_preset

    spec = get_preset("fleet-scale", scheduler=sched, **kw)
    spec = spec.replace(fleet=dataclasses.replace(spec.fleet, num_shards=n))
    launches, fallbacks = ss.launches, search.fallbacks
    result, wall = timed(torch, lambda: spec.run(device="cuda"))
    return dict(records=result.records, wall_s=wall,
                launches=ss.launches - launches,
                fallbacks=search.fallbacks - fallbacks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    N = torch.cuda.device_count()
    if N < 2:
        print(f"fleet_shard_cards: needs 2 or more CUDA cards, found {N}",
              file=sys.stderr)
        return 2
    from repro_torch.core import search, shard
    from repro_torch.kernels import build
    from repro_torch.kernels import sched_score as ss

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    build.build_all()
    dev = torch.device("cuda")
    out = dict(cards=N)

    times, counts, plans = cs.shard_dense_inputs(torch, dev)
    counts_c = counts - counts.mean()
    dense = {}
    for backend in ("cuda", "torch"):
        stats = {}
        for ex in ("shard_map", "emulate", "shard_map", "emulate"):
            before = ss.launches
            st, wall = timed(torch, lambda: shard.plan_stats_sharded(
                times, counts_c, plans, "dense", N, executor=ex,
                backend=backend, device=dev))
            if backend == "cuda" and ss.launches - before != N:
                raise AssertionError(f"{ex}: {ss.launches - before} launches")
            if ex in stats and not np.array_equal(stats[ex], st):
                raise AssertionError(f"{ex} {backend}: calls differ")
            stats[ex] = st
            dense.setdefault(f"{backend} {ex} ms", []).append(wall * 1e3)
        if not np.array_equal(stats["shard_map"], stats["emulate"]):
            raise AssertionError(f"dense {backend}: executors differ")
    out["dense"] = dict(K=cs.SHARD_DENSE_K, P=cs.SHARD_DENSE_P,
                        executors_identical=True, **dense)
    cs.emit(dict(part="dense", card=smi, **out["dense"]))

    avail = np.random.default_rng(1701).random(cs.SHARD_INDEX_K) < 0.9
    draws, walls = {}, {}
    for ex in ("shard_map", "emulate"):
        draws[ex], walls[f"{ex} s"] = timed(
            torch, lambda: shard.random_plan_indices_sharded(
                np.random.default_rng(4), avail, cs.SHARD_INDEX_SEL,
                cs.SHARD_INDEX_P, N, executor=ex, device=dev))
    if not np.array_equal(np.sort(draws["shard_map"], 1),
                          np.sort(draws["emulate"], 1)):
        raise AssertionError("index draws differ between the executors")
    out["index"] = dict(K=cs.SHARD_INDEX_K, P=cs.SHARD_INDEX_P,
                        n_sel=cs.SHARD_INDEX_SEL, rows_identical=True,
                        **walls)
    cs.emit(dict(part="index", card=smi, **out["index"]))

    fused = {}
    for sched in ("sa", "genetic", "bods"):
        one = spec_run(torch, ss, search, sched, 1)
        many = spec_run(torch, ss, search, sched, N)
        if many["fallbacks"]:
            raise AssertionError(f"fused {sched}: fell back on {N} cards")
        if sched == "bods" and many["launches"] != N * one["launches"]:
            raise AssertionError(f"BODS: {many['launches']} launches, "
                                 f"{one['launches']} at one lane")
        fused[sched] = dict(
            wall_s_one_lane=one["wall_s"], wall_s_cards=many["wall_s"],
            launches_one_lane=one["launches"], launches_cards=many["launches"],
            max_est_cost_diff=cs.compare_runs(one["records"],
                                              many["records"]))
    host = dict(search_backend="host", scoring_backend="cuda")
    cards = spec_run(torch, ss, search, "genetic", N, **host)
    capacity = shard.shard_capacity
    shard.shard_capacity = lambda: 1        # auto -> emulate on one card
    try:
        one_card = spec_run(torch, ss, search, "genetic", N, **host)
    finally:
        shard.shard_capacity = capacity
    fused["host genetic"] = dict(
        wall_s_cards=cards["wall_s"], wall_s_emulate=one_card["wall_s"],
        launches_cards=cards["launches"],
        launches_emulate=one_card["launches"],
        max_est_cost_diff=cs.compare_runs(one_card["records"],
                                          cards["records"]))
    out["spec"] = fused
    cs.emit(dict(part="spec", card=smi, preset="fleet-scale",
                 num_shards=N, **fused))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
