"""The plain BODS replay against the program's fused acquisition: the
same counter-based draws, the same candidate set, and the program's plan
at no regret."""

import numpy as np
import pytest
import torch

from portbench.reference import bods


def _ctx(K, n_sel, seed):
    rng = np.random.default_rng(seed)
    avail = rng.random(K) > 0.3
    counts = rng.integers(0, 4, K).astype(np.float64)
    times = rng.uniform(0.5, 3.0, K)
    return bods.Context(0, avail, counts, times, n_sel)


@pytest.mark.parametrize("stream,width", [(1, 2), (3, 40), (4, 1000)])
def test_hash_uniform_is_the_programs(stream, width):
    from repro_torch.core import search

    ids = torch.arange(300, dtype=torch.int64)
    mine = bods.hash_uniform(123456789, stream, ids.numpy(), width)
    theirs = search.hash_uniform(123456789, stream, ids, width).numpy()
    assert mine.dtype == np.float32
    assert np.array_equal(mine, theirs)


@pytest.mark.parametrize("K,n_sel,seed", [(40, 6, 1), (300, 30, 2),
                                          (1000, 100, 3)])
def test_candidates_are_the_programs(K, n_sel, seed):
    from repro_torch.core import search

    ctx = _ctx(K, n_sel, seed)
    rng = np.random.default_rng(seed)
    base = np.zeros(K, dtype=bool)
    base[np.flatnonzero(ctx.available)[:n_sel]] = True
    mutants = bods.mutate(rng, base, 32)
    mine = bods.candidates(77 + seed, ctx.times.astype(np.float32),
                           ctx.counts, ctx.available, mutants, n_sel, 256)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    theirs = search.bods_candidates(
        77 + seed, 0, 256, f32(ctx.times), f32(search._center(ctx.counts)),
        torch.as_tensor(ctx.available), torch.as_tensor(mutants), 256,
        n_sel, True).numpy()
    assert np.array_equal(mine, theirs)
    assert (mine.sum(1) == n_sel).all() and not (mine & ~ctx.available).any()


def test_mutations_draw_as_the_programs():
    from repro_torch.core import search

    base = np.zeros(50, dtype=bool)
    base[::5] = True
    a = bods.mutate(np.random.default_rng(4), base, 32)
    b = search._mutate_plan_host(np.random.default_rng(4), base, 32)
    assert np.array_equal(a, b)


def test_a_plan_outside_the_search_reads_regret():
    """Two replays in step, one choosing and one judging: BODS's own
    choices read no regret, the first free devices most of the best EI."""
    ctx = _ctx(120, 12, 5)
    args = (1, 120, np.linspace(1.0, 9.0, 120), 11, 4.0, 0.25, 2.0, 0.09)
    first = np.zeros(120, dtype=bool)
    first[np.flatnonzero(ctx.available)[:12]] = True
    worst = {}
    for name in ("bods", "first_free"):
        pick, judge = bods.Replay(*args), bods.Replay(*args)
        readings = []
        for r in range(6):
            plan = pick.choose(ctx)
            plan = first if name == "first_free" else plan
            readings.append(judge.regret(ctx, plan))
            for replay in (pick, judge):
                replay.observe(ctx, plan, 1.0 + 0.1 * r)
        worst[name] = max(readings)
    assert worst["bods"] < 1e-12, worst
    assert worst["first_free"] > 0.1, worst
