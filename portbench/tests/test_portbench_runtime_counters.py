"""The runtime's own counters against the probe's reading of its flushes,
over a window of the tiny cell."""

from portbench import harness


def test_runtime_counters_match_the_probe(tiny_cell):
    prep = harness.prepare(tiny_cell, 2 ** 31 + 3, "cpu")
    harness.warm_up(prep, tiny_cell.traffic["check_rounds"])
    engine, probe = prep.engine, prep.probe
    before = engine.runtime.counters()
    probe.counting, probe.mark = True, lambda: 0.0
    target = sum(probe.trained) + 6
    harness.step_until(engine, lambda: sum(probe.trained) >= target)
    probe.counting = False
    after = engine.runtime.counters()
    count = probe.count
    assert count.rounds >= 6
    assert {k: after[k] - before[k] for k in after} == dict(
        flushes=len(count.flushes), rounds=count.rounds,
        samples=count.samples, sgd_steps=count.sgd_steps)
