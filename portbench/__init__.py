"""The port's benchmark: the paper's multi-job real-FL loop on one card,
and (the ``lm_train`` kind of configuration) the port's LM training step.

``run.py`` is the entry; ``BENCHMARK.json`` at the checkout's root names the
cells, and each cell's configuration, traffic mix, limits and per-layer
metric readers are files of their own under this directory.
"""
