"""PyTorch/CUDA port of the multi-job FL device-scheduling system.

A second package beside the JAX reference ``repro``: the same module names,
the same ``ExperimentSpec`` front door, and bit-identical engine records on
the numpy-driven paths. It imports ``torch`` and ``numpy``, never ``jax``
and nothing of ``repro``. Entry points run on the CUDA card unless the
caller passes ``device="cpu"``.
"""
