"""Plain reference of the real-FL loop: NumPy and PyTorch, no program code.

Frozen copies of the data generator and the non-IID partitioner
(``data``), the device pool's time model and Formula 2 (``pool``), and an
im2col CNN trained by SGD over a stacked cohort with FedAvg (``cnn``).
Nothing here imports ``repro_torch``, ``repro`` or ``jax``.
"""
