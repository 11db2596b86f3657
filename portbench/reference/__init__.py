"""Plain references: NumPy and PyTorch, no program code.

The real-FL loop: frozen copies of the data generator and the non-IID
partitioner (``data``), the device pool's time model and Formula 2
(``pool``), BODS (``bods``), and an im2col CNN trained by SGD over a
stacked cohort with FedAvg (``cnn``). LM training (``lm_train`` cells):
the clipped AdamW step (``lm_train``) and one file an architecture family,
named by the configuration's ``reference`` (``lm_dense``: the dense
decoder). Nothing here imports ``repro_torch``, ``repro`` or ``jax``.
"""
