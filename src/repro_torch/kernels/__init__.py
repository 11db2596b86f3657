"""Hand-written CUDA kernels of the port (``csrc/``), their wrappers and
plain PyTorch versions, and the ``ops`` dispatch."""
