"""Optimizers (``optimizers``) and gradient compression (``compression``)
of the port."""
