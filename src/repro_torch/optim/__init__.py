"""Gradient compression of the port (see ``compression``)."""
