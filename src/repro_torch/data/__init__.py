"""Synthetic datasets of the port (see ``synthetic``)."""
