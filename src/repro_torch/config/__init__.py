"""Configuration dataclasses of the port (see ``base``)."""
