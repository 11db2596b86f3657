"""Serving steps and the continuous-batching decode loop of the LLM zoo
(``steps``, ``serve``), and the fleet-sharding bootstrap (``bootstrap``)."""
