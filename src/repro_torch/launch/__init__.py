"""Step builders of the LLM zoo (``steps``: train, prefill, decode), the
continuous-batching decode loop (``serve``), the training driver and its
elastic runtime (``train``, ``elastic``), and the fleet-sharding bootstrap
(``bootstrap``)."""
