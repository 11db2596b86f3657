"""Step builders of the LLM zoo (``steps``: train, prefill, decode), the
continuous-batching decode loop (``serve``), the training driver and its
elastic runtime (``train``, ``elastic``), the fleet-sharding bootstrap
(``bootstrap``), and meshes, logical-axis sharding, the roofline and the
dry run (``mesh``, ``sharding``, ``roofline``, ``dryrun``)."""
