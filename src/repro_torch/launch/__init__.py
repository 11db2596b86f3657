"""Serving steps and the continuous-batching decode loop of the LLM zoo
(``steps``, ``serve``)."""
