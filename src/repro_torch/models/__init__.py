"""The paper's CNN zoo (``cnn_zoo``) and the dense LLM zoo (``layers``,
``attention``, ``transformer``) in PyTorch."""
