"""The paper's CNN zoo (``cnn_zoo``) and the LLM zoo (``layers``,
``attention``, ``moe``, ``ssm``, ``transformer``) in PyTorch."""
