"""The paper's CNN zoo in PyTorch (see ``cnn_zoo``)."""
