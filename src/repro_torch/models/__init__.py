"""Model stack of the PyTorch port: params, layers, attention, LM, registry."""
