"""Training state, step and loop of the PyTorch port."""
