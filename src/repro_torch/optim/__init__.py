"""Optimiser of the PyTorch port."""
