"""Data pipeline of the PyTorch port."""
