"""Hand-written Hopper kernels (``csrc/``), their plain PyTorch versions
(``ref.py``) and the dispatching wrappers (``ops.py``)."""
