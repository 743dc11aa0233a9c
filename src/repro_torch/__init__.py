"""PyTorch/CUDA port of the ``repro`` model and serving stack.

Module paths and function names mirror ``repro`` so each counterpart is
easy to find.  The package imports ``torch`` and never ``jax`` or
``repro``: what it needs of the reference's jax-free modules (the
configs) it keeps as its own copy.  Entry points run on CUDA unless the
caller passes ``device="cpu"``.
"""
