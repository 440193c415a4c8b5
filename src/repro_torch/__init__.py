"""PyTorch/CUDA port of the OSCAR reproduction, for one NVIDIA H100.

A package of its own beside the JAX reference (``src/repro``): it imports
``torch`` and numpy, never ``jax`` and nothing of the JAX package.  Entry
points run on the CUDA card unless the caller passes ``device="cpu"``.
"""
