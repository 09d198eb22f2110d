"""PyTorch/CUDA port of the model-aware routing plane (``repro``'s twin).

Subpackages mirror ``src/repro/`` module for module; the JAX package
stays the reference the port is tested against.
"""
