"""PyTorch/CUDA port of the DeepRT reproduction (``repro`` is the JAX
reference). Imports ``torch``, never ``jax``, and nothing of ``repro``."""
