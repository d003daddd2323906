"""Hand-written Hopper kernels (CUDA C++, ``csrc/``), their ctypes
wrappers, their plain PyTorch versions (``ref``) and device dispatch
(``ops``)."""
