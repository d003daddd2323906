"""The benchmark's plain float32 references and the weights it makes.

``weights.make`` draws a model's parameters from the run's seed, on the
device, in the tree the port's models take; the program and the
reference are handed the same tensors. Each block family's reference is
in ``families/<name>.py``; ``models`` holds what they share and runs
them in plain PyTorch, float32, with TF32 off. Nothing here imports
JAX, the JAX package or the port.
"""
