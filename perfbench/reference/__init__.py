"""The plain reference the benchmark holds the port against.

Plain PyTorch, in its own files: it imports nothing of the port (or of
JAX) and takes nothing the port made. The feature order, the window
starts and sizes, the atom orders, the shuffles and the step weights
are worked out again from the seed, the sampler's draws through a
frozen copy of its code (:mod:`.sampler`).
"""
