"""Micro-benchmarks of the port's Hopper kernels."""
