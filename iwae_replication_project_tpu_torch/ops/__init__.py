"""Numerics and the hot-loop dispatcher with its CUDA kernel."""
