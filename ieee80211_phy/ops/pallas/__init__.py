"""Pallas kernels (Triton route, NVIDIA GPUs) for the hot PHY loops."""
