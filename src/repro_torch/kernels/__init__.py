"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``), each with a
plain PyTorch version beside it, reached through ``kernels/dispatch.py``."""
