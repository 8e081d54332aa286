"""Tensor ops of the port: plain PyTorch, plus the K1/K2 kernel wrappers."""
