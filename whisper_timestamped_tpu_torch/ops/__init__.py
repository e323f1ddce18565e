"""Kernels (``kernels``: CUDA for tensors on the card, plain PyTorch for
CPU tensors) and host-side numpy helpers (``dtw``, ``median``)."""
