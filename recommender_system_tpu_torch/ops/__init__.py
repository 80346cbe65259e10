"""Ops: plain PyTorch versions, CUDA kernels and the rule between them."""
