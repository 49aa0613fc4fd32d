"""Attention, KV-cache and sampling ops: hand-written CUDA kernels for the
card (csrc/) with their plain PyTorch versions for the CPU."""
