"""dynamo_tpu_torch — the PyTorch/CUDA port of dynamo_tpu for NVIDIA Hopper.

A package beside ``dynamo_tpu`` (the JAX reference) with the same module
layout: models/, ops/ (CUDA kernels in csrc/), engine/, protocols/,
runtime/, llm/, http/, launch/. It imports torch, never jax, and nothing
of ``dynamo_tpu``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; importing the package builds and loads nothing.
"""
