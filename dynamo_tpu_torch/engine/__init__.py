"""The PyTorch engine (``TorchEngine``) and its block allocator."""

from .allocator import BlockAllocator
from .engine import EngineConfig, TorchEngine

__all__ = ["BlockAllocator", "EngineConfig", "TorchEngine"]
