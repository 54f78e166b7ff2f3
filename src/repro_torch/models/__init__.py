"""Quantization-aware dense transformer (PyTorch)."""
from .config import ModelConfig
from .transformer import forward, init_cache, init_model

__all__ = ["ModelConfig", "forward", "init_cache", "init_model"]
