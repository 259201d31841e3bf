"""Optimizers (AdamW + 8-bit state)."""
from . import adamw
from .adamw import AdamWConfig, OptState

__all__ = ["adamw", "AdamWConfig", "OptState"]
