"""Atomic, async checkpointing."""
from . import store
from .store import AsyncCheckpointer, latest_step, restore, save

__all__ = ["store", "AsyncCheckpointer", "latest_step", "restore", "save"]
