"""Serving: accelerator serving on the port's front door.

* ``engine`` — ``AcceleratorEngine`` (STT front door as a service).

The LM serving stack (decode, slots, pages, server) arrives with the
models and serving slices.
"""
from . import engine
from .engine import AcceleratorEngine

__all__ = ["engine", "AcceleratorEngine"]
