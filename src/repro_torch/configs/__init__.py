"""Assigned-architecture configs (+ the paper's own tensor-algebra ops).

PyTorch port: a copy of the reference's jax-free ``configs`` package.
"""
from .base import (SERVE_MIXES, SHAPES, InputShape, ModelConfig, ServeMix,
                   cells_for)
from .registry import ARCH_IDS, all_configs, get_config

__all__ = ["SERVE_MIXES", "SHAPES", "InputShape", "ModelConfig", "ServeMix",
           "cells_for", "ARCH_IDS", "all_configs", "get_config"]
