"""Deterministic synthetic data pipeline."""
from . import pipeline
from .pipeline import DataConfig, SyntheticPipeline, frontend_stub

__all__ = ["pipeline", "DataConfig", "SyntheticPipeline", "frontend_stub"]
