"""Fault-tolerant training runtime."""
from . import driver
from .driver import RunConfig, SimulatedFailure, TrainDriver, run_with_restarts

__all__ = ["driver", "RunConfig", "SimulatedFailure", "TrainDriver",
           "run_with_restarts"]
