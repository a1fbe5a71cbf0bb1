"""Fault-tolerant training runtime (counterpart of ``repro/runtime``)."""
from .loop import TrainLoopConfig, train_loop

__all__ = ["TrainLoopConfig", "train_loop"]
