"""Observability: the TensorBoard logger."""

from .logger import Logger

__all__ = ["Logger"]
