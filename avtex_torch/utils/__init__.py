"""Small helpers shared by the port's modules (the part of avtex/utils/
that the port needs)."""

from .batching import batched_apply

__all__ = ["batched_apply"]
