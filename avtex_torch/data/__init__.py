"""Device-side preprocessing."""

from .preprocess import preprocess_clip

__all__ = ["preprocess_clip"]
