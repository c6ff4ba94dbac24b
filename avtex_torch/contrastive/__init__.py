"""Contrastive model and segment geometry."""

from .model import ContrastiveTextures, SegmentEmbedder
from .segments import gather_windows, num_segments, require_segments

__all__ = ["ContrastiveTextures", "SegmentEmbedder", "gather_windows",
           "num_segments", "require_segments"]
