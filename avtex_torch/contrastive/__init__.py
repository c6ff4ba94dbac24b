"""Contrastive model, InfoNCE and segment geometry."""

from .infonce import cosine_logits, info_nce_from_logits, info_nce_loss
from .model import ContrastiveTextures, SegmentEmbedder
from .segments import (gather_windows, hard_negative_ids, num_segments,
                       require_segments, sample_negatives,
                       segment_frame_ids, segment_start_frames,
                       target_ordering)

__all__ = ["ContrastiveTextures", "SegmentEmbedder", "cosine_logits",
           "gather_windows", "hard_negative_ids", "info_nce_from_logits",
           "info_nce_loss", "num_segments", "require_segments",
           "sample_negatives", "segment_frame_ids", "segment_start_frames",
           "target_ordering"]
