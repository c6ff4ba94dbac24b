"""Contrastive model, InfoNCE and segment geometry, the VideoForAudio
retrieval head (its trainer: ``avtex_torch.contrastive.retrieval_train``),
AudioVisualFeatures and ClassicTemporal."""

from .audio_retrieval import VideoForAudio, video_for_audio_logits
from .av_features import AudioTower1D, AudioVisualFeatures, VideoTower3D
from .classic_temporal import ClassicTemporal, classic_temporal_distances
from .infonce import cosine_logits, info_nce_from_logits, info_nce_loss
from .model import AudioMLP, ContrastiveTextures, SegmentEmbedder
from .segments import (gather_windows, hard_negative_ids, num_segments,
                       require_segments, sample_negatives,
                       segment_frame_ids, segment_start_frames,
                       target_ordering)

__all__ = ["AudioMLP", "AudioTower1D", "AudioVisualFeatures",
           "ClassicTemporal", "ContrastiveTextures", "SegmentEmbedder",
           "VideoForAudio", "VideoTower3D", "classic_temporal_distances",
           "cosine_logits", "gather_windows", "hard_negative_ids",
           "info_nce_from_logits", "info_nce_loss", "num_segments",
           "require_segments", "sample_negatives", "segment_frame_ids",
           "segment_start_frames", "target_ordering",
           "video_for_audio_logits"]
