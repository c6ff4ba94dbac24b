"""Training batches, device-side preprocessing and train-time
augmentation."""

from .pipeline import SegmentBatches, prefetch
from .preprocess import (apply_augment, augment_and_preprocess,
                         draw_augment_params, lighting_jitter,
                         preprocess_clip, random_short_side_scale_jitter,
                         scale_uniform_crop_norm, uniform_crop)

__all__ = ["SegmentBatches", "apply_augment", "augment_and_preprocess",
           "draw_augment_params", "lighting_jitter", "prefetch",
           "preprocess_clip", "random_short_side_scale_jitter",
           "scale_uniform_crop_norm", "uniform_crop"]
