"""Small helpers shared by the port's modules (the part of avtex/utils/
that the port needs): the chunking helpers and Farneback flow features
(``avtex_torch.utils.flow``, OpenCV imported at use)."""

from .batching import (batched_apply, combine_batches, split_into_batches,
                       split_into_overlapping_segments)

__all__ = ["batched_apply", "combine_batches", "split_into_batches",
           "split_into_overlapping_segments"]
