"""Texture synthesis: embed-once tables, the host walk, stitching, serving.

- ``embeddings.py``: every segment through both towers once -> [L, D]
  query and target tables on the device.
- ``engine.py``: the ``[L, L]`` logits and the reference's per-step walk,
  on the host or on the device.
- ``stitcher.py``: frame/audio assembly, crossfade at jumps;
  ``interp.py``: SuperSloMo as the stitcher's ``interp_fn``.
- ``pipeline.py`` / ``server.py``: one-shot and warm-serving entry points.
- ``cam.py``: the per-segment class-activation maps and their overlays
  (``-vcam``).
"""

from .cam import cam_step_frames, segment_cams
from .embeddings import (embed_segments, embed_segments_from_video,
                         precompute_embeddings,
                         precompute_embeddings_from_video)
from .engine import (SynthesisResult, num_synthesis_steps, seed_segment,
                     synthesize_indices, synthesize_indices_host)
from .pipeline import synthesize, synthesize_frames
from .server import TextureServer
from .stitcher import stitch_texture, walk_frame_ids

__all__ = ["cam_step_frames", "segment_cams", "embed_segments",
           "precompute_embeddings", "embed_segments_from_video",
           "precompute_embeddings_from_video", "SynthesisResult", "num_synthesis_steps", "seed_segment",
           "synthesize_indices", "synthesize_indices_host", "synthesize", "synthesize_frames",
           "TextureServer", "stitch_texture", "walk_frame_ids"]
