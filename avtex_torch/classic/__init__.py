"""The classic Schödl video-textures baseline (the port of avtex/classic/).

Ported: RGB, ResNet and ResNet_VGGish features, D1 (the ``pairwise_l2``
kernel), D2, the value iteration, the one-call chain, the device and host
walks (modes 1-3), the interpolated track, ``run_classic`` /
``run_classic_frames`` and ``compute_paudio``. Not yet: the sharded chain
(ROADMAP.md Queue 1).
"""

from .d1 import compute_d1, distance_to_transition_probs, pairwise_l2
from .d2 import binomial_coeffs, compute_d2, diagonal_filter_smooth
from .driver import run_classic, run_classic_frames
from .features import (frame_features, resnet_features,
                       resnet_vggish_features, rgb_features)
from .future_cost import anticipated_future_cost, compute_d3, threshold_rows
from .fused import classic_transition_matrix
from .interp_track import burn_position_bars, classic_interp_track
from .paudio import compute_paudio
from . import sampler
from .sampler import (expand_walk_to_frames, sample_texture_walk,
                      sample_texture_walk_host)

__all__ = ["pairwise_l2", "distance_to_transition_probs", "compute_d1",
           "binomial_coeffs", "diagonal_filter_smooth", "compute_d2",
           "anticipated_future_cost", "threshold_rows", "compute_d3",
           "classic_transition_matrix", "rgb_features", "resnet_features",
           "resnet_vggish_features", "frame_features", "compute_paudio",
           "sampler", "sample_texture_walk", "sample_texture_walk_host",
           "expand_walk_to_frames",
           "classic_interp_track", "burn_position_bars", "run_classic",
           "run_classic_frames"]
