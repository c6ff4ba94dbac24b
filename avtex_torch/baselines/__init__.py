"""Audio-conditioning baselines (the port of avtex/baselines/): the
nearest-neighbour segment per driving example, the random sequential and
random segment walks, and the audio shift."""

from .audio_nn import audio_nearest_neighbour
from .random_walks import random_segment_walk, random_sequential_walk
from .shift import shift_audio

__all__ = ["audio_nearest_neighbour", "random_sequential_walk",
           "random_segment_walk", "shift_audio"]
