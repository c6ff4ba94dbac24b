"""Hand-written Hopper kernels and their wrappers.

Every wrapper keeps a plain integer ``launches`` that it increments where
it launches its kernel; ``launch_counts`` / ``reset_launch_counts`` read
and clear them all, so a run can show which kernels the main path took.
"""

from . import fused_matmul, pairwise, stage_fused
from .fused_matmul import fused_conv1x1, fused_conv1x1_reference
from .pairwise import pairwise_l2, pairwise_l2_reference
from .stage_fused import (BlockWeights, fused_stage, stage_reference,
                          stage_weights_from_params)

_WRAPPERS = {"fused_conv1x1": fused_matmul, "pairwise_l2": pairwise,
             "fused_stage": stage_fused}


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for mod in _WRAPPERS.values():
        mod.launches = 0


__all__ = ["BlockWeights", "fused_conv1x1", "fused_conv1x1_reference",
           "fused_stage", "pairwise_l2", "pairwise_l2_reference",
           "stage_reference", "stage_weights_from_params", "launch_counts",
           "reset_launch_counts"]
