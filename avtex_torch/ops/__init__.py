"""Hand-written Hopper kernels and their wrappers.

Every wrapper keeps a plain integer ``launches`` that it increments where
it launches its kernel; ``launch_counts`` / ``reset_launch_counts`` read
and clear them all, so a run can show which kernels the main path took.
"""

from . import fused_matmul, pairwise
from .fused_matmul import fused_conv1x1, fused_conv1x1_reference
from .pairwise import pairwise_l2, pairwise_l2_reference

_WRAPPERS = {"fused_conv1x1": fused_matmul, "pairwise_l2": pairwise}


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for mod in _WRAPPERS.values():
        mod.launches = 0


__all__ = ["fused_conv1x1", "fused_conv1x1_reference", "pairwise_l2",
           "pairwise_l2_reference", "launch_counts", "reset_launch_counts"]
