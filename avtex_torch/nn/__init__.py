"""Encoders (torch ``nn.Module``s)."""

from .encoders import build_encoder
from .slowfast import SFBottleneck, SlowFastR50, slowfast_pathways

__all__ = ["build_encoder", "SFBottleneck", "SlowFastR50",
           "slowfast_pathways"]
