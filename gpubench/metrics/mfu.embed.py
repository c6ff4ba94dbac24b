"""The embed window's share of the H100's bf16 peak: both towers'
operations over every segment completed (``gpubench/flops.py``, padded
batch rows not counted), over the traced window."""

from gpubench import flops

LAYER = "model"
UNIT = "%"
BETTER = "higher"
MOVES = "embed_segments_per_s"


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or not ctx.window_s:
        return None
    ops = ctx.work["clip_forwards"] * flops.forward_flops(ctx.config)
    return 100.0 * ops / (ctx.window_s * flops.PEAK_BF16_FLOP_S)
