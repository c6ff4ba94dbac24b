"""The training window's share of the H100's bf16 peak: three times the
forward operations of every clip of every completed step (forward and
the two products of the backward; remat's recomputation not counted),
over the traced window."""

from gpubench import flops

LAYER = "training loop"
UNIT = "%"
BETTER = "higher"
MOVES = "train_clips_per_s"


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or not ctx.window_s:
        return None
    ops = 3 * ctx.work["clips"] * flops.forward_flops(ctx.config)
    return 100.0 * ops / (ctx.window_s * flops.PEAK_BF16_FLOP_S)
