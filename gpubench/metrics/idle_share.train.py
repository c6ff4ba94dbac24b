"""Share of the traced window in which no operation ran on the device."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
MOVES = "train_clips_per_s"


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or not ctx.window_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.window_s)
