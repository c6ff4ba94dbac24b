"""Device milliseconds a video spends in the SlowFast stems: the
operations launched inside the program's ``slowfast_stems`` range, over
the videos embedded in the window."""

LAYER = "stems"
UNIT = "ms"
BETTER = "lower"
MOVES = "embed_segments_per_s"


def read(ctx):
    if ctx.trace is None or not ctx.work.get("videos"):
        return None
    seconds = ctx.trace.device_s_in_range("slowfast_stems")
    if not seconds:
        return None
    return 1e3 * seconds / ctx.work["videos"]
