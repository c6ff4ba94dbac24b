"""Device milliseconds of host-to-device copies a video takes (its
upload), over the videos embedded in the window."""

LAYER = "tables"
UNIT = "ms"
BETTER = "lower"
MOVES = "embed_segments_per_s"


def read(ctx):
    if ctx.trace is None or not ctx.work.get("videos"):
        return None
    seconds, count = ctx.trace.device_s(lambda n: "htod" in n.lower())
    if not count:
        return None
    return 1e3 * seconds / ctx.work["videos"]
