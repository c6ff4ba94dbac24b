"""Device milliseconds of host-to-device copies a training step takes
(its batch's upload), over the steps completed in the window."""

LAYER = "training loop"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_clips_per_s"


def read(ctx):
    if ctx.trace is None or not ctx.work.get("steps"):
        return None
    seconds, count = ctx.trace.device_s(lambda n: "htod" in n.lower())
    if not count:
        return None
    return 1e3 * seconds / ctx.work["steps"]
