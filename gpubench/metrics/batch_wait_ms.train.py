"""Host milliseconds the step loop waited for its next batch, per step:
the harness's span around the call that hands the loop a batch."""

LAYER = "batches"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_clips_per_s"


def read(ctx):
    waits = ctx.spans.get("batch_wait")
    if not waits or not ctx.work.get("steps"):
        return None
    return 1e3 * sum(waits) / ctx.work["steps"]
