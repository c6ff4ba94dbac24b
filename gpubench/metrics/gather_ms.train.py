"""Host milliseconds the prefetch thread takes to gather one batch: the
program's ``data.gather`` spans in the window, their mean."""

from gpubench import program_spans

LAYER = "batches"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_clips_per_s"


def read(ctx):
    spans = program_spans.window_spans(ctx.trace)
    gathers = program_spans.named(spans or [], "data.gather")
    if not gathers:
        return None
    return sum(s.end_ns - s.start_ns for s in gathers) / 1e6 / len(gathers)
