"""Share of the step loop's waits for a batch that found the prefetch
queue empty: the program's ``data.wait`` spans in the window whose
``queued`` was 0, over all of them."""

from gpubench import program_spans

LAYER = "batches"
UNIT = "%"
BETTER = "lower"
MOVES = "train_clips_per_s"


def read(ctx):
    spans = program_spans.window_spans(ctx.trace)
    waits = program_spans.named(spans or [], "data.wait")
    if not waits:
        return None
    empty = sum(s.attrs.get("queued") == 0 for s in waits)
    return 100.0 * empty / len(waits)
