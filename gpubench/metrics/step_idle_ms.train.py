"""Device idle milliseconds while the program's ``train.step`` span is open,
a step: the gaps cut by the spans' own intervals, so the wait for the
next batch, outside the step, is not counted."""

from gpubench import program_spans

LAYER = "device"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_clips_per_s"


def read(ctx):
    spans = program_spans.window_spans(ctx.trace)
    if not spans or not ctx.trace.device:
        return None
    steps = program_spans.count(spans, "train.step")
    if not steps:
        return None
    return program_spans.idle_ms(ctx.trace, spans, "train.step") / steps
