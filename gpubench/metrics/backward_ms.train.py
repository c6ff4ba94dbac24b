"""Device milliseconds of a training step's backward: the operations
launched inside the program's ``train.backward`` spans (remat's recompute
included), over its ``train.step`` spans."""

from gpubench import program_spans

LAYER = "training loop"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_clips_per_s"


def read(ctx):
    return program_spans.per_span_device_ms(ctx, "train.backward",
                                           per="train.step")
