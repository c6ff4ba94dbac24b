"""Device milliseconds of a training step's forward: the operations
launched inside the program's ``train.forward`` spans (both towers, InfoNCE,
the accuracy), over its ``train.step`` spans."""

from gpubench import program_spans

LAYER = "training loop"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_clips_per_s"


def read(ctx):
    return program_spans.per_span_device_ms(ctx, "train.forward",
                                           per="train.step")
