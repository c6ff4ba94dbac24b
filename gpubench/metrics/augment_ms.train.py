"""Device milliseconds a training step spends augmenting its clips: the
operations launched inside the program's ``train.augment`` spans, over its
``train.step`` spans."""

from gpubench import program_spans

LAYER = "augmentation"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_clips_per_s"


def read(ctx):
    return program_spans.per_span_device_ms(ctx, "train.augment",
                                           per="train.step")
