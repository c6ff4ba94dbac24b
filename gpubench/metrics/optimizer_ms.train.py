"""Device milliseconds of a training step's optimizer: the operations
launched inside the program's ``train.optimizer`` spans (the gradients cast
to the fp32 master, SGD, the copy back), over its ``train.step`` spans."""

from gpubench import program_spans

LAYER = "optimizer"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_clips_per_s"


def read(ctx):
    return program_spans.per_span_device_ms(ctx, "train.optimizer",
                                           per="train.step")
