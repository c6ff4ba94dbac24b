"""Device milliseconds a video spends in preprocessing: the operations
launched inside the program's ``embed.preprocess`` spans (the window gather,
``preprocess_clip``, ``slowfast_pathways``), over its ``embed.video`` spans."""

from gpubench import program_spans

LAYER = "preprocessing"
UNIT = "ms"
BETTER = "lower"
MOVES = "embed_segments_per_s"


def read(ctx):
    return program_spans.per_span_device_ms(ctx, "embed.preprocess",
                                           per="embed.video")
