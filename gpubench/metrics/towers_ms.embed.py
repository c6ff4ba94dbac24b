"""Device milliseconds a video spends in both towers: the operations
launched inside the program's ``embed.towers`` spans, over its ``embed.video``
spans."""

from gpubench import program_spans

LAYER = "model"
UNIT = "ms"
BETTER = "lower"
MOVES = "embed_segments_per_s"


def read(ctx):
    return program_spans.per_span_device_ms(ctx, "embed.towers",
                                           per="embed.video")
