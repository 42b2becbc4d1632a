"""Seconds a traced volume in the span ``predict.preview`` (the GIF
preview on the host)."""

from wmhbench.spans import seconds_per_unit


def read(ctx):
    return seconds_per_unit(ctx, "predict.preview")
