"""Seconds a traced volume in the span ``predict.n4`` (N4 bias correction,
enqueued; a wait on the device inside it counts)."""

from wmhbench.spans import seconds_per_unit


def read(ctx):
    return seconds_per_unit(ctx, "predict.n4")
