"""Milliseconds a traced step in the span ``train.data_wait``: the loop's
wait on the prefetched batch (sampled and copied on the prefetch thread)."""

from wmhbench.spans import seconds_per_unit


def read(ctx):
    s = seconds_per_unit(ctx, "train.data_wait")
    return None if s is None else 1e3 * s
