"""Milliseconds a traced step in the span ``train.draw_wait``: the host's
wait for the step's augmentation draws, whose scalars reach it from the
card's draw stream (the step's one wait on the card between epoch ends)."""

from wmhbench.spans import seconds_per_unit


def read(ctx):
    s = seconds_per_unit(ctx, "train.draw_wait")
    return None if s is None else 1e3 * s
