"""Seconds a traced volume in the span ``components.label``: the connected
component labelling of the spark removal and the brain mask, whose rounds
each wait on the device."""

from wmhbench.spans import seconds_per_unit


def read(ctx):
    return seconds_per_unit(ctx, "components.label")
