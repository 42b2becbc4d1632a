"""Seconds a traced case in the span ``components.label``: the connected
component labelling of the component filtering and the spark removal,
whose rounds each wait on the device."""

from wmhbench.spans import seconds_per_unit


def read(ctx):
    return seconds_per_unit(ctx, "components.label")
