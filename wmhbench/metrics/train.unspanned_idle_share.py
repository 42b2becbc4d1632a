"""The share of the device's idle gaps in the traced window (between
kernels) under no span of the port: idle time no pipeline stage names."""

from wmhbench.spans import unspanned_idle_share


def read(ctx):
    return unspanned_idle_share(ctx)
