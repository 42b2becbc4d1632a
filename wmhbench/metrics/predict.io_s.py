"""Seconds a traced volume in the port's NIfTI reads and writes: the
spans ``nifti.read`` and ``nifti.write``, the union of their intervals."""

from wmhbench.spans import seconds_per_unit


def read(ctx):
    return seconds_per_unit(ctx, "nifti.read", "nifti.write")
