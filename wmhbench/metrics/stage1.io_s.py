"""Seconds a traced case in the port's reads and writes: the main thread's
wait on the prefetched read (``stage1.read_wait``) and the NIfTI reads and
writes (``nifti.read``, ``nifti.write``), the union of their intervals."""

from wmhbench.spans import seconds_per_unit


def read(ctx):
    return seconds_per_unit(ctx, "stage1.read_wait", "nifti.read", "nifti.write")
