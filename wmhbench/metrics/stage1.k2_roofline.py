"""K2, the 3x3x3 median: the least time the card could take for the traced
cases' medians (the larger of the bytes bound and the min/max bound at the
published f32 rate) over the kernel's device time, found by its exact
name. Nothing is read when the trace holds another number of launches
than one a traced case."""

from wmhbench.arith.median import k2_work
from wmhbench.arith.peaks import F32_FLOP_PER_S, HBM_BYTES_PER_S
from wmhbench.arith.unet import roofline_share

KERNEL = "median3_kernel"


def read(ctx):
    if ctx.trace is None or not ctx.traced_units:
        return None
    device_s = ctx.trace.device_s(KERNEL)
    if device_s <= 0 or ctx.trace.launches(KERNEL) != ctx.traced_units:
        return None
    work = k2_work(ctx.volume_shape, ctx.traced_units)
    return roofline_share(work["bytes"], work["ops"], device_s, HBM_BYTES_PER_S, F32_FLOP_PER_S)
