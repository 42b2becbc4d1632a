"""K1's apply kernel (each activation read once and written once): the least
time the card could take for the traced volumes' sweeps (the larger of the
bytes bound and the operations bound at the published f32 rate) over the
kernel's device time, found by its exact name. Nothing is read when the
launches in the trace are not the sweeps' count."""

from wmhbench.arith.peaks import F32_FLOP_PER_S, HBM_BYTES_PER_S
from wmhbench.arith.unet import fullvol_shape, k1_work, resampled_shape, roofline_share

KERNEL = "inorm_act_kernel"


def read(ctx):
    if ctx.trace is None or not ctx.traced_units:
        return None
    shape = fullvol_shape(resampled_shape(ctx.volume_shape, ctx.spacing, ctx.plan), ctx.plan)
    work = k1_work(ctx.plan, shape, passes=8 * ctx.traced_units)
    device_s = ctx.trace.device_s(KERNEL)
    if device_s <= 0 or ctx.trace.launches(KERNEL) != work["launches"]:
        return None
    return roofline_share(work["apply_bytes"], work["apply_ops"], device_s,
                          HBM_BYTES_PER_S, F32_FLOP_PER_S)
