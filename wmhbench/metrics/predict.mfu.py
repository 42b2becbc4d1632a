"""Model FLOPs of the window's volumes (8 flips x the forward's conv FLOPs
at the padded whole-volume shape) over the window's wall time, as a
percent of the published bf16 peak."""

from wmhbench.arith.peaks import BF16_FLOP_PER_S
from wmhbench.arith.unet import forward_flops, fullvol_shape, resampled_shape


def read(ctx):
    if not ctx.units or ctx.elapsed <= 0:
        return None
    shape = fullvol_shape(resampled_shape(ctx.volume_shape, ctx.spacing, ctx.plan), ctx.plan)
    flops = 8 * forward_flops(ctx.plan, shape) * ctx.units
    return 100.0 * flops / ctx.elapsed / BF16_FLOP_PER_S
