"""Model FLOPs of the window's train steps (3x the forward's conv FLOPs at
the patch and batch; remat's recomputation not counted) over the window's
wall time, as a percent of the published bf16 peak."""

from wmhbench.arith.peaks import BF16_FLOP_PER_S
from wmhbench.arith.unet import forward_flops


def read(ctx):
    if not ctx.units or ctx.elapsed <= 0:
        return None
    flops = 3 * forward_flops(ctx.plan, ctx.plan["patch_size"], ctx.batch) * ctx.units
    return 100.0 * flops / ctx.elapsed / BF16_FLOP_PER_S
