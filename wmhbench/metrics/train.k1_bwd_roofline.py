"""K1's backward in the traced train steps: the least bytes any backward of
the norm chain moves (dy and the conv output read once, dx written once:
6 bytes a bf16 element) at the HBM rate, over the summed device time of the
backward's kernels, found by their exact names. The elements are batch x
the sum of voxels x channels over ``norm_blocks`` at the patch, for each
traced step. Nothing is read unless each kernel shows one launch a block
a traced step.

The port's backward reads each element twice (a pass for the sums over a
sample, a pass for dx): 10 bytes an element, so about 60% is its ceiling."""

from wmhbench.arith.peaks import F32_FLOP_PER_S, HBM_BYTES_PER_S
from wmhbench.arith.unet import norm_blocks, roofline_share

KERNELS = ("inorm_act_bwd_stats_kernel", "inorm_act_bwd_dx_kernel")
BWD_BYTES = 6  # per bf16 element: dy and x read, dx written


def read(ctx):
    if ctx.trace is None or not ctx.traced_units:
        return None
    blocks = norm_blocks(ctx.plan, ctx.plan["patch_size"])
    if any(ctx.trace.launches(k) != len(blocks) * ctx.traced_units for k in KERNELS):
        return None
    device_s = sum(ctx.trace.device_s(k) for k in KERNELS)
    if device_s <= 0:
        return None
    elems = ctx.batch * ctx.traced_units * sum(v * c for v, c in blocks)
    return roofline_share(BWD_BYTES * elems, 0, device_s, HBM_BYTES_PER_S, F32_FLOP_PER_S)
