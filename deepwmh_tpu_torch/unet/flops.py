"""Analytic forward-pass FLOP count of the plan-driven 3D U-Net (the port's
copy of ``deepwmh_tpu.unet.flops``; the same integers).

Convolution MACs x 2, walking ``UNet3D.forward``'s schedule: two convs per
encoder stage (the first strided past stage 0), per decoder stage a
transpose-conv upsample and two convs, one 1x1x1 segmentation head at full
resolution (no deep supervision: the deeper heads are not run). The
transpose conv (kernel == stride) counts one kernel tap per output voxel,
since each output receives exactly one contribution; the norm and
activation elementwise work is not counted. The count is the model's
useful math, the numerator of a FLOP rate or a peak share.
"""

from __future__ import annotations

import math

import numpy as np

from deepwmh_tpu_torch.unet.plan import Plan, features_per_stage


def conv_output_shape(in_spatial, stride):
    """SAME-padding output spatial dims (ceil division)."""
    return tuple(-(-a // int(s)) for a, s in zip(in_spatial, stride))


def forward_conv_shapes(plan: Plan, input_spatial):
    """(out_spatial, kernel, c_in, c_out) of every conv and transpose conv
    of one forward, in execution order; a transpose conv has kernel
    (1, 1, 1), one tap per output voxel."""
    feats = features_per_stage(plan)
    P = len(plan.pool_kernels)
    spatial = [tuple(int(v) for v in input_spatial)]
    for i in range(P):
        spatial.append(conv_output_shape(spatial[-1], plan.pool_kernels[i]))

    shapes = []
    for i in range(P + 1):
        c_in = plan.in_channels if i == 0 else feats[i - 1]
        k = tuple(plan.conv_kernels[i])
        shapes.append((spatial[i], k, c_in, feats[i]))
        shapes.append((spatial[i], k, feats[i], feats[i]))
    for i in range(P - 1, -1, -1):
        k = tuple(plan.pool_kernels[i])
        up_out = tuple(a * b for a, b in zip(spatial[i + 1], k))
        shapes.append((up_out, (1, 1, 1), feats[i + 1], feats[i]))
        ck = tuple(plan.conv_kernels[i])
        shapes.append((spatial[i], ck, 2 * feats[i], feats[i]))
        shapes.append((spatial[i], ck, feats[i], feats[i]))
    shapes.append((spatial[0], (1, 1, 1), feats[0], plan.num_classes))
    return shapes


def forward_flops(plan: Plan, input_spatial, batch: int = 1) -> int:
    """Conv MACs x 2 of one batch-``batch`` forward at ``input_spatial``."""
    total = 0
    for out_sp, k, c_in, c_out in forward_conv_shapes(plan, input_spatial):
        total += 2 * math.prod(out_sp) * math.prod(k) * c_in * c_out
    return int(total) * int(batch)


def case_model_flops(plan: Plan, res_shape, patch_size, step_fraction,
                     tta: bool, fullvol: bool) -> int:
    """Model FLOPs of one inference case: the flips times the forward cost,
    at the padded whole-volume shape, or at the patch size times the
    number of real sliding-window positions."""
    from deepwmh_tpu_torch.unet.infer import ALL_FLIPS, NO_FLIPS, fullvol_shape, patch_positions
    from deepwmh_tpu_torch.unet.preprocess import padded_shape

    n_flips = len(ALL_FLIPS if tta else NO_FLIPS)
    if fullvol:
        return n_flips * forward_flops(plan, fullvol_shape(res_shape, plan))
    target = padded_shape(res_shape, patch_size)
    _pos, pos_w = patch_positions(target, patch_size, step_fraction)
    n_real = int(np.asarray(pos_w).sum())
    return n_flips * n_real * forward_flops(plan, patch_size)
