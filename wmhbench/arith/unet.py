"""The U-Net's work counted from its plan: a frozen copy of the port's
``unet/flops.forward_conv_shapes`` / ``forward_flops`` (the JAX package's
integers), and the instance-norm kernel K1's bytes and operations.

A plan is the configuration file's ``plan`` dict.
"""

from __future__ import annotations

import math


def features_per_stage(plan: dict) -> list:
    return [min(int(plan["base_features"]) * 2 ** i, int(plan["max_features"]))
            for i in range(len(plan["pool_kernels"]) + 1)]


def conv_output_shape(in_spatial, stride):
    return tuple(-(-a // int(s)) for a, s in zip(in_spatial, stride))


def stage_shapes(plan: dict, input_spatial) -> list:
    spatial = [tuple(int(v) for v in input_spatial)]
    for pk in plan["pool_kernels"]:
        spatial.append(conv_output_shape(spatial[-1], pk))
    return spatial


def forward_conv_shapes(plan: dict, input_spatial) -> list:
    """(out_spatial, kernel, c_in, c_out) of every conv and transpose conv
    of one forward, in execution order; a transpose conv counts one tap per
    output voxel; one 1x1x1 head at full resolution."""
    feats = features_per_stage(plan)
    P = len(plan["pool_kernels"])
    spatial = stage_shapes(plan, input_spatial)
    shapes = []
    for i in range(P + 1):
        c_in = int(plan["in_channels"]) if i == 0 else feats[i - 1]
        k = tuple(plan["conv_kernels"][i])
        shapes.append((spatial[i], k, c_in, feats[i]))
        shapes.append((spatial[i], k, feats[i], feats[i]))
    for i in range(P - 1, -1, -1):
        k = tuple(plan["pool_kernels"][i])
        up_out = tuple(a * b for a, b in zip(spatial[i + 1], k))
        shapes.append((up_out, (1, 1, 1), feats[i + 1], feats[i]))
        ck = tuple(plan["conv_kernels"][i])
        shapes.append((spatial[i], ck, 2 * feats[i], feats[i]))
        shapes.append((spatial[i], ck, feats[i], feats[i]))
    shapes.append((spatial[0], (1, 1, 1), feats[0], int(plan["num_classes"])))
    return shapes


def forward_flops(plan: dict, input_spatial, batch: int = 1) -> int:
    """Conv MACs x 2 of one forward; norm and activation not counted."""
    total = 0
    for out_sp, k, c_in, c_out in forward_conv_shapes(plan, input_spatial):
        total += 2 * math.prod(out_sp) * math.prod(k) * c_in * c_out
    return int(total) * int(batch)


def fullvol_shape(shape, plan: dict) -> tuple:
    """Each axis padded up to a multiple of the network's total stride."""
    strides = [1, 1, 1]
    for pk in plan["pool_kernels"]:
        for a in range(3):
            strides[a] *= int(pk[a])
    return tuple(int(-(-int(s) // st) * st) for s, st in zip(shape, strides))


def norm_blocks(plan: dict, input_spatial) -> list:
    """(voxels, channels) of every conv -> norm -> activation block's
    output of one batch-1 forward, in call order."""
    feats = features_per_stage(plan)
    spatial = stage_shapes(plan, input_spatial)
    P = len(plan["pool_kernels"])
    enc = [(math.prod(spatial[i]), feats[i]) for i in range(P + 1) for _ in range(2)]
    dec = [(math.prod(spatial[i]), feats[i]) for i in range(P - 1, -1, -1) for _ in range(2)]
    return enc + dec


# K1 on bf16 activations: the statistics kernel reads each element once
# (2 bytes) and does a multiply-add and an add (3 operations); the apply
# kernel reads it and writes the result (4 bytes) and does a subtract, a
# multiply-add and the leaky ReLU's multiply-select (4 operations).
K1_STATS_BYTES, K1_STATS_OPS = 2, 3
K1_APPLY_BYTES, K1_APPLY_OPS = 4, 4


def k1_work(plan: dict, input_spatial, passes: int) -> dict:
    """Launches, element count, bytes and operations of K1's two kernels
    over ``passes`` batch-1 forwards at ``input_spatial``."""
    elems = passes * sum(v * c for v, c in norm_blocks(plan, input_spatial))
    launches = passes * len(norm_blocks(plan, input_spatial))
    return {"launches": launches, "elements": elems,
            "stats_bytes": K1_STATS_BYTES * elems, "stats_ops": K1_STATS_OPS * elems,
            "apply_bytes": K1_APPLY_BYTES * elems, "apply_ops": K1_APPLY_OPS * elems}


def roofline_share(bytes_: float, ops: float, device_s: float, hbm: float,
                   flop_rate: float) -> float:
    """Percent: the least time the chip could take (the larger of the bytes
    and the operations bound) over the measured device time."""
    return 100.0 * max(bytes_ / hbm, ops / flop_rate) / device_s


def resampled_shape(shape, spacing, plan: dict) -> tuple:
    """The volume's shape at the plan's spacing (the port's preprocessing:
    spacing rounded to 4 decimals, round(shape * spacing / target))."""
    sp = [round(float(s), 4) for s in spacing]
    return tuple(max(int(round(int(n) * s / float(t))), 1)
                 for n, s, t in zip(shape, sp, plan["target_spacing"]))
