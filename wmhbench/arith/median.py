"""K2's work counted from its shape: the 3x3x3 median of a float32
volume reads each voxel once and writes each output once (8 bytes a
voxel), and its shared selection scheme does 90 min/max a voxel in the
steady state (the port's ``ops/kernels.median27_shared_ops``: per z-plane
two 3-sorts of 3 and one 9-merge of 36, half a pruned 18-merge of 48 and a
select of 18), each counted as one operation at the published f32 rate."""

from __future__ import annotations

import math

K2_BYTES_PER_VOXEL = 8
K2_MINMAX_PER_VOXEL = 90


def k2_work(shape, volumes: int) -> dict:
    vox = volumes * math.prod(int(s) for s in shape)
    return {"bytes": K2_BYTES_PER_VOXEL * vox, "ops": K2_MINMAX_PER_VOXEL * vox}
