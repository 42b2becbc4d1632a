"""Experiment planning: dataset fingerprint -> network/patch/spacing plan.

The port's own copy of ``deepwmh_tpu.unet.plan``: a plan.json written by
either package loads in the other, and the same fingerprint gives the same
plan.

Rebuilds the role of the nnU-Net fork's `nnUNet_plan_and_preprocess`
(invoked by the reference at deepwmh/pipeline/DCNN_multistage.py:281,487):
from the training volumes' shapes and spacings, derive target spacing, patch
size, per-stage pooling/conv kernels and batch size. The heuristics follow
the published nnU-Net recipe (median target spacing with 10th-percentile
override for strongly anisotropic axes; pool until an axis drops below 8
voxels, max 5 per axis; anisotropic axes start pooling/3x3-conv'ing only
once their spacing is within 2x of the finest axis).

TPU adjustments: patch dims are rounded to multiples of 2^num_pools (static
shapes for XLA), the voxel budget defaults to 128^3 (fits a ~30M-param
bf16 U-Net activation footprint comfortably in one chip's HBM), and plans
serialize to JSON (no pickles) so model releases are portable.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

import numpy as np

MAX_POOLS = 5
MIN_AXIS_AFTER_POOL = 4  # stop pooling an axis once it would go below this
DEFAULT_VOXEL_BUDGET = 128 * 128 * 128
MAX_FEATURES = 320
BASE_FEATURES = 32
ANISO_SPACING_FACTOR = 2.0  # axis "anisotropic" while spacing > 2x min spacing
ANISO_THRESHOLD = 3.0  # dataset anisotropic if max/min spacing > 3


@dataclass
class Plan:
    """Serializable experiment plan (replaces nnUNet plans.pkl)."""

    target_spacing: list
    patch_size: list
    batch_size: int
    pool_kernels: list  # [num_pools][3] of 1/2
    conv_kernels: list  # [num_pools+1][3] of 1/3
    base_features: int = BASE_FEATURES
    max_features: int = MAX_FEATURES
    num_classes: int = 2
    in_channels: int = 1
    normalization: str = "zscore"
    median_shape: list = field(default_factory=lambda: [0, 0, 0])
    # convolution padding geometry: "same" (XLA SAME, asymmetric for even
    # stride windows) or "torch" (symmetric k//2 on strided convs — the
    # geometry of torch Conv3d(padding=k//2), needed for models converted
    # from the reference's PyTorch nnU-Net checkpoints to stay bit-faithful;
    # stride-1 odd-kernel convs are identical under both). Only strided
    # convolutions differ.
    pad_style: str = "same"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "Plan":
        return Plan(**json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path: str) -> "Plan":
        with open(path, "r") as f:
            return Plan.from_json(f.read())

    @property
    def num_pools(self) -> int:
        return len(self.pool_kernels)


def compute_target_spacing(spacings: np.ndarray) -> np.ndarray:
    """Median spacing; for strongly anisotropic data the thick axis uses the
    10th percentile instead (the nnU-Net rule)."""
    spacings = np.asarray(spacings, dtype=np.float64)
    target = np.percentile(spacings, 50, axis=0)
    if target.max() / target.min() > ANISO_THRESHOLD:
        worst = int(np.argmax(target))
        target[worst] = np.percentile(spacings[:, worst], 10)
        other = [a for a in range(3) if a != worst]
        # never let the thick axis get finer than the others
        target[worst] = max(target[worst], min(target[o] for o in other))
    return target


def plan_experiment(
    shapes,
    spacings,
    voxel_budget: int = DEFAULT_VOXEL_BUDGET,
    batch_size: int = 2,
    num_classes: int = 2,
) -> Plan:
    """Derive a Plan from the dataset fingerprint.

    shapes: [N][3] voxel shapes; spacings: [N][3] mm voxel sizes.
    """
    shapes = np.asarray(shapes, dtype=np.float64)
    spacings = np.asarray(spacings, dtype=np.float64)
    target = compute_target_spacing(spacings)

    # median shape in the resampled (target-spacing) grid
    new_shapes = shapes * spacings / target[None, :]
    median_shape = np.median(new_shapes, axis=0)

    # initial patch: median shape, capped by the voxel budget by repeatedly
    # shrinking the axis that is largest relative to the median shape
    patch = np.minimum(median_shape, 999999).astype(np.float64)
    patch = np.maximum(patch, 4)
    while np.prod(patch) > voxel_budget:
        if np.all(patch <= 4):  # floor reached on all axes: budget < 64
            break
        rel = patch / median_shape
        worst = int(np.argmax(rel * patch))
        patch[worst] = max(patch[worst] * 0.9, 4)
    patch = np.floor(patch).astype(np.int64)

    # per-axis pooling schedule, spacing-aware
    cur_spacing = target.copy()
    cur_size = patch.astype(np.float64).copy()
    pools_per_axis = np.zeros(3, np.int64)
    pool_kernels = []
    while True:
        min_sp = cur_spacing.min()
        can_pool = [
            (cur_size[a] / 2 >= MIN_AXIS_AFTER_POOL)
            and (pools_per_axis[a] < MAX_POOLS)
            and (cur_spacing[a] <= ANISO_SPACING_FACTOR * min_sp)
            for a in range(3)
        ]
        if not any(can_pool):
            break
        k = [2 if can_pool[a] else 1 for a in range(3)]
        pool_kernels.append(k)
        for a in range(3):
            if can_pool[a]:
                cur_size[a] /= 2
                cur_spacing[a] *= 2
                pools_per_axis[a] += 1

    # conv kernels: 1 along axes still strongly anisotropic at that depth
    conv_kernels = []
    sp = target.copy()
    for stage in range(len(pool_kernels) + 1):
        min_sp = sp.min()
        k = [1 if sp[a] > ANISO_SPACING_FACTOR * min_sp else 3 for a in range(3)]
        conv_kernels.append(k)
        if stage < len(pool_kernels):
            for a in range(3):
                sp[a] *= pool_kernels[stage][a]

    # round patch up to a multiple of the total pooling stride (static shapes)
    stride = np.ones(3, np.int64)
    for k in pool_kernels:
        stride *= np.asarray(k, np.int64)
    patch = (np.ceil(patch / stride) * stride).astype(np.int64)
    while np.prod(patch) > voxel_budget * 1.25:  # rounding overshoot guard
        worst = int(np.argmax(patch))
        if patch[worst] - stride[worst] < max(stride[worst], 4):
            break
        patch[worst] -= stride[worst]

    return Plan(
        target_spacing=[float(s) for s in target],
        patch_size=[int(v) for v in patch],
        batch_size=int(batch_size),
        pool_kernels=[[int(v) for v in k] for k in pool_kernels],
        conv_kernels=[[int(v) for v in k] for k in conv_kernels],
        num_classes=num_classes,
        median_shape=[int(round(v)) for v in median_shape],
    )


def default_plan_1mm_iso(num_classes: int = 2) -> Plan:
    """The flagship configuration: 1 mm isotropic T2-FLAIR head, 128^3 patch,
    5 pooling stages, 32->320 features — the TPU-native counterpart of
    nnU-Net's 3d_fullres default for brain MRI."""
    return plan_experiment(
        shapes=[[192, 224, 192]], spacings=[[1.0, 1.0, 1.0]], num_classes=num_classes
    )


def features_per_stage(plan: Plan) -> list:
    return [
        min(plan.base_features * (2**i), plan.max_features)
        for i in range(plan.num_pools + 1)
    ]
