"""Frozen copy of the port's ``ops/brain.py`` for the benchmark's reference
(plain PyTorch / numpy; imports nothing of the port). Its docstring as
there:

Brain extraction for FOV masking (port of ``deepwmh_tpu.ops.brain``):
Otsu foreground -> largest 3D component -> morphological closing ->
interior hole fill."""

from __future__ import annotations

import math

import torch

from wmhbench.reference.components import label_components, largest_component
from wmhbench.reference.histogram import otsu_threshold
from wmhbench.reference.morphology import binary_dilation_3d, binary_erosion_3d


def fill_holes(mask):
    """Fill interior cavities: background components not touching the
    volume border become foreground."""
    m = mask > 0.5
    bg = ~m
    N = int(m.numel())
    flat = label_components(bg).reshape(-1)

    border = torch.zeros(m.shape, dtype=torch.float32, device=m.device)
    for ax in range(3):
        border.select(ax, 0).fill_(1.0)
        border.select(ax, -1).fill_(1.0)

    # flag[root] = 1 if any voxel of the component touches the border
    flags = torch.zeros(N + 1, dtype=torch.float32, device=m.device)
    flags.scatter_reduce_(0, flat, border.reshape(-1), "amax")
    outside = (flags[flat] > 0.5).reshape(m.shape) & bg
    return (m | (bg & ~outside)).float()


def brain_extract(data, spacing=(1.0, 1.0, 1.0), closing_mm: float = 4.0):
    """Binary f32 brain mask of a FLAIR/T1 head volume [D,H,W];
    ``spacing`` (mm) sets the closing radius in voxels."""
    data = data.float()
    m = (data > otsu_threshold(data)).float()
    m = largest_component(m)
    it = max(int(math.ceil(closing_mm / float(min(spacing)))), 1)
    m = binary_dilation_3d(m, iterations=it)
    m = binary_erosion_3d(m, iterations=it)
    return fill_holes(m)
