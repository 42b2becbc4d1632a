"""Connected components and component filtering (port of
``deepwmh_tpu.ops.components``).

Labels are exactly the JAX function's: 6-connectivity (faces), every
foreground voxel's label is the minimum linear index of its component, and
background is ``N`` (= mask.numel()). The round structure is the JAX one:
per connectivity axis a segmented min over contiguous foreground runs, then
two pointer jumps (label = label[label]), until nothing changes. Torch has
no segmented scan, so a run-min is built from run ids (a cumsum of run
starts), ``scatter_reduce(..., "amin")`` and a gather. Labels are int64
(torch's index type).
"""

from __future__ import annotations

import numpy as np
import torch


def _run_min(lbl, m, ax: int, N: int):
    """Every foreground voxel gets the min label over its contiguous
    foreground run along ``ax``; background keeps ``N``."""
    lt = lbl.movedim(ax, -1)
    mt = m.movedim(ax, -1)
    start = mt.clone()
    start[..., 1:] &= ~mt[..., :-1]
    rid = torch.cumsum(start.reshape(-1), 0) - 1
    rid = torch.where(mt.reshape(-1), rid, N)  # background -> dump slot N
    mins = torch.full((N + 1,), N, dtype=lbl.dtype, device=lbl.device)
    mins.scatter_reduce_(0, rid, lt.reshape(-1), "amin")
    return mins[rid].reshape(lt.shape).movedim(-1, ax)


def label_components(mask, axes=(0, 1, 2), max_iters: int = 4096):
    """int64 labels shaped like ``mask``: the component's minimum linear
    index for foreground, N for background. ``axes`` restricts connectivity
    (e.g. (1, 2) labels each [0]-slice independently)."""
    m = mask > 0.5
    N = int(m.numel())
    idx = torch.arange(N, dtype=torch.long, device=m.device).reshape(m.shape)
    lbl = torch.where(m, idx, N)

    def jump(l):
        flat = l.reshape(-1)
        j = torch.minimum(flat, flat[flat.clamp(max=N - 1)])
        return torch.where(flat < N, j, N).reshape(l.shape)

    for _ in range(max_iters):
        l2 = lbl
        for ax in axes:
            l2 = _run_min(l2, m, ax, N)
        l2 = jump(jump(l2))
        changed = bool((l2 != lbl).any())
        lbl = l2
        if not changed:
            break
    return lbl


def component_sizes(lbl):
    """Per-voxel component size (f32) from root labels; 0 on background."""
    N = int(lbl.numel())
    flat = lbl.reshape(-1)
    fg = flat < N
    sizes = torch.bincount(flat, minlength=N + 1).float()
    return (sizes[flat] * fg).reshape(lbl.shape)


def remove_sparks(mask, min_volume: int = 3):
    """Drop components smaller than ``min_volume`` voxels."""
    m = mask > 0.5
    sz = component_sizes(label_components(m))
    return ((sz >= min_volume) & m).float()


def spark_min_volume(voxel_size) -> int:
    """The 3 mm^3 spark threshold in voxels (3 voxels for thick slices)."""
    pv = [float(v) for v in voxel_size]
    voxel_volume = pv[0] * pv[1] * pv[2]
    if max(pv) / min(pv) > 3.0:
        return 3
    return max(int(np.around(3.0 / voxel_volume)), 2)


def remove_3mm_sparks(mask, voxel_size):
    """Remove components smaller than 3 mm^3."""
    return remove_sparks(mask, min_volume=spark_min_volume(voxel_size))


def largest_component(mask, axes=(0, 1, 2)):
    """Keep only the largest component; ties keep the component whose first
    (raster-order) voxel comes first. With axes=(1, 2) per [0]-slice."""
    m = mask > 0.5
    N = int(m.numel())
    lbl = label_components(m, axes=axes)
    sz = component_sizes(lbl)
    red = tuple(axes)
    max_sz = sz.amax(dim=red, keepdim=True)
    cand = torch.where((sz == max_sz) & m, lbl, N)
    min_root = cand.amin(dim=red, keepdim=True)
    keep = m & (lbl == min_root) & (max_sz > 0)
    return keep.float()
