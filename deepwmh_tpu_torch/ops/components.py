"""Connected components, component filtering and label voting (port of
``deepwmh_tpu.ops.components``).

Labels are exactly the JAX function's: 6-connectivity (faces), every
foreground voxel's label is the minimum linear index of its component, and
background is ``N`` (= mask.numel()). The round structure is the JAX one:
per connectivity axis a segmented min over contiguous foreground runs, then
two pointer jumps (label = label[label]), until nothing changes. Torch has
no segmented scan, so a run-min is built from run ids (a cumsum of run
starts), ``scatter_reduce(..., "amin")`` and a gather. Labels are int64
(torch's index type). Each round waits on the device for its test of
change, so a labelling is the span ``components.label``
(``utils/profiling.span``), the one mechanism the spark removal, the brain
mask and the component filtering share.
"""

from __future__ import annotations

import numpy as np
import torch

from deepwmh_tpu_torch.ops.morphology import binary_erosion_2d
from deepwmh_tpu_torch.utils.profiling import span


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


@span("components.label")
def label_components(mask, axes=(0, 1, 2), max_iters: int = 4096, return_rounds: bool = False):
    """int64 labels shaped like ``mask``: the component's minimum linear
    index for foreground, N for background. ``axes`` restricts connectivity
    (e.g. (1, 2) labels each [0]-slice independently). With
    ``return_rounds``, (labels, rounds run, the last one changing nothing)."""
    m = mask > 0.5
    N = int(m.numel())
    idx = torch.arange(N, dtype=torch.long, device=m.device).reshape(m.shape)
    lbl = torch.where(m, idx, N)

    def jump(l):
        flat = l.reshape(-1)
        j = torch.minimum(flat, flat[flat.clamp(max=N - 1)])
        return torch.where(flat < N, j, N).reshape(l.shape)

    rounds = 0
    for rounds in range(1, max_iters + 1):
        l2 = lbl
        for ax in axes:
            l2 = _run_min(l2, m, ax, N)
        l2 = jump(jump(l2))
        changed = bool((l2 != lbl).any())
        lbl = l2
        if not changed:
            break
    return (lbl, rounds) if return_rounds else lbl


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


def component_filtering(mask, voxel_size):
    """Per-slice brain-mask clean-up: for each filtered orientation erode
    every 2D slice (cross, zero border) and keep its largest component;
    the result is the union over orientations. Thick-slice data
    (max/min pixdim > 3) filters only the thick axis. A batch of cases
    [B, D, H, W] is labelled together, its cases as further slices (the
    connectivity stays in-plane), so one labelling serves every case: its
    rounds, one host sync each, are the most any slice of the batch needs."""
    pv = [float(v) for v in voxel_size]
    if max(pv) / min(pv) > 3.0:
        do_filtering = [ax == int(np.argmax(pv)) for ax in range(3)]
    else:
        do_filtering = [True, True, True]
    m = (mask > 0.5).float()
    lead = m.dim() - 3
    union = torch.zeros_like(m)
    for ax in range(3):
        if do_filtering[ax]:
            inplane = tuple(lead + a for a in range(3) if a != ax)
            union = union + largest_component(binary_erosion_2d(m, slice_axis=lead + ax),
                                              axes=inplane)
        else:
            union = union + m
    return (union > 0.5).float()


def average_contiguous_labels(stack, num_classes: int):
    """Majority vote over a [..., K, D, H, W] stack of label maps with ids
    0..num_classes-1; ties go to the lowest id (``torch.argmax`` returns
    the first maximum, like ``np.argmax``). Returns int64."""
    ilbl = stack.to(torch.int32)
    counts = torch.stack([(ilbl == ch).float().sum(-4) for ch in range(num_classes)])
    return torch.argmax(counts, dim=0)


def map_label(label, src_ids, dst_ids):
    """Remap label ids on the host (numpy in, int32 numpy out)."""
    if len(src_ids) != len(dst_ids):
        raise ValueError("src_ids and dst_ids differ in length")
    i_label = np.around(np.asarray(label)).astype("int32")
    out = np.zeros_like(i_label)
    for s, d in zip(src_ids, dst_ids):
        out[i_label == s] = d
    return out
