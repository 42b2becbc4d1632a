"""Frozen copy of the port's ``ops/filters.py`` for the benchmark's reference
(plain PyTorch / numpy; imports nothing of the port). Its docstring as
there:

Sliding-window rank and mean filters with a zero (constant-0) boundary
(port of ``deepwmh_tpu.ops.filters``): scipy.ndimage's median, uniform,
minimum and maximum filters with ``mode='constant', cval=0``.

Window placement follows scipy: for size k the window spans
[i - k//2, i + (k-1)//2] (an even k leans left), i.e. k//2 zeros before and
(k-1)//2 after.

The median is a rank filter (rank n//2 of the n window values, the upper
middle for even n, as scipy takes it; ``torch.median`` would take the
lower). A 3x3x3 median of a 3D volume, or of a batch of them [B, D, H,
W], goes to K2 (``kernels.median3``: the CUDA kernel for a CUDA tensor, one
launch a batch, its plain version on the CPU); every other size stacks the
window into a leading axis and sorts it, on every device (a batch volume
by volume).
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch
import torch.nn.functional as F



def median3_reference(vol: torch.Tensor) -> torch.Tensor:
    """The port's ``ops/kernels.median3_reference`` (K2's plain version):
    the 3x3x3 median of ``vol`` [D, H, W] or [B, D, H, W], zeros outside,
    f32: the 27 shifted views stacked, sorted, rank 13."""
    D, H, W = vol.shape[-3:]
    padded = F.pad(vol.float(), (1, 1, 1, 1, 1, 1))
    win = torch.stack([padded[..., dz:dz + D, dy:dy + H, dx:dx + W]
                       for dz in range(3) for dy in range(3) for dx in range(3)])
    return torch.sort(win, dim=0).values[13]


def _norm_ksize(kernel_size, ndim):
    if isinstance(kernel_size, int):
        return (kernel_size,) * ndim
    return tuple(int(k) for k in kernel_size)


def _pad_for_window(data, ks, value=0.0):
    pads = []
    for k in reversed(ks):  # F.pad lists the last axis first
        pads += [k // 2, (k - 1) // 2]
    return F.pad(data.float(), pads, value=value)


def _stack_from_padded(padded, ks, out_shape):
    """Window stack from an already padded tensor: leading axis prod(ks)."""
    slices = []
    for off in itertools.product(*[range(k) for k in ks]):
        slices.append(padded[tuple(slice(o, o + s) for o, s in zip(off, out_shape))])
    return torch.stack(slices)


def window_stack(data, kernel_size, pad_value=0.0):
    """Every window element stacked into a leading axis of size prod(k)."""
    ks = _norm_ksize(kernel_size, data.dim())
    return _stack_from_padded(_pad_for_window(data, ks, pad_value), ks, data.shape)


def _windows(data, kernel_size):
    """[*data.shape, *ks] view of every window of the zero-padded data."""
    ks = _norm_ksize(kernel_size, data.dim())
    out = _pad_for_window(data, ks)
    for ax, k in enumerate(ks):
        out = out.unfold(ax, k, 1)
    return out, ks


def min_filter(data, kernel_size):
    """scipy minimum_filter, constant-0 boundary."""
    win, ks = _windows(data, kernel_size)
    return win.amin(tuple(range(-len(ks), 0)))


def max_filter(data, kernel_size):
    """scipy maximum_filter, constant-0 boundary."""
    win, ks = _windows(data, kernel_size)
    return win.amax(tuple(range(-len(ks), 0)))


def mean_filter(data, kernel_size):
    """scipy uniform_filter, constant-0 boundary."""
    win, ks = _windows(data, kernel_size)
    return win.sum(tuple(range(-len(ks), 0))) / float(math.prod(ks))


# Peak bytes the median's window stack may take at once. Above this the
# volume is filtered in slabs of its leading axis, one slab's stack at a
# time: a 6x6x6 kernel on a sub-mm 400^3 volume would otherwise stack 216
# full-volume copies (~55 GB).
MEDIAN_STACK_BUDGET_BYTES = 2 * 1024**3


def median_filter(data, kernel_size, max_stack_bytes: int = None):
    """scipy median_filter, constant-0 boundary: rank n//2 of the n window
    values, in f32. ``data`` [D, H, W], or a batch [B, D, H, W] with a 3D
    ``kernel_size`` (each volume filtered on its own)."""
    batch = data.dim() == 4 and not isinstance(kernel_size, int) and len(kernel_size) == 3
    ks = _norm_ksize(kernel_size, 3 if batch else data.dim())
    if ks == (3, 3, 3):
        return median3_reference(data.float().contiguous())
    if batch:
        return torch.stack([median_filter(d, ks, max_stack_bytes) for d in data])
    n = math.prod(ks)
    budget = MEDIAN_STACK_BUDGET_BYTES if max_stack_bytes is None else max_stack_bytes
    if data.dim() != 3 or n * data.numel() * 4 <= budget:
        return torch.sort(window_stack(data, ks), dim=0).values[n // 2]

    # slabs of the leading axis; each slab's windows need k0 - 1 extra rows
    D = data.shape[0]
    plane = data.shape[1] * data.shape[2]
    rows = max(int(budget // (n * 4 * plane)), 1)
    padded = _pad_for_window(data, ks)
    out = torch.empty(data.shape, dtype=torch.float32, device=data.device)
    for start in range(0, D, rows):
        r = min(rows, D - start)
        slab = padded[start:start + r + ks[0] - 1]
        win = _stack_from_padded(slab, ks, (r,) + tuple(data.shape[1:]))
        out[start:start + r] = torch.sort(win, dim=0).values[n // 2]
    return out


def median_3mm(data, physical_voxel_size):
    """3 mm median smoothing, anisotropy-aware. For anisotropic data
    (max/min pixdim > 4) a 2D kernel runs slice by slice across the thick
    axis; otherwise a 3D kernel. Kernel sizes are int(3 mm / pixdim),
    at least 3 per axis. ``data`` [D, H, W] or a batch [B, D, H, W]."""
    pv = [float(v) for v in physical_voxel_size]
    if max(pv) / min(pv) > 4.0:
        max_axis = int(np.argmax(pv))
        ks = [1, 1, 1]
        for i in range(3):
            if i != max_axis:
                ks[i] = max(int(3.0 / pv[i]), 3)
        return median_filter(data, tuple(ks))
    return median_filter(data, tuple(max(int(3.0 / v), 3) for v in pv))
