"""Frozen copy of the port's ``ops/morphology.py`` for the benchmark's reference
(plain PyTorch / numpy; imports nothing of the port). Its docstring as
there:

Binary morphology with the connectivity-1 cross and a zero border (port
of ``deepwmh_tpu.ops.morphology``): erosion = min over the cross, dilation =
max, as shift-compares."""

from __future__ import annotations

import torch


def _shift(a, delta: int, axis: int):
    """a shifted by one along ``axis`` (a[i + delta]), False past the edge."""
    out = torch.zeros_like(a)
    n = a.shape[axis]
    if delta == 1:
        out.narrow(axis, 0, n - 1).copy_(a.narrow(axis, 1, n - 1))
    else:
        out.narrow(axis, 1, n - 1).copy_(a.narrow(axis, 0, n - 1))
    return out


def _erode(m, axes):
    out = m
    for ax in axes:
        out = out & _shift(m, 1, ax) & _shift(m, -1, ax)
    return out


def _dilate(m, axes):
    out = m
    for ax in axes:
        out = out | _shift(m, 1, ax) | _shift(m, -1, ax)
    return out


def binary_erosion_2d(mask, slice_axis: int, iterations: int = 1):
    """Erode every 2D slice across ``slice_axis`` with the 2D cross, zero
    border, all slices at once. A batch [B, D, H, W] erodes only across its
    last three axes (``slice_axis`` counts from the first of the four)."""
    m = mask > 0.5
    axes = tuple(a for a in range(max(mask.dim() - 3, 0), mask.dim()) if a != slice_axis)
    for _ in range(iterations):
        m = _erode(m, axes)
    return m.float()


def binary_dilation_2d(mask, slice_axis: int, iterations: int = 1):
    m = mask > 0.5
    axes = tuple(a for a in range(mask.dim()) if a != slice_axis)
    for _ in range(iterations):
        m = _dilate(m, axes)
    return m.float()


def binary_erosion_3d(mask, iterations: int = 1):
    m = mask > 0.5
    for _ in range(iterations):
        m = _erode(m, (0, 1, 2))
    return m.float()


def binary_dilation_3d(mask, iterations: int = 1):
    m = mask > 0.5
    for _ in range(iterations):
        m = _dilate(m, (0, 1, 2))
    return m.float()
