"""Frozen copy of the port's ``ops/grid.py`` for the benchmark's reference
(plain PyTorch / numpy; imports nothing of the port). Its docstring as
there:

Separable endpoint-aligned resizing and the overlapping-patch local
mean/std grid (port of ``deepwmh_tpu.ops.grid``).

The resizes are ``index_select`` gathers with the same f32 coordinate and
weight arithmetic as the JAX functions, so the weights round the same way;
``F.interpolate`` would compute them differently. Nearest is
``floor(x + 0.5)`` on the endpoint-aligned grid, which is not torch's
``"nearest"``.

``mean_std_grid`` is stage-1's local-intensity alignment: the volume is
zero-padded to a multiple of the (even) patch size, per-cell sums over
half-patch cells come from a reshape-reduce, each overlapping patch is the
sum of two adjacent cells per axis (the last patch on an axis covers one
cell), and the coarse grid is zero-bordered, upsampled with the
endpoint-aligned linear resize and cropped by the half-step offset. A batch
of volumes on leading axes ([..., D, H, W]) is gridded volume by volume.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _grid(n_out: int, scale: float, device) -> torch.Tensor:
    return torch.arange(n_out, dtype=torch.float32, device=device) * scale


def linear_resize_axis(a: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    """Endpoint-aligned linear interpolation along ``axis`` (zoom order=1)."""
    n_in = a.shape[axis]
    if n_in == n_out:
        return a
    if n_in == 1:
        idx = torch.zeros(n_out, dtype=torch.long, device=a.device)
        return a.index_select(axis, idx)
    x = _grid(n_out, (n_in - 1) / (n_out - 1), a.device)
    lo = torch.floor(x).long().clamp(0, n_in - 2)
    w = x - lo.float()
    shape = [1] * a.dim()
    shape[axis] = n_out
    w = w.view(shape)
    return a.index_select(axis, lo) * (1 - w) + a.index_select(axis, lo + 1) * w


def nearest_resize_axis(a: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    n_in = a.shape[axis]
    if n_in == n_out:
        return a
    x = _grid(n_out, (n_in - 1) / max(n_out - 1, 1), a.device)
    idx = torch.floor(x + 0.5).long().clamp(0, n_in - 1)
    return a.index_select(axis, idx)


def _shift_add(a: torch.Tensor, axis: int) -> torch.Tensor:
    """a[i] + a[i+1] along ``axis``, zero past the end (last patch = one cell)."""
    n = a.shape[axis]
    nxt = torch.zeros_like(a)
    nxt.narrow(axis, 0, n - 1).copy_(a.narrow(axis, 1, n - 1))
    return a + nxt


def _pad_end(a: torch.Tensor, widths) -> torch.Tensor:
    """Zero-pad each of the three axes at its end by ``widths[i]``."""
    return F.pad(a, (0, widths[2], 0, widths[1], 0, widths[0]))


def mean_std_grid(data, patch_size, mask=None, order: int = 1):
    """Coarse local mean/std, upsampled to the input's shape.

    ``patch_size`` is 3 ints (voxels); odd sizes round up to even. With
    ``mask`` (shaped like ``data``) only mask > 0.5 voxels count, and empty
    patches get (mu, sigma) = (0, 1e-5). Returns (mean, std), both shaped
    like ``data`` [..., D, H, W].
    """
    data = data.float()
    lead = tuple(data.shape[:-3])
    shape = tuple(data.shape[-3:])
    p = [2 * int(math.ceil(s / 2)) for s in patch_size]
    step = [pi // 2 for pi in p]
    padded = [pi * int(math.ceil(sh / pi)) for pi, sh in zip(p, shape)]
    widths = [ps - sh for ps, sh in zip(padded, shape)]
    G = [padded[i] // step[i] for i in range(3)]
    cells = lead + (G[0], step[0], G[1], step[1], G[2], step[2])
    cell_axes = (-5, -3, -1)

    dpad = _pad_end(data, widths)
    if mask is not None:
        mpad = _pad_end((mask > 0.5).float(), widths)
        cell_cnt = mpad.reshape(cells).sum(cell_axes)
        dview = (dpad * mpad).reshape(cells)
    else:
        cell_cnt = torch.full(lead + tuple(G), float(step[0] * step[1] * step[2]),
                              dtype=torch.float32, device=data.device)
        dview = dpad.reshape(cells)
    psum = dview.sum(cell_axes)
    psq = torch.square(dview).sum(cell_axes)
    pcnt = cell_cnt
    for ax in range(len(lead), len(lead) + 3):
        psum = _shift_add(psum, ax)
        psq = _shift_add(psq, ax)
        pcnt = _shift_add(pcnt, ax)

    cnt_safe = torch.clamp(pcnt, min=1.0)
    mu = psum / cnt_safe
    var = psq / cnt_safe - torch.square(mu)
    sigma = torch.sqrt(torch.clamp(var, min=0.0))
    if mask is not None:
        empty = pcnt < 0.5
        mu = torch.where(empty, 0.0, mu)
        sigma = torch.where(empty, 1e-5, sigma)
    else:
        sigma = torch.clamp(sigma, min=1e-5)

    resize = nearest_resize_axis if order == 0 else linear_resize_axis

    def upsample(grid):
        out = F.pad(grid, (1, 1, 1, 1, 1, 1))  # zero border
        for ax in range(3):
            out = resize(out, len(lead) + ax, (G[ax] + 2) * step[ax])
        off = [s // 2 for s in step]
        return out[..., off[0]:off[0] + shape[0],
                   off[1]:off[1] + shape[1],
                   off[2]:off[2] + shape[2]]

    return upsample(mu), upsample(sigma)
