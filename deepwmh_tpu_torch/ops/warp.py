"""Resampling through affine transforms: the part of ``deepwmh_tpu.ops.warp``
that training augmentation needs (its displacement fields and compositions
serve registration and are not ported yet).

Conventions as there: volumes are [D,H,W], coordinates are voxel-space, and
a 3x4 affine maps OUTPUT voxel coordinates to INPUT voxel coordinates (the
pull-back convention). Sampling follows ``jax.scipy.ndimage.
map_coordinates`` with ``mode="constant"``: order 0 rounds half away from
zero (torch's ``round`` and ``grid_sample``'s nearest mode round half to
even), and order 1 sums the 8 corner terms in map_coordinates' order, each
corner outside the volume contributing 0 on its own.
"""

from __future__ import annotations

import itertools

import torch


def identity_grid(shape, device=None) -> torch.Tensor:
    """[3, D, H, W] voxel coordinate grid (f32)."""
    ranges = [torch.arange(int(s), dtype=torch.float32, device=device) for s in shape]
    return torch.stack(torch.meshgrid(*ranges, indexing="ij"))


def round_half_away(c: torch.Tensor) -> torch.Tensor:
    """Round to the nearest integer, halves away from zero (``lax.round``).
    The fractional part ``c - trunc(c)`` is exact, so halves are found
    exactly."""
    whole = c.trunc()
    frac = c - whole
    return torch.where(frac.abs() == 0.5, whole + frac.sign(), c.round())


def _nodes(coord: torch.Tensor, order: int):
    """[(index, weight)] of one axis' interpolation, as map_coordinates
    forms them."""
    if order == 0:
        return [(round_half_away(coord).long(), None)]
    lower = torch.floor(coord)
    upper_weight = coord - lower
    index = lower.long()
    return [(index, 1 - upper_weight), (index + 1, upper_weight)]


def sample_volume(vol, coords, order: int = 1) -> torch.Tensor:
    """Sample ``vol`` [D,H,W] at ``coords`` [3, ...]: order 0 nearest, 1
    trilinear, 0 outside. Returns f32 of ``coords.shape[1:]``."""
    if order not in (0, 1):
        raise ValueError("order must be 0 or 1 (got %r)" % (order,))
    vol = vol.float()
    sizes = tuple(int(s) for s in vol.shape)
    flat = vol.reshape(-1)
    axes = []
    for a in range(3):
        axes.append([(idx, (idx >= 0) & (idx < sizes[a]), w) for idx, w in _nodes(coords[a], order)])
    out = None
    for (i0, v0, w0), (i1, v1, w1), (i2, v2, w2) in itertools.product(*axes):
        lin = ((i0.clamp(0, sizes[0] - 1) * sizes[1] + i1.clamp(0, sizes[1] - 1)) * sizes[2]
               + i2.clamp(0, sizes[2] - 1))
        term = torch.where(v0 & v1 & v2, flat[lin], 0.0)
        if w0 is not None:
            term = w0 * w1 * w2 * term
        out = term if out is None else out + term
    return out


def affine_warp(vol, matrix, order: int = 1, center=None) -> torch.Tensor:
    """Resample ``vol`` through a 3x4 (or 4x4) affine: for output voxel o
    the input coordinate is A @ o + t, or A @ (o - c) + c + t about
    ``center`` c (the rotation and scaling augmentations). The output has
    ``vol``'s shape."""
    m = torch.as_tensor(matrix, dtype=torch.float32).to(vol.device)
    if m.shape == (4, 4):
        m = m[:3]
    A, t = m[:, :3], m[:, 3]
    shape = tuple(int(s) for s in vol.shape)
    grid = identity_grid(shape, vol.device).reshape(3, -1)
    if center is not None:
        c = torch.as_tensor(center, dtype=torch.float32).to(vol.device).reshape(3, 1)
        coords = A @ (grid - c) + c + t[:, None]
    else:
        coords = A @ grid + t[:, None]
    return sample_volume(vol, coords.reshape((3,) + shape), order=order)


def rotation_matrix(angles) -> torch.Tensor:
    """3D rotation matrix (f32) from per-axis angles in radians,
    R = Rx @ Ry @ Rz."""
    a = torch.as_tensor(angles, dtype=torch.float32)
    (cx, cy, cz), (sx, sy, sz) = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)

    def mat(*rows):
        return torch.stack([torch.stack(r) for r in rows])

    Rx = mat((one, zero, zero), (zero, cx, -sx), (zero, sx, cx))
    Ry = mat((cy, zero, sy), (zero, one, zero), (-sy, zero, cy))
    Rz = mat((cz, -sz, zero), (sz, cz, zero), (zero, zero, one))
    return Rx @ Ry @ Rz
