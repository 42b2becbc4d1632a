"""Resampling through affine transforms and dense displacement fields (the
port of ``deepwmh_tpu.ops.warp``): training augmentation's affine warps, and
registration's field sampling and transform compositions.

Conventions as there: volumes are [D,H,W], coordinates are voxel-space, a
3x4 affine maps OUTPUT voxel coordinates to INPUT voxel coordinates (the
pull-back convention), and a displacement field is [3,D,H,W] voxel offsets
added to the identity grid. ``sample_volume`` follows ``jax.scipy.ndimage.
map_coordinates`` with ``mode="constant"``: order 0 rounds half away from
zero (torch's ``round`` and ``grid_sample``'s nearest mode round half to
even), and order 1 sums the 8 corner terms in map_coordinates' order, each
corner outside the volume contributing 0 on its own. ``sample_channels``
has its own arithmetic, that of the JAX function of the same name: floor
indices and fractions, the corners in (z, y, x) order, each term
``weight * where(valid, value, 0)`` with the weight a product of three
factors. Everything outside a volume samples as 0.
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


def sample_channels(vols, coords) -> torch.Tensor:
    """Trilinearly sample C volumes [C,D,H,W] at shared coords [3, ...] ->
    f32 [C, ...]: each of the 8 corners is one gather of all channels on
    the flattened [C, D*H*W] layout (the sampler of scaling-and-squaring,
    whose 3-channel fields are resampled at every squaring). The per-axis
    indices, validity and weight factors are formed once and combined per
    corner in the JAX function's order."""
    vols = vols.float()
    c = vols.shape[0]
    sizes = tuple(int(s) for s in vols.shape[1:])
    out_shape = tuple(coords.shape[1:])
    cf = coords.reshape(3, -1)
    lower = torch.floor(cf)
    f = cf - lower
    i0 = lower.long()
    flat = vols.reshape(c, -1)
    strides = (sizes[1] * sizes[2], sizes[2], 1)
    # per axis and offset: (clamped index * stride, inside the volume, weight)
    axes = []
    for a in range(3):
        per = []
        for off in (0, 1):
            idx = i0[a] + off if off else i0[a]
            valid = (idx >= 0) & (idx < sizes[a])
            per.append((idx.clamp(0, sizes[a] - 1) * strides[a], valid,
                        f[a] if off else 1.0 - f[a]))
        axes.append(per)
    out = None
    for (l0, v0, w0), (l1, v1, w1) in itertools.product(axes[0], axes[1]):
        l01, v01, w01 = l0 + l1, v0 & v1, w0 * w1
        for l2, v2, w2 in axes[2]:
            vals = torch.where((v01 & v2)[None, :], flat[:, l01 + l2], 0.0)
            term = (w01 * w2)[None, :] * vals
            out = term if out is None else out + term
    return out.reshape((c,) + out_shape)


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


def displacement_warp(vol, disp, order: int = 1) -> torch.Tensor:
    """Resample through a dense displacement field ``disp`` [3,D,H,W] (voxel
    offsets): out(o) = vol(o + disp(o))."""
    grid = identity_grid(disp.shape[1:], disp.device)
    return sample_volume(vol, grid + disp, order=order)


def _affine_rows(matrix, device):
    m = torch.as_tensor(matrix, dtype=torch.float32).to(device)
    if m.shape == (4, 4):
        m = m[:3]
    return m[:, :3], m[:, 3]


def compose_affine_then_disp(matrix, disp) -> torch.Tensor:
    """Pull-back composition of [affine, warp] as antsApplyTransforms
    applies them: the output voxel is displaced by the warp, then mapped
    through the affine. Returns coords [3,D,H,W] for ``sample_volume``."""
    grid = identity_grid(disp.shape[1:], disp.device)
    warped = grid + disp
    A, t = _affine_rows(matrix, disp.device)
    return (A @ warped.reshape(3, -1) + t[:, None]).reshape(warped.shape)


def compose_disp(disp_outer, disp_inner) -> torch.Tensor:
    """Compose two displacement fields: d_inner(o) + d_outer(o +
    d_inner(o)), so that warping once by the result equals warping by inner
    then outer."""
    grid = identity_grid(disp_inner.shape[1:], disp_inner.device)
    return disp_inner + sample_channels(disp_outer, grid + disp_inner)


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
