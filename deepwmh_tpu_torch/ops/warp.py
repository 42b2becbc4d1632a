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

Both samplers and ``rotation_matrix`` also take a batch on a leading axis
(batched pair registration): volume b is sampled at its own coordinates and
reads its own voxels only.
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
    trilinear, 0 outside. Returns f32 of ``coords.shape[1:]``. A batch
    ``vol`` [B,D,H,W] with ``coords`` [B,3, ...] returns [B, ...]: volume
    b's depth index is offset by b*D, so its flat index by b*D*H*W."""
    if order not in (0, 1):
        raise ValueError("order must be 0 or 1 (got %r)" % (order,))
    vol = vol.float()
    sizes = tuple(int(s) for s in vol.shape[-3:])
    flat = vol.reshape(-1)
    batched = vol.dim() == 4
    comps = coords.unbind(1 if batched else 0)
    # per axis and node: (clamped index, inside the volume, weight)
    axes = []
    for a in range(3):
        axes.append([(idx.clamp(0, sizes[a] - 1), (idx >= 0) & (idx < sizes[a]), w)
                     for idx, w in _nodes(comps[a], order)])
    if batched:
        B = vol.shape[0]
        depth0 = (torch.arange(B, device=vol.device) * sizes[0]).view(
            (B,) + (1,) * (coords.dim() - 2))
        axes[0] = [(i + depth0, v, w) for i, v, w in axes[0]]
    out = None
    for (i0, v0, w0), (i1, v1, w1), (i2, v2, w2) in itertools.product(*axes):
        lin = (i0 * sizes[1] + i1) * sizes[2] + i2
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
    corner in the JAX function's order. A batch ``vols`` [B,C,D,H,W] with
    ``coords`` [B,3, ...] returns [B,C, ...]: a corner is one ``gather``
    along the flat [B, C, D*H*W] layout, each volume at its own indices."""
    vols = vols.float()
    lead = 1 if vols.dim() == 5 else 0
    c = vols.shape[lead]
    sizes = tuple(int(s) for s in vols.shape[-3:])
    out_shape = tuple(vols.shape[:lead + 1]) + tuple(coords.shape[lead + 1:])
    cf = coords.reshape(tuple(coords.shape[:lead + 1]) + (-1,))
    lower = torch.floor(cf)
    f = cf - lower
    i0 = lower.long()
    flat = vols.reshape(tuple(vols.shape[:lead + 1]) + (-1,))
    strides = (sizes[1] * sizes[2], sizes[2], 1)
    # per axis and offset: (clamped index * stride, inside the volume, weight)
    axes = []
    for a in range(3):
        ia, fa = i0.select(lead, a), f.select(lead, a)
        per = []
        for off in (0, 1):
            idx = ia + off if off else ia
            valid = (idx >= 0) & (idx < sizes[a])
            per.append((idx.clamp(0, sizes[a] - 1) * strides[a], valid, fa if off else 1.0 - fa))
        axes.append(per)
    if lead:
        def corner(idx, valid, weight):  # [B, M] each
            vals = flat.gather(2, idx[:, None, :].expand(-1, c, -1))
            return weight[:, None, :] * torch.where(valid[:, None, :], vals, 0.0)
    else:
        def corner(idx, valid, weight):  # [M] each
            return weight[None, :] * torch.where(valid[None, :], flat[:, idx], 0.0)
    out = None
    for (l0, v0, w0), (l1, v1, w1) in itertools.product(axes[0], axes[1]):
        l01, v01, w01 = l0 + l1, v0 & v1, w0 * w1
        for l2, v2, w2 in axes[2]:
            term = corner(l01 + l2, v01 & v2, w01 * w2)
            out = term if out is None else out + term
    return out.reshape(out_shape)


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
    offsets): out(o) = vol(o + disp(o)); a batch [B,D,H,W] through [B,3,D,H,W]."""
    grid = identity_grid(disp.shape[-3:], disp.device)
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
    R = Rx @ Ry @ Rz; angles [B, 3] give [B, 3, 3]."""
    a = torch.as_tensor(angles, dtype=torch.float32)
    (cx, cy, cz), (sx, sy, sz) = torch.cos(a).unbind(-1), torch.sin(a).unbind(-1)
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)

    def mat(*rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    Rx = mat((one, zero, zero), (zero, cx, -sx), (zero, sx, cx))
    Ry = mat((cy, zero, sy), (zero, one, zero), (-sy, zero, cy))
    Rz = mat((cz, -sz, zero), (sz, cz, zero), (zero, zero, one))
    return Rx @ Ry @ Rz
