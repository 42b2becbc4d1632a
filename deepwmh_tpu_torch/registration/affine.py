"""Multi-resolution rigid + affine registration by gradient descent (the port
of ``deepwmh_tpu.registration.affine``).

The Rigid[0.1] + Affine[0.1] stages of the reference's ANTs command (MI with
32 bins, winsorized intensities): each pyramid level is an Adam loop over a
differentiable MI (or LNCC) loss. Here a level is a Python loop of eager
steps (``utils/adam.py``) that never waits for the device: the loop reads no
value back, and only the last step's loss is returned, as a tensor.

Conventions: the transform maps FIXED physical coordinates to MOVING
physical coordinates (the pull-back convention of ITK/ANTs), physical =
voxel * spacing. Rigid stage: rotation angles + translation about the fixed
image's centre of mass; affine stage: a full 3x3 perturbation initialised
from the rigid fit, at half the learning rate.

The core also takes a batch of same-geometry pairs on a leading axis
([B,D,H,W] volumes, shared spacings; the port of JAX's ``vmap`` of the
core): one Adam loop a level for all B pairs, [B, n] parameters with an
optimiser state each, the differentiated loss the sum of the per-pair
losses (so pair b's gradient is its own loss'), every reduction and every
size rule per pair. A level returns the last step's loss of each pair, [B].
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from deepwmh_tpu_torch.device import resolve_device
from deepwmh_tpu_torch.ops.warp import identity_grid, rotation_matrix, sample_volume
from deepwmh_tpu_torch.registration.similarity import (
    downsample_mean,
    lncc,
    mutual_information,
    winsorize_rescale,
)
from deepwmh_tpu_torch.utils.adam import Adam


@dataclass(frozen=True)
class AffineConfig:
    metric: str = "mi"  # 'mi' or 'lncc'
    mi_bins: int = 32
    lncc_radius: int = 4
    shrinks: tuple = (8, 4, 2)
    iters: tuple = (150, 80, 40)
    lr: float = 0.05
    do_rigid: bool = True
    do_affine: bool = True
    # MI sampling (the reference's MI 0.25 sampling): only every
    # sample_stride-th fixed voxel is resampled and binned
    sample_stride: int = 4


def spacing_tensor(spacing, device) -> torch.Tensor:
    """f32 [3] spacing on ``device`` (one small copy: keep it out of loops)."""
    return torch.as_tensor(np.asarray(spacing, np.float32)).to(device)


def _phys_grid(shape, spacing) -> torch.Tensor:
    """[3, D, H, W] physical coordinates; ``spacing`` an f32 [3] tensor."""
    return identity_grid(shape, spacing.device) * spacing.reshape(3, 1, 1, 1)


def resample_moving(moving, matrix, fixed_shape, fixed_spacing, moving_spacing, order=1):
    """Resample ``moving`` onto the fixed grid through a physical 3x4 affine
    (fixed phys -> moving phys); spacings are f32 [3] tensors. A batch:
    ``moving`` [B, ...] through ``matrix`` [B, 3, 4]."""
    A, t = matrix[..., :3], matrix[..., 3]
    grid = _phys_grid(fixed_shape, fixed_spacing).reshape(3, -1)
    mov_vox = (A @ grid + t[..., None]) / moving_spacing.reshape(3, 1)
    return sample_volume(moving, mov_vox.reshape(tuple(matrix.shape[:-2]) + (3,)
                                                 + tuple(fixed_shape)), order=order)


def _params_to_matrix(params, center, mode: str) -> torch.Tensor:
    """mode 'rigid': params = [3 angles, 3 trans]; mode 'affine': params =
    [9 linear perturbation, 3 trans], composed about ``center``. A batch:
    params [B, n] and centers [B, 3] give [B, 3, 4]."""
    if mode == "rigid":
        R = rotation_matrix(params[..., :3])
        t = params[..., 3:6]
    else:
        R = torch.eye(3, device=params.device) + params[..., :9].reshape(
            tuple(params.shape[:-1]) + (3, 3))
        t = params[..., 9:12]
    # x_mov = R @ (x_fix - c) + c + t
    offset = center - (R @ center[..., None])[..., 0] + t
    return torch.cat([R, offset[..., None]], dim=-1)


def _center_of_mass(x, spacing) -> torch.Tensor:
    """[3] physical centre of mass of x [D,H,W]; [B, 3] of a batch."""
    g = _phys_grid(x.shape[-3:], spacing)
    w = torch.clamp(x, min=0.0)
    dims = (-3, -2, -1)
    total = torch.clamp(w.sum(dims), min=1e-8)
    return torch.stack([(g[i] * w).sum(dims) / total for i in range(3)], -1)


def _optimize_level(fixed, moving, fixed_spacing, moving_spacing, params0, center,
                    mode: str, iters: int, lr: float, metric: str, mi_bins: int,
                    lncc_radius: int, sample_stride: int = 1):
    """``iters`` Adam steps of one pyramid level; returns (params, last
    loss), both on the device, having waited for neither. A batch
    (``fixed`` [B,D,H,W]) steps every pair at once on the sum of its
    losses and returns the last loss of each, [B]."""
    batch = fixed.dim() == 4
    shape = tuple(fixed.shape[-3:])
    if metric == "mi" and sample_stride > 1:
        # strided voxel sampling: the moving image is resampled and the
        # joint histogram binned only at every sample_stride-th fixed voxel
        grid_phys = _phys_grid(shape, fixed_spacing).reshape(3, -1)[:, ::sample_stride]
        fixed_samp = fixed.reshape(tuple(fixed.shape[:-3]) + (-1,))[..., ::sample_stride]
        msp = moving_spacing.reshape(3, 1)

        def loss_fn(params):
            mat = _params_to_matrix(params, center, mode)
            A, t = mat[..., :3], mat[..., 3]
            vals = sample_volume(moving, (A @ grid_phys + t[..., None]) / msp)
            return -mutual_information(fixed_samp, vals, nbins=mi_bins, batch=batch)
    else:
        def loss_fn(params):
            mat = _params_to_matrix(params, center, mode)
            warped = resample_moving(moving, mat, shape, fixed_spacing, moving_spacing)
            if metric == "mi":
                return -mutual_information(fixed, warped, nbins=mi_bins, batch=batch)
            return -lncc(fixed, warped, radius=lncc_radius)

    params = params0.detach().clone()
    opt = Adam([params], lr)
    loss = torch.zeros(tuple(fixed.shape[:-3]), device=params.device)
    for _ in range(iters):
        with torch.enable_grad():
            p = params.detach().requires_grad_(True)
            loss = loss_fn(p)
            # the gradient of the sum of a batch's losses: each pair's own
            (g,) = torch.autograd.grad(loss, p, torch.ones_like(loss))
        opt.step([g])
    return params, loss.detach()


def feasible_levels(shrinks, iters, shape, min_dim: int = 8):
    """Drop pyramid levels too coarse for this volume (each level must keep
    every axis >= min_dim); always keep at least the finest requested.
    ``shape`` is one pair's."""
    out_s, out_i = [], []
    for s, it in zip(shrinks, iters):
        if min(shape) // s >= min_dim:
            out_s.append(s)
            out_i.append(it)
    if not out_s:
        out_s, out_i = [1], [iters[-1]]
    return tuple(out_s), tuple(out_i)


def _affine_core(fixed, moving, fsp, msp, cfg: AffineConfig):
    """The full rigid + affine pyramid of one pair: winsorize, centre-of-mass
    init, every level's Adam loop. Tensors on one device, spacings f32 [3];
    returns (3x4 matrix, last loss) on the device. A batch of pairs
    [B,D,H,W] returns ([B,3,4], [B])."""
    fixed = winsorize_rescale(fixed)
    moving = winsorize_rescale(moving)

    center = _center_of_mass(fixed, fsp)
    com_m = _center_of_mass(moving, msp)

    lead = tuple(center.shape[:-1])
    rigid_params = torch.cat([torch.zeros(lead + (3,), device=fixed.device), com_m - center], -1)
    affine_params = None
    final_loss = torch.zeros(lead, device=fixed.device)

    stages = (["rigid"] if cfg.do_rigid else []) + (["affine"] if cfg.do_affine else [])
    if not stages:
        raise ValueError("AffineConfig with do_rigid=False and do_affine=False optimizes "
                         "nothing; enable at least one stage")
    for mode in stages:
        if mode == "affine":
            if affine_params is None:
                R = rotation_matrix(rigid_params[..., :3])
                affine_params = torch.cat([(R - torch.eye(3, device=R.device)).reshape(lead + (9,)),
                                           rigid_params[..., 3:6]], -1)
            params = affine_params
        else:
            params = rigid_params

        for shrink, iters in zip(cfg.shrinks, cfg.iters):
            f = downsample_mean(fixed, shrink)
            m = downsample_mean(moving, shrink)
            # keep at least ~4k samples so coarse levels don't starve the
            # 32x32 joint histogram (one pair's voxels, batch or not)
            stride = (cfg.sample_stride if math.prod(f.shape[-3:]) // cfg.sample_stride >= 4096
                      else 1)
            params, final_loss = _optimize_level(
                f, m, fsp * shrink, msp * shrink, params, center,
                mode=mode, iters=int(iters),
                lr=float(cfg.lr) if mode == "rigid" else float(cfg.lr) * 0.5,
                metric=cfg.metric, mi_bins=cfg.mi_bins, lncc_radius=cfg.lncc_radius,
                sample_stride=int(stride),
            )
        if mode == "rigid":
            rigid_params = params
        else:
            affine_params = params

    mode = stages[-1]
    params = affine_params if mode == "affine" else rigid_params
    return _params_to_matrix(params, center, mode), final_loss


def feasible_affine_cfg(cfg: AffineConfig, shape) -> AffineConfig:
    """Clamp the pyramid to the levels this volume supports (min dim 8)."""
    shr, its = feasible_levels(cfg.shrinks, cfg.iters, shape)
    return dataclasses.replace(cfg, shrinks=tuple(shr), iters=tuple(its))


def _volume(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32)).to(device)


def register_affine(fixed, moving, fixed_spacing=(1.0, 1.0, 1.0),
                    moving_spacing=(1.0, 1.0, 1.0), cfg: AffineConfig = None, device=None):
    """Returns (3x4 numpy matrix, final loss): fixed phys -> moving phys.
    Runs on CUDA unless ``device`` asks for the CPU."""
    dev = resolve_device(device)
    cfg = feasible_affine_cfg(cfg or AffineConfig(), np.shape(fixed))
    mat, loss = _affine_core(_volume(fixed, dev), _volume(moving, dev),
                             spacing_tensor(fixed_spacing, dev),
                             spacing_tensor(moving_spacing, dev), cfg)
    return mat.cpu().numpy(), float(loss)


def register_affine_batch(fixed_stack, moving_stack, fixed_spacing=(1.0, 1.0, 1.0),
                          moving_spacing=(1.0, 1.0, 1.0), cfg: AffineConfig = None,
                          device=None):
    """B same-geometry (fixed, moving) pairs with shared spacings as one
    batch through the core (one Adam loop a level for all B). Returns
    (matrices [B,3,4], losses [B]) as numpy."""
    dev = resolve_device(device)
    cfg = feasible_affine_cfg(cfg or AffineConfig(), np.shape(fixed_stack)[1:])
    mats, losses = _affine_core(_volume(fixed_stack, dev), _volume(moving_stack, dev),
                                spacing_tensor(fixed_spacing, dev),
                                spacing_tensor(moving_spacing, dev), cfg)
    return mats.cpu().numpy(), losses.cpu().numpy()


def apply_affine(moving, matrix, fixed_shape, fixed_spacing, moving_spacing, order=1,
                 device=None) -> torch.Tensor:
    """Resample any volume (image order=1 / label order=0) through a saved
    affine (the antsApplyTransforms role). ``moving`` may be a tensor, whose
    device is then used; otherwise ``device`` (CUDA unless the CPU is asked
    for)."""
    dev = moving.device if torch.is_tensor(moving) else resolve_device(device)
    moving = moving.float() if torch.is_tensor(moving) else _volume(moving, dev)
    return resample_moving(moving, torch.as_tensor(np.asarray(matrix, np.float32)).to(dev),
                           tuple(int(s) for s in fixed_shape), spacing_tensor(fixed_spacing, dev),
                           spacing_tensor(moving_spacing, dev), order=order)


def invert_affine(matrix) -> np.ndarray:
    m = np.eye(4)
    m[:3, :] = np.asarray(matrix)
    return np.linalg.inv(m)[:3, :]
