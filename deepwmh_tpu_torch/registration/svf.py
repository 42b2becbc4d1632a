"""Diffeomorphic registration via stationary velocity fields (the port of
``deepwmh_tpu.registration.svf``).

The deformable stage that replaces the reference's ANTs SyN[0.1,3,0] with
CC: warp = exp(v) by scaling-and-squaring, loss = -LNCC(fixed, moving o
warp) + bending * |grad v|^2, Adam over a multi-resolution pyramid. The
moving image is already on the fixed grid (the affine stage resampled it);
the result is a dense displacement field in voxels on the fixed grid.

- The first-order exp gradient (``exact_exp_grad=False``) is a
  ``torch.autograd.Function`` whose backward passes the cotangent through.
  With ``exact_polish_iters`` the last iterations of each level use the
  exact gradient instead, which differentiates through ``sample_channels``'
  gathers: their backward is an accumulating scatter, so on the card those
  iterations (and all that follows them) can vary in the last bits from
  run to run, and differ from the CPU's.
- ``_smooth3`` (the Gaussian smoothing of v, replicate boundary) is one
  banded matmul per axis, the edge padding folded into the band's end rows:
  plain f32 (torch does not run f32 matmuls in TF32 by default, where a
  cuDNN depthwise convolution would), and one launch per axis.
- Every step also takes a batch of same-grid pairs on a leading axis
  (volumes [B,D,H,W], fields [B,3,D,H,W]), as the affine core does: one
  Adam loop a level, the sum of the per-pair losses differentiated, the
  last loss of each pair returned.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from deepwmh_tpu_torch.device import resolve_device
from deepwmh_tpu_torch.ops.grid import linear_resize_axis
from deepwmh_tpu_torch.ops.warp import (
    displacement_warp,
    identity_grid,
    sample_channels,
    sample_volume,
)
from deepwmh_tpu_torch.registration.affine import feasible_levels, spacing_tensor
from deepwmh_tpu_torch.registration.similarity import (
    downsample_mean,
    grad_sq,
    lncc,
    winsorize_rescale,
)
from deepwmh_tpu_torch.utils.adam import Adam


@dataclass(frozen=True)
class SVFConfig:
    shrinks: tuple = (8, 4, 2)
    iters: tuple = (120, 80, 25)
    lr: float = 0.25
    n_squaring: int = 2
    lncc_radius: int = 2
    bending_weight: float = 1.0
    smooth_sigma_vox: float = 1.0  # Gaussian smoothing of the velocity
    # True: exact autodiff through the squarings; False: the first-order
    # pass-through gradient, with the last exact_polish_iters iterations of
    # each level exact
    exact_exp_grad: bool = False
    exact_polish_iters: int = 0


def scaling_and_squaring(v, n: int = 6) -> torch.Tensor:
    """Integrate a stationary velocity field [3,D,H,W] (or a batch
    [B,3,D,H,W]): exp(v) by n squarings, each one 3-channel resample of the
    field by itself."""
    d = v / (2.0 ** n)
    grid = identity_grid(v.shape[-3:], v.device)
    for _ in range(n):
        d = d + sample_channels(d, grid + d)
    return d


class _ExpPassthrough(torch.autograd.Function):
    """exp(v) with the exact forward and the first-order VJP d(exp)/dv = I."""

    @staticmethod
    def forward(ctx, v, n):
        with torch.no_grad():
            return scaling_and_squaring(v, n)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def scaling_and_squaring_approx_grad(v, n: int = 6) -> torch.Tensor:
    """exp(v) whose gradient passes the cotangent straight through (the
    demons / log-Euclidean approximation: exact at v = 0, error O(|v|))."""
    return _ExpPassthrough.apply(v, n)


def _gauss_kernel1d(sigma) -> np.ndarray:
    r = max(int(3 * sigma), 1)
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def smooth_matrix(n: int, sigma: float, device) -> torch.Tensor:
    """[n, n] Gaussian smoothing of one axis with replicate boundary:
    row i holds the taps of i - r..i + r, those past an end on the end
    sample."""
    k = _gauss_kernel1d(sigma)
    r = (len(k) - 1) // 2
    m = np.zeros((n, n), np.float32)
    for i in range(n):
        for t in range(-r, r + 1):
            m[i, min(max(i + t, 0), n - 1)] += k[t + r]
    return torch.from_numpy(m).to(device)


def smooth_matrices(shape, sigma: float, device):
    """The three axes' smoothing matrices for a [3, *shape] field (build
    them once, outside a loop: they are copied to the device)."""
    return tuple(smooth_matrix(int(n), sigma, device) for n in shape)


def _along_axis(x, mat, axis: int) -> torch.Tensor:
    """Apply the [n, n] matrix ``mat`` along spatial ``axis`` (0, 1, 2) of
    x [..., D, H, W]: out[.., i, ..] = sum_j mat[i, j] x[.., j, ..]. The
    axis is moved last and made contiguous, then one plain 2-D product with
    every leading axis (a batch's too) folded into its rows (a batched
    product over a transposed view takes a path on the CPU that is hundreds
    of times slower)."""
    dim = x.dim() - 3 + axis
    moved = x.movedim(dim, -1).contiguous()
    out = moved.reshape(-1, moved.shape[-1]) @ mat.T
    return out.reshape(moved.shape).movedim(-1, dim)


def _smooth3(v, sigma, mats=None) -> torch.Tensor:
    """Separable Gaussian smoothing of a [..., 3,D,H,W] field (replicate
    boundary); ``mats`` from ``smooth_matrices``, built here if absent."""
    if sigma <= 0:
        return v
    if mats is None:
        mats = smooth_matrices(v.shape[-3:], sigma, v.device)
    for ax in range(3):
        v = _along_axis(v, mats[ax], ax)
    return v


def _resize_field(v, new_shape) -> torch.Tensor:
    """Linear-resize a [..., 3,D,H,W] voxel-unit field to a new grid
    ``new_shape`` (3 ints), scaling the vectors by the grid ratio."""
    out = []
    for i in range(3):
        c = v.select(-4, i)
        for ax in range(3):
            c = linear_resize_axis(c, c.dim() - 3 + ax, int(new_shape[ax]))
        out.append(c * (new_shape[i] / v.shape[-3 + i]))
    return torch.stack(out, -4)


def _optimize_svf_level(fixed, moving, v0, iters: int, lr: float, n_squaring: int,
                        lncc_radius: int, bending: float, sigma: float,
                        exact_exp_grad: bool = True):
    """``iters`` Adam steps of one level; returns (v, last loss) on the
    device, having waited for neither. A batch steps every pair on the sum
    of its losses and returns the last loss of each, [B]."""
    exp_fn = scaling_and_squaring if exact_exp_grad else scaling_and_squaring_approx_grad
    mats = smooth_matrices(v0.shape[-3:], sigma, v0.device) if sigma > 0 else None

    def loss_fn(v):
        vs = _smooth3(v, sigma, mats)
        warped = displacement_warp(moving, exp_fn(vs, n_squaring))
        return -lncc(fixed, warped, radius=lncc_radius) + bending * grad_sq(vs)

    v = v0.detach().clone()
    opt = Adam([v], lr)
    loss = torch.zeros(tuple(fixed.shape[:-3]), device=v.device)
    for _ in range(iters):
        with torch.enable_grad():
            p = v.detach().requires_grad_(True)
            loss = loss_fn(p)
            (g,) = torch.autograd.grad(loss, p, torch.ones_like(loss))
        opt.step([g])
    return v, loss.detach()


def _svf_core(fixed, moving, cfg: SVFConfig, v0=None):
    """The full deformable pyramid of one pair (winsorize, every level's
    Adam loop, final integration and upsampling) -> (disp [3,D,H,W], last
    loss) on the device; a batch [B,D,H,W] -> ([B,3,D,H,W], [B]).

    v0: optional [3, D', H', W'] initial velocity (voxel units, any grid,
    resized to the coarsest level): the warm start's first-order seed,
    exp(v) ~= v for smooth post-affine fields (registration/warm.py)."""
    fixed = winsorize_rescale(fixed)
    moving = winsorize_rescale(moving)

    v = None
    lead = tuple(fixed.shape[:-3])
    loss = torch.zeros(lead, device=fixed.device)
    for shrink, iters in zip(cfg.shrinks, cfg.iters):
        f = downsample_mean(fixed, shrink)
        m = downsample_mean(moving, shrink)
        grid = tuple(f.shape[-3:])
        if v is None:
            v = (torch.zeros(lead + (3,) + grid, device=f.device) if v0 is None
                 else _resize_field(v0.float(), grid))
        else:
            v = _resize_field(v, grid)
        polish = 0 if cfg.exact_exp_grad else min(int(cfg.exact_polish_iters), int(iters))
        schedule = [(int(iters) - polish, bool(cfg.exact_exp_grad))]
        if polish:
            schedule.append((polish, True))
        for n_it, exact in schedule:
            if n_it <= 0:
                continue
            v, loss = _optimize_svf_level(
                f, m, v, iters=n_it, lr=float(cfg.lr), n_squaring=int(cfg.n_squaring),
                lncc_radius=int(cfg.lncc_radius), bending=float(cfg.bending_weight),
                sigma=float(cfg.smooth_sigma_vox), exact_exp_grad=exact,
            )

    v = _smooth3(v, cfg.smooth_sigma_vox)
    disp_small = scaling_and_squaring(v, cfg.n_squaring)
    return _resize_field(disp_small, fixed.shape[-3:]), loss


def _feasible_cfg(cfg: SVFConfig, shape) -> SVFConfig:
    shr, its = feasible_levels(cfg.shrinks, cfg.iters, shape)
    return dataclasses.replace(cfg, shrinks=tuple(shr), iters=tuple(its))


def register_svf(fixed, moving, cfg: SVFConfig = None, device=None):
    """fixed/moving on the SAME grid. Returns (disp [3,D,H,W] numpy, voxel
    units, final loss): moving o (id + disp) ~= fixed. Runs on CUDA unless
    ``device`` asks for the CPU."""
    dev = resolve_device(device)
    cfg = _feasible_cfg(cfg or SVFConfig(), np.shape(fixed))
    disp, loss = _svf_core(torch.as_tensor(np.asarray(fixed, np.float32)).to(dev),
                           torch.as_tensor(np.asarray(moving, np.float32)).to(dev), cfg)
    return disp.cpu().numpy(), float(loss)


def register_svf_batch(fixed_stack, moving_stack, cfg: SVFConfig = None, device=None):
    """B same-grid pairs as one batch through the core (one Adam loop a
    level for all B). Returns (disp [B,3,D,H,W], losses [B]) as numpy."""
    dev = resolve_device(device)
    cfg = _feasible_cfg(cfg or SVFConfig(), np.shape(fixed_stack)[1:])
    disp, losses = _svf_core(torch.as_tensor(np.asarray(fixed_stack, np.float32)).to(dev),
                             torch.as_tensor(np.asarray(moving_stack, np.float32)).to(dev), cfg)
    return disp.cpu().numpy(), losses.cpu().numpy()


def apply_affine_svf(moving, matrix, disp, fixed_shape, fixed_spacing, moving_spacing,
                     order: int = 1) -> torch.Tensor:
    """Resample ``moving`` (its own grid) through [affine, warp] like
    antsApplyTransforms -t affine -t warp: the output voxel is displaced by
    the warp on the fixed grid, then mapped through the physical affine into
    the moving volume. Tensors on one device; spacings as numbers or f32
    [3] tensors. A batch: ``moving`` [B, ...], ``matrix`` [B,3,4], ``disp``
    [B,3, ...]."""
    dev = disp.device
    fixed_shape = tuple(int(s) for s in fixed_shape)
    fsp = _as_spacing(fixed_spacing, dev).reshape(3, 1)
    msp = _as_spacing(moving_spacing, dev).reshape(3, 1)
    matrix = torch.as_tensor(matrix, dtype=torch.float32).to(dev)
    A, t = matrix[..., :3], matrix[..., 3]
    warped_vox = identity_grid(fixed_shape, dev) + disp.float()
    lead = tuple(warped_vox.shape[:-4])
    mov_phys = A @ (warped_vox.reshape(lead + (3, -1)) * fsp) + t[..., None]
    mov_vox = (mov_phys / msp).reshape(lead + (3,) + fixed_shape)
    return sample_volume(moving, mov_vox, order=order)


def _as_spacing(spacing, device) -> torch.Tensor:
    return spacing.float() if torch.is_tensor(spacing) else spacing_tensor(spacing, device)
