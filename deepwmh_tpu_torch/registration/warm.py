"""SVF warm start (the port of ``deepwmh_tpu.registration.warm``): seed a
pair's deformable stage from the composition of already-registered pairs.

With an anchor source s0, the pairs (s0, t) and the auxiliary pairs
(s_i, s0) compose into an estimate of every remaining pair (s_i, t):

  T_{i,t}(x) = T_{i,0}( T_{0,t}(x) )

which, converted to a velocity to first order (exp(v) ~= v for smooth
post-affine fields) and clipped to +-24 voxels, seeds the SVF pyramid on a
shortened schedule (``warm_schedule``). Opt-in: ``GroupRegistration(
warm_start=True)`` / ``--svf-warm-start``.

Conventions as ``registration/group.py``'s artifacts: a pair's ``matrix``
maps FIXED physical -> MOVING physical, its ``warp`` is a voxel-unit
displacement on the fixed grid applied BEFORE the affine.
"""

from __future__ import annotations

import dataclasses

import torch

from deepwmh_tpu_torch.ops.warp import identity_grid, sample_channels
from deepwmh_tpu_torch.registration.affine import _affine_core, resample_moving
from deepwmh_tpu_torch.registration.svf import _svf_core, apply_affine_svf


def warm_schedule(cfg, frac: float = 0.4, floor: int = 20):
    """The per-level iterations of a warm-started pair: ``frac`` of the
    cold schedule, at least ``floor``."""
    return dataclasses.replace(
        cfg, iters=tuple(max(floor, int(round(i * frac))) for i in cfg.iters))


def compose_pair_displacement(d0t, di0, mat0t, mati0, mat_it, sp_t, sp_s0, t_shape):
    """Displacement (voxel units, t grid, pre-affine convention) of the
    composed map T_{i,0} o T_{0,t} expressed against the pair's own affine
    mat_it, i.e. the d with mat_it o (x + d(x)) landing where the
    composition lands:

      x (t vox) --d0t,mat0t--> y (s0 vox) --di0,mati0--> r (s_i phys)
      d(x) = mat_it^{-1}(r) / sp_t - x

    Tensors on one device; spacings f32 [3] tensors."""
    t_shape = tuple(int(s) for s in t_shape)
    grid = identity_grid(t_shape, d0t.device)
    sp_t = sp_t.reshape(3, 1)
    sp_s0 = sp_s0.reshape(3, 1)
    A0t, b0t = mat0t[:, :3], mat0t[:, 3]
    Ai0, bi0 = mati0[:, :3], mati0[:, 3]
    Ait, bit = mat_it[:, :3], mat_it[:, 3]

    p = (grid + d0t).reshape(3, -1) * sp_t  # t phys, warped
    y = ((A0t @ p + b0t[:, None]) / sp_s0).reshape((3,) + t_shape)  # s0 vox
    z = y + sample_channels(di0, y)  # s0 vox, warped
    r = Ai0 @ (z.reshape(3, -1) * sp_s0) + bi0[:, None]  # s_i phys
    x2 = torch.linalg.solve(Ait, r - bit[:, None]) / sp_t
    return x2.reshape((3,) + t_shape) - grid


def warm_pair_core(fixed, moving, fsp, msp, d0t, di0, mat0t, mati0, sp_s0, acfg, scfg):
    """One warm pair: a fresh affine pyramid (cheap, and independent of an
    anchor failure), the composed displacement as the velocity seed, the
    shortened SVF, the final [affine, warp] resample. Same output tuple as
    ``group._pair_core``: (matrix, affine loss, disp f16, SVF loss, warped
    f16), on the device."""
    fixed = fixed.float()
    moving = moving.float()
    mat, aff_loss = _affine_core(fixed, moving, fsp, msp, acfg)
    moving_on_fixed = resample_moving(moving, mat, fixed.shape, fsp, msp, order=1)
    v0 = compose_pair_displacement(d0t.float(), di0.float(), mat0t, mati0, mat, fsp,
                                   sp_s0, fixed.shape)
    # outside the head the anchor, auxiliary and pair affines disagree
    # freely (nothing pinned them); clip the seed to the large-deformation
    # scale so a wild background vector cannot start the optimiser in a fold
    v0 = torch.clamp(v0, -24.0, 24.0)
    disp, svf_loss = _svf_core(fixed, moving_on_fixed, scfg, v0=v0)
    warped = apply_affine_svf(moving, mat, disp, fixed.shape, fsp, msp, order=1)
    return mat, aff_loss, disp.half(), svf_loss, warped.half()
