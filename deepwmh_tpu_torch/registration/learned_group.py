"""Learned group registration end to end, the VoxelMorph pathway (the port
of ``deepwmh_tpu.registration.learned_group``).

Build an affine template from the cohort, affine-align every image onto the
template grid, train one displacement-predicting network on the aligned
cohort, then register every (source, target) pair with one forward pass
and map the result back to the target's own grid. The pair artifacts are
``GroupRegistration``'s (<s>_to_<t>.nii.gz, warp.nii.gz, affine.json last),
so label propagation through ``apply_pair_transforms`` reads them as they
are. With M_i mapping template physical -> image_i physical and d the
learned template-grid displacement for (moving=s, fixed=t):

  x_t --M_t^-1--> template --(+d)--> template --M_s--> s

which factors into the [affine, warp] form with affine = M_s @ M_t^-1 and
disp_t(x) = M_t((psi + d(psi)) * sp_T) / sp_t - x, psi = the template
coordinates of x.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.core.artifacts import atomic_write_json, join_path, mkdir
from deepwmh_tpu_torch.device import resolve_device
from deepwmh_tpu_torch.ops.warp import identity_grid, sample_channels
from deepwmh_tpu_torch.parallel.mesh import barrier
from deepwmh_tpu_torch.registration.affine import (
    AffineConfig,
    apply_affine,
    invert_affine,
    spacing_tensor,
)
from deepwmh_tpu_torch.registration.group import pair_name
from deepwmh_tpu_torch.registration.learned import LearnedRegConfig, LearnedRegistration
from deepwmh_tpu_torch.registration.svf import apply_affine_svf
from deepwmh_tpu_torch.registration.template import build_affine_template


def _compose_affines(a, b) -> np.ndarray:
    """(a @ b) for 3x4 physical affines: x -> a(b(x))."""
    A = np.eye(4)
    A[:3, :] = np.asarray(a)
    B = np.eye(4)
    B[:3, :] = np.asarray(b)
    return (A @ B)[:3, :]


def _lift_core(disp_T, Minv_t, M_t, sp_T, sp_t, t_shape) -> torch.Tensor:
    """Template-grid displacement -> target-grid displacement. Tensors on
    one device; spacings f32 [3] tensors."""
    grid_t = identity_grid(tuple(int(s) for s in t_shape), disp_T.device)
    sp_t = sp_t.reshape(3, 1)
    sp_T = sp_T.reshape(3, 1)
    A, b = Minv_t[:, :3], Minv_t[:, 3]
    psi_phys = A @ (grid_t.reshape(3, -1) * sp_t) + b[:, None]
    psi_vox = (psi_phys / sp_T).reshape(grid_t.shape)
    d = sample_channels(disp_T.float(), psi_vox)
    At, bt = M_t[:, :3], M_t[:, 3]
    back_phys = At @ ((psi_vox + d).reshape(3, -1) * sp_T) + bt[:, None]
    return (back_phys / sp_t).reshape(grid_t.shape) - grid_t


def _lift_and_warp(disp_T, Minv_t, M_t, matrix, moving, sp_T, sp_t, sp_s, t_shape, order=1):
    """One pair's host-free tail: the displacement lifted to the target grid
    and the moving image resampled through [affine, warp]."""
    disp_t = _lift_core(disp_T, Minv_t, M_t, sp_T, sp_t, t_shape)
    warped = apply_affine_svf(moving, matrix, disp_t, t_shape, sp_t, sp_s, order=order)
    return warped, disp_t


def _disp_to_target_grid(disp_T, M_t, sp_T, sp_t, t_shape, device=None) -> np.ndarray:
    """Lift a template-grid displacement field into the target's own grid so
    that affine = M_s @ M_t^-1 plus this field reproduces the full chain
    (numpy in and out)."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    M_t = np.asarray(M_t)
    return _lift_core(t(disp_T), t(invert_affine(M_t)), t(M_t), spacing_tensor(sp_T, dev),
                      spacing_tensor(sp_t, dev), t_shape).cpu().numpy()


class LearnedGroupRegistration:
    """Amortised all-pairs registration: one network forward per pair.
    ``device``: CUDA unless the CPU is asked for (with ``mesh``, the mesh's
    home shard's by default). ``mesh``: the network trains data parallel
    over it (``LearnedRegistration.train(mesh=)``); the template and the
    forward passes stay on one device, as in the JAX package."""

    def __init__(self, sources, targets, output_folder, reg_cfg: LearnedRegConfig = None,
                 template_cfg: AffineConfig = None, template_spacing=(2.0, 2.0, 2.0),
                 template_iterations: int = 2, mesh=None, device=None):
        self.sources = list(sources)
        self.targets = list(targets)
        self.mesh = mesh
        self.device = resolve_device(mesh.home if device is None and mesh is not None else device)
        self.output_folder = mkdir(output_folder)
        self.reg_cfg = reg_cfg or LearnedRegConfig()
        self.template_cfg = template_cfg or AffineConfig(shrinks=(4, 2), iters=(100, 50))
        self.template_spacing = tuple(float(s) for s in template_spacing)
        self.template_iterations = template_iterations

    def pair_complete(self, s_name: str, t_name: str) -> bool:
        """Resume probe over all of a pair's artifacts (GroupRegistration's
        contract)."""
        pair = pair_name(s_name, t_name)
        pair_dir = join_path(self.output_folder, pair)
        return bool(nifti.try_load_nifti(join_path(self.output_folder, pair + ".nii.gz"))
                    and os.path.isfile(join_path(pair_dir, "affine.json"))
                    and nifti.try_load_nifti(join_path(pair_dir, "warp.nii.gz")))

    def launch(self, verbose: bool = True):
        # template and network training only when some pair is missing
        if all(self.pair_complete(s, t) for s, _ in self.sources for t, _ in self.targets):
            if verbose:
                print("all pairs already registered, nothing to do", flush=True)
            return
        dev = self.device
        cases = self.sources + self.targets
        imgs = [nifti.load_nifti_simple(path) for _, path in cases]
        spacings = [nifti.get_nifti_pixdim(path) for _, path in cases]
        img_by_name = {name: img for (name, _), img in zip(cases, imgs)}

        # 1) the affine template
        if verbose:
            print("building affine template...", flush=True)
        template, mats = build_affine_template(
            imgs, spacings=spacings, out_spacing=self.template_spacing,
            iterations=self.template_iterations, cfg=self.template_cfg, verbose=verbose,
            device=dev)
        grid_shape = template.shape
        sp_T = self.template_spacing

        # 2) the cohort aligned on the template grid
        aligned = {name: apply_affine(img, M, grid_shape, sp_T, sp, device=dev).cpu().numpy()
                   for (name, _), img, sp, M in zip(cases, imgs, spacings, mats)}
        M_by_name = {name: M for (name, _), M in zip(cases, mats)}
        sp_by_name = {name: sp for (name, _), sp in zip(cases, spacings)}

        # 3) the registration network, trained once
        if verbose:
            print("training registration network...", flush=True)
        reg = LearnedRegistration(grid_shape, self.reg_cfg, device=dev)
        reg.train(list(aligned.values()), verbose=verbose, mesh=self.mesh)
        self.reg = reg

        # 4) one forward pass per pair, GroupRegistration's artifacts (across
        # processes rank 0 registers and writes them; the others wait)
        if self.mesh is not None and not self.mesh.writer:
            barrier(self.mesh)
            return
        t_hdrs = {name: nifti.get_nifti_header(path) for name, path in self.targets}
        spT = spacing_tensor(sp_T, dev)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

        for s_name, _ in self.sources:
            for t_name, _ in self.targets:
                if self.pair_complete(s_name, t_name):
                    continue
                pair = pair_name(s_name, t_name)
                pair_dir = mkdir(join_path(self.output_folder, pair))
                if verbose:
                    print("registering %s" % pair, flush=True)
                disp_T = reg.register(aligned[t_name], aligned[s_name])
                t_vol, t_hdr = img_by_name[t_name], t_hdrs[t_name]
                sp_t = sp_by_name[t_name]
                M_t = np.asarray(M_by_name[t_name])
                matrix = _compose_affines(M_by_name[s_name], invert_affine(M_t))
                warped, disp_t = _lift_and_warp(
                    t(disp_T), t(invert_affine(M_t)), t(M_t), t(matrix), t(img_by_name[s_name]),
                    spT, spacing_tensor(sp_t, dev), spacing_tensor(sp_by_name[s_name], dev),
                    tuple(int(v) for v in t_vol.shape))
                nifti.save_nifti(warped.cpu().numpy(), t_hdr,
                                 join_path(self.output_folder, pair + ".nii.gz"))
                nifti.save_nifti_scaled_int16(np.moveaxis(disp_t.cpu().numpy(), 0, -1), t_hdr,
                                              join_path(pair_dir, "warp.nii.gz"))
                # affine.json last: the marker of a complete pair
                atomic_write_json({
                    "matrix": matrix.tolist(),
                    "fixed_spacing": [float(v) for v in sp_t],
                    "moving_spacing": [float(v) for v in sp_by_name[s_name]],
                    "fixed_shape": [int(v) for v in t_vol.shape],
                    "affine_loss": None,
                    "svf_loss": None,
                    "method": "learned",
                    # learned pairs always keep their warp
                    "deformable": True,
                    "warp_kept": True,
                }, join_path(pair_dir, "affine.json"))
        if self.mesh is not None:
            barrier(self.mesh)
