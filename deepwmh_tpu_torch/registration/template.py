"""Groupwise affine template construction (the port of
``deepwmh_tpu.registration.template``).

The role of ANTs' antsMultivariateTemplateConstruction2.sh in the
reference's VoxelMorph pathway (rigid init, affine template, no SyN
refinement): affine-register every cohort image to the current template and
average the warped images, starting from the cohort mean on a common grid.
"""

from __future__ import annotations

import numpy as np
import torch

from deepwmh_tpu_torch.device import resolve_device
from deepwmh_tpu_torch.registration.affine import (
    AffineConfig,
    _affine_core,
    apply_affine,
    feasible_affine_cfg,
    spacing_tensor,
)


def build_affine_template(images, spacings=None, out_shape=None,
                          out_spacing=(1.0, 1.0, 1.0), iterations: int = 3,
                          cfg: AffineConfig = None, verbose: bool = True, device=None):
    """images: list of [D,H,W] arrays. Returns (template [numpy], matrices):
    matrices[i] maps template physical coords -> image i physical coords
    (the resampling transforms of the final average). The cohort is
    uploaded once; ``device``: CUDA unless the CPU is asked for."""
    dev = resolve_device(device)
    cfg = cfg or AffineConfig(shrinks=(4, 2), iters=(100, 50))
    n = len(images)
    spacings = spacings or [(1.0, 1.0, 1.0)] * n
    if out_shape is None:
        out_shape = tuple(
            int(np.median([im.shape[a] * spacings[i][a] / out_spacing[a]
                           for i, im in enumerate(images)]))
            for a in range(3))
    out_shape = tuple(int(s) for s in out_shape)
    vols = [torch.as_tensor(np.asarray(im, np.float32)).to(dev) for im in images]
    sp_out = spacing_tensor(out_spacing, dev)
    sps = [spacing_tensor(sp, dev) for sp in spacings]
    acfg = feasible_affine_cfg(cfg, out_shape)

    # init: everything resampled onto the template grid (identity transform)
    eye = np.eye(3, 4, dtype=np.float32)
    template = torch.stack([apply_affine(v, eye, out_shape, out_spacing, sp)
                            for v, sp in zip(vols, spacings)]).mean(0)

    matrices = [eye.copy() for _ in range(n)]
    for it in range(iterations):
        warped = []
        for i, v in enumerate(vols):
            mat, loss = _affine_core(template, v, sp_out, sps[i], acfg)
            matrices[i] = mat.cpu().numpy()
            warped.append(apply_affine(v, matrices[i], out_shape, out_spacing, spacings[i]))
            if verbose:
                print("template iter %d: image %d loss %.4f" % (it, i, float(loss)), flush=True)
        template = torch.stack(warped).mean(0)
    return template.cpu().numpy(), matrices
