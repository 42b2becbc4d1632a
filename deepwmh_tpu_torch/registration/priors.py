"""Anatomical tissue priors by atlas propagation (the port of
``deepwmh_tpu.registration.priors``).

In place of the FreeSurfer recon-all aseg pathway of the reference's
experiments: register a labelled atlas (the 4-class scheme 0 background,
1 cerebrum, 2 cerebellum + brainstem, 3 cortex) to each subject with the
affine + SVF registration and carry the labels across (nearest neighbour).
Also the exact FreeSurfer-aseg id remap of the reference's
convert_FreeSurfer_aseg, and a procedural atlas (numpy, bit-equal to the
JAX package's). Unlike the group path, the inputs are not rounded to f16.
"""

from __future__ import annotations

import numpy as np
import torch

from deepwmh_tpu_torch.device import resolve_device
from deepwmh_tpu_torch.registration.affine import (
    AffineConfig,
    _affine_core,
    feasible_affine_cfg,
    resample_moving,
    spacing_tensor,
)
from deepwmh_tpu_torch.registration.svf import (
    SVFConfig,
    _feasible_cfg,
    _svf_core,
    apply_affine_svf,
)

# FreeSurfer aseg ids -> the 4-class scheme
ASEG_CEREBELLUM_BRAINSTEM = (7, 8, 46, 47, 15, 16)
ASEG_CORTEX = (3, 42)


def convert_freesurfer_aseg(aseg: np.ndarray) -> np.ndarray:
    """aseg parcellation -> {0 bg, 1 cerebrum, 2 cerebellum+brainstem,
    3 cortex}."""
    aseg = np.around(np.asarray(aseg)).astype(np.int32)
    out = np.zeros_like(aseg)
    out[aseg > 0] = 1
    for i in ASEG_CEREBELLUM_BRAINSTEM:
        out[aseg == i] = 2
    for i in ASEG_CORTEX:
        out[aseg == i] = 3
    return out


def propagate_atlas(atlas_image, atlas_label, subject_image, atlas_spacing=(1.0, 1.0, 1.0),
                    subject_spacing=(1.0, 1.0, 1.0), quick: bool = False,
                    deformable: bool = True, device=None):
    """Register atlas -> subject; returns (label_on_subject, brain_mask) as
    numpy: the atlas' classes (nearest neighbour) and label > 0.5.
    ``device``: CUDA unless the CPU is asked for."""
    dev = resolve_device(device)
    if quick:
        a_cfg = AffineConfig(shrinks=(8, 4), iters=(100, 50))
        s_cfg = SVFConfig(shrinks=(4,), iters=(80,))
    else:
        a_cfg = AffineConfig()
        s_cfg = SVFConfig()

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    fixed, moving, label = t(subject_image), t(atlas_image), t(atlas_label)
    fsp, msp = spacing_tensor(subject_spacing, dev), spacing_tensor(atlas_spacing, dev)
    shape = tuple(fixed.shape)
    matrix, _ = _affine_core(fixed, moving, fsp, msp, feasible_affine_cfg(a_cfg, shape))
    if deformable:
        moving_on_fixed = resample_moving(moving, matrix, shape, fsp, msp)
        disp, _ = _svf_core(fixed, moving_on_fixed, _feasible_cfg(s_cfg, shape))
        out = apply_affine_svf(label, matrix, disp, shape, fsp, msp, order=0)
    else:
        out = resample_moving(label, matrix, shape, fsp, msp, order=0)
    out = out.cpu().numpy()
    return out, (out > 0.5).astype(np.float32)


def synthetic_atlas(shape=(96, 112, 96), spacing=(2.0, 2.0, 2.0), seed=0):
    """Procedural 4-class brain atlas (image, label) in the reference's
    priors scheme (0 background, 1 cerebrum, 2 cerebellum + brainstem,
    3 cerebral cortex): an ellipsoidal head whose outer ~15% shell is cortex,
    a lower-posterior lobe and a central-inferior stem as class 2, the rest
    cerebrum; each tissue a FLAIR-like level with smooth modulation and light
    noise. A stand-in that makes the priors pipeline runnable from the
    repository alone."""
    rng = np.random.RandomState(seed)
    zz, yy, xx = np.meshgrid(*[np.linspace(-1.0, 1.0, s) for s in shape], indexing="ij")
    r = np.sqrt((zz / 0.82) ** 2 + (yy / 0.92) ** 2 + (xx / 0.78) ** 2)
    brain = r < 1.0
    label = np.zeros(shape, np.int16)
    label[brain] = 1
    label[brain & (r > 0.85)] = 3
    cb = np.sqrt(((zz + 0.45) / 0.38) ** 2 + ((yy + 0.55) / 0.42) ** 2
                 + (xx / 0.5) ** 2) < 1.0
    bs = (np.sqrt((yy * 0.0 + xx) ** 2 + (yy + 0.35) ** 2) < 0.14) & (zz > 0.1) & (zz < 0.75)
    label[brain & (cb | bs)] = 2

    levels = {0: 0.0, 1: 210.0, 2: 190.0, 3: 160.0}
    image = np.zeros(shape, np.float32)
    for k, v in levels.items():
        image[label == k] = v
    image *= 1.0 + 0.12 * np.cos(2.5 * zz) * np.cos(1.8 * yy)
    image += (rng.rand(*shape).astype(np.float32) - 0.5) * 6.0 * (label > 0)
    return image.astype(np.float32), label.astype(np.float32)
