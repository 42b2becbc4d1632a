"""Component selection and small voxel utilities (the port of
``deepwmh_tpu.ops.selection``): label once, count each component's voxels
and its voxels inside the selection with ``index_add_``, and keep
components by the rule, with no loop over components."""

from __future__ import annotations

import numpy as np
import torch

from deepwmh_tpu_torch.ops.components import label_components

SELECT_METHODS = ("window", "crossing", "masking")


def select_components(mask, selection, method: str = "crossing"):
    """Select connected components of ``mask`` [D,H,W] with a
    ``selection`` mask (tensors on one device; f32 out):

    window:   keep components entirely inside the selection
    crossing: keep components overlapping the selection anywhere
    masking:  plain voxelwise mask
    """
    if method not in SELECT_METHODS:
        raise ValueError("method must be one of %s, got %r" % (SELECT_METHODS, method))
    m = mask > 0.5
    sel = (selection > 0.5).float()
    if method == "masking":
        return (m & (sel > 0.5)).float()

    N = int(m.numel())
    flat = label_components(m).reshape(-1)
    fg = (flat < N).float()
    # per-component voxel count and in-selection count (exact in f32)
    total = torch.zeros(N + 1, dtype=torch.float32, device=m.device).index_add_(0, flat, fg)
    inside = torch.zeros(N + 1, dtype=torch.float32, device=m.device).index_add_(
        0, flat, fg * sel.reshape(-1))
    tot_v = total[flat].reshape(m.shape)
    ins_v = inside[flat].reshape(m.shape)
    if method == "window":
        keep = (ins_v == tot_v) & m
    else:  # crossing
        keep = (ins_v > 0) & m
    return keep.float()


def gaussian_noise_2x2x2(shape, noise_std, seed: int = None, rng=None):
    """2 mm-blocky Gaussian noise (numpy f32): drawn at full resolution,
    then replicated in 2x2x2 blocks and cropped. Unseeded calls draw fresh
    noise; pass ``seed`` or ``rng`` to repeat it."""
    if rng is None:
        rng = np.random.RandomState(seed) if seed is not None else np.random
    noise = rng.normal(0, noise_std, shape).astype(np.float32)
    up = np.repeat(np.repeat(np.repeat(noise, 2, 0), 2, 1), 2, 2)
    return up[: shape[0], : shape[1], : shape[2]]


def binarize_image(nii_file, threshold, save_file=None, as_type="float32"):
    """Threshold a NIfTI file; optionally save the result beside it."""
    from deepwmh_tpu_torch.core import nifti

    data, header = nifti.load_nifti(nii_file)
    data = (data > threshold).astype(as_type)
    if save_file:
        nifti.save_nifti(data, header, save_file)
    return data
