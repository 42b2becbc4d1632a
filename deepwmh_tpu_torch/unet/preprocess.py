"""Case preprocessing: resample to plan spacing, z-score, pad (port of
``deepwmh_tpu.unet.preprocess``). Volumes are f32 torch tensors [D, H, W]
on any device."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from deepwmh_tpu_torch.ops.grid import linear_resize_axis, nearest_resize_axis

SHAPE_BUCKET = 32


def _resize(data, shape, order: int):
    out = data.float()
    for ax in range(3):
        resize = nearest_resize_axis if order == 0 else linear_resize_axis
        out = resize(out, ax, int(shape[ax]))
    return out


def resample_volume(data, in_spacing, out_spacing, order: int = 1):
    """Resample [D,H,W] to a new spacing. Output shape =
    round(shape * in/out) per axis. order 0=nearest, 1=linear."""
    shape = [
        max(int(round(data.shape[ax] * float(in_spacing[ax]) / float(out_spacing[ax]))), 1)
        for ax in range(3)
    ]
    return _resize(data, shape, order)


def resample_to_shape(data, shape, order: int = 1):
    return _resize(data, shape, order)


def normalize_zscore(data):
    """Whole-volume z-score with the population std (ddof 0, as jnp.std)."""
    mu = data.mean()
    sd = torch.clamp(data.std(correction=0), min=1e-8)
    return (data - mu) / sd


def padded_shape(shape, patch_size, bucket: int = SHAPE_BUCKET):
    """At least the patch size, rounded up to the bucket multiple."""
    out = []
    for s, p in zip(shape, patch_size):
        s2 = max(int(s), int(p))
        out.append(int(math.ceil(s2 / bucket) * bucket))
    return tuple(out)


def pad_to(data, shape, value: float = 0.0):
    """Zero-pad [D,H,W] at the end of each axis up to ``shape``."""
    pads = []
    for s, t in zip(reversed(data.shape), reversed(tuple(shape))):
        pads += [0, int(t) - int(s)]
    return F.pad(data, pads, value=value)


def preprocess_case(data, spacing, plan, normalize: bool = True):
    """Resample to plan.target_spacing (linear), then z-score."""
    vol = resample_volume(data, spacing, plan.target_spacing, order=1)
    if normalize:
        vol = normalize_zscore(vol)
    return vol
