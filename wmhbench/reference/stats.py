"""Frozen copy of the port's ``ops/stats.py`` for the benchmark's reference
(plain PyTorch / numpy; imports nothing of the port). Its docstring as
there:

Masked and cohort statistics (port of ``deepwmh_tpu.ops.stats``).

The cohort ("group") ops take a stacked [K, D, H, W] tensor and keep the
reference's NaN-mask protocol: voxels with mask < 0.5 (or a non-finite
value) are left out, and a voxel left out of every member gets NaN. All
sums are f32, taken in torch's order rather than XLA's.

Every function takes a batch of cases on leading axes: the masked
statistics reduce each volume over its last three (spatial) axes, the
cohort ops reduce the K axis, the fourth from the end ([B, K, D, H, W]).
"""

from __future__ import annotations

import torch

EPS_STD = 1e-5  # the reference avoids dividing by zero with max(std, 1e-5)
SPATIAL = (-3, -2, -1)


def _volumes(t):
    """Per-volume statistics [...] broadcast back over [..., D, H, W]."""
    return t[..., None, None, None]


def masked_mean(data, mask):
    """Mean over voxels where mask > 0.5, per volume (0-dim for one)."""
    m = (mask > 0.5).to(data.dtype)
    return (data * m).sum(SPATIAL) / torch.clamp(m.sum(SPATIAL), min=1.0)


def masked_std(data, mask):
    """Population std over voxels where mask > 0.5 (two passes), per volume."""
    m = (mask > 0.5).to(data.dtype)
    cnt = torch.clamp(m.sum(SPATIAL), min=1.0)
    mu = (data * m).sum(SPATIAL) / cnt
    var = (torch.square(data - _volumes(mu)) * m).sum(SPATIAL) / cnt
    return torch.sqrt(torch.clamp(var, min=0.0))


def z_score(data, mask=None):
    """Z-score normalisation of each volume, optionally over a mask (which
    broadcasts against ``data``)."""
    if mask is None:
        mu = data.mean(SPATIAL)
        sd = data.std(SPATIAL, correction=0)
    else:
        mu = masked_mean(data, mask)
        sd = masked_std(data, mask)
    return (data - _volumes(mu)) / _volumes(torch.clamp(sd, min=EPS_STD))


def _group_moments(stack, masks):
    """Per-voxel count, mean and variance across the K axis ([..., K, D, H, W])."""
    x = stack.float()
    valid = torch.ones_like(x) if masks is None else (masks > 0.5).float()
    # NaNs already in the input are left out too, like np.nanmean
    finite = torch.isfinite(x)
    valid = valid * finite.float()
    x = torch.where(finite, x, 0.0)
    cnt = valid.sum(-4)
    denom = torch.clamp(cnt, min=1.0)
    mean = (x * valid).sum(-4) / denom
    var = (torch.square(x - mean.unsqueeze(-4)) * valid).sum(-4) / denom
    mean = torch.where(cnt > 0, mean, torch.nan)
    var = torch.where(cnt > 0, var, torch.nan)
    return cnt, mean, var


def group_mean(stack, masks=None):
    """Voxelwise mean across a [..., K, D, H, W] cohort; all-masked voxels are NaN."""
    return _group_moments(stack, masks)[1]


def group_std(stack, masks=None):
    """Voxelwise population std across a [..., K, D, H, W] cohort."""
    return torch.sqrt(_group_moments(stack, masks)[2])
