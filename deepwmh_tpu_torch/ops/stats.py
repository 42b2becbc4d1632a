"""Masked and cohort statistics (port of ``deepwmh_tpu.ops.stats``).

The cohort ("group") ops take a stacked [K, D, H, W] tensor and keep the
reference's NaN-mask protocol: voxels with mask < 0.5 (or a non-finite
value) are left out, and a voxel left out of every member gets NaN. All
sums are f32, taken in torch's order rather than XLA's.
"""

from __future__ import annotations

import torch

EPS_STD = 1e-5  # the reference avoids dividing by zero with max(std, 1e-5)


def masked_mean(data, mask):
    """Mean over voxels where mask > 0.5."""
    m = (mask > 0.5).to(data.dtype)
    return (data * m).sum() / torch.clamp(m.sum(), min=1.0)


def masked_std(data, mask):
    """Population std over voxels where mask > 0.5 (two passes)."""
    m = (mask > 0.5).to(data.dtype)
    cnt = torch.clamp(m.sum(), min=1.0)
    mu = (data * m).sum() / cnt
    var = (torch.square(data - mu) * m).sum() / cnt
    return torch.sqrt(torch.clamp(var, min=0.0))


def z_score(data, mask=None):
    """Z-score normalisation, optionally over a mask."""
    if mask is None:
        mu = data.mean()
        sd = data.std(correction=0)
    else:
        mu = masked_mean(data, mask)
        sd = masked_std(data, mask)
    return (data - mu) / torch.clamp(sd, min=EPS_STD)


def _group_moments(stack, masks):
    """Per-voxel count, mean and variance across the leading K axis."""
    x = stack.float()
    valid = torch.ones_like(x) if masks is None else (masks > 0.5).float()
    # NaNs already in the input are left out too, like np.nanmean
    finite = torch.isfinite(x)
    valid = valid * finite.float()
    x = torch.where(finite, x, 0.0)
    cnt = valid.sum(0)
    denom = torch.clamp(cnt, min=1.0)
    mean = (x * valid).sum(0) / denom
    var = (torch.square(x - mean) * valid).sum(0) / denom
    mean = torch.where(cnt > 0, mean, torch.nan)
    var = torch.where(cnt > 0, var, torch.nan)
    return cnt, mean, var


def group_mean(stack, masks=None):
    """Voxelwise mean across a [K, ...] cohort; all-masked voxels are NaN."""
    return _group_moments(stack, masks)[1]


def group_std(stack, masks=None):
    """Voxelwise population std across a [K, ...] cohort."""
    return torch.sqrt(_group_moments(stack, masks)[2])
