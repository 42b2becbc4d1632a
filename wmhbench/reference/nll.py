"""Frozen copy of the port's ``ops/nll.py`` for the benchmark's reference
(plain PyTorch / numpy; imports nothing of the port). Its docstring as
there:

Gaussian negative-log-likelihood anomaly scoring (port of
``deepwmh_tpu.ops.nll``).

Fit a per-voxel Gaussian over a stacked [K, D, H, W] cohort of registered
healthy references and score a volume by its NLL:

    anomaly = (x - mu)^2 / (2 sigma^2) + log(sigma * 2.506)

with sigma clamped from below, NaNs zeroed, and an optional one-sided
intensity prior ('+' keeps only hyper-intense anomalies, '-' hypo-intense).
"""

from __future__ import annotations

import torch

from wmhbench.reference.histogram import otsu_threshold
from wmhbench.reference.stats import group_mean, group_std

SQRT_2PI = 2.506  # the reference hard-codes sqrt(2*pi) ~= 2.506


def nll_from_moments(x_prime, mu, sigma, side=None):
    """The anomaly of ``x_prime`` (any shape that broadcasts against the
    moments, e.g. the [K, ...] cohort itself) under (mu, sigma)."""
    if side not in (None, "+", "-"):
        raise ValueError("side must be None, '+' or '-', got %r" % (side,))
    anomaly = torch.square(x_prime - mu) / (2.0 * torch.square(sigma)) + torch.log(
        sigma * SQRT_2PI)
    anomaly = torch.nan_to_num(anomaly, nan=0.0)
    if side == "+":
        anomaly = anomaly * (x_prime > mu).float()
    elif side == "-":
        anomaly = anomaly * (x_prime < mu).float()
    return anomaly


def nll(x_prime, x_refs, min_std=None, side=None, return_all=False, use_mask=False):
    """Voxelwise Gaussian NLL of ``x_prime`` under the cohort ``x_refs``
    [K, ...]; with ``return_all`` also the cohort's mean and clamped std.
    ``use_mask`` estimates the moments only over each reference's Otsu
    foreground."""
    if use_mask:
        thr = torch.stack([otsu_threshold(r) for r in x_refs])
        masks = (x_refs > thr.reshape((-1,) + (1,) * (x_refs.dim() - 1))).float()
        mu = group_mean(x_refs, masks=masks)
        sigma = group_std(x_refs, masks=masks)
    else:
        mu = group_mean(x_refs)
        sigma = group_std(x_refs)
    if min_std is None:
        sigma = sigma + 1e-6
    else:
        sigma = torch.where(sigma < min_std, min_std, sigma)
    anomaly = nll_from_moments(x_prime, mu, sigma, side)
    if return_all:
        return anomaly, mu, sigma
    return anomaly
