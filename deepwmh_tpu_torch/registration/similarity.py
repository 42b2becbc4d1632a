"""Differentiable registration similarity metrics (the port of
``deepwmh_tpu.registration.similarity``).

Mattes-style mutual information with a soft (triangular Parzen window)
joint histogram for the rigid and affine stages, local normalised
cross-correlation for the deformable stage, the pyramid's mean-pool shrink
and the fields' squared-difference regulariser.

- The joint histogram is ``W_a @ W_b^T`` in f32: the triangular weight of
  sample n in bin k is relu(1 - |p_n - k|), the two-bin linear split
  written densely. It is one deterministic matmul (a scatter-add split
  would vary in its last bits on the card) and gradients flow to both
  images. The samples are few (at most 1/4 of a 48x56x48 level), so the
  [nbins, N] weights are formed whole.
- LNCC's local sums are separable zero-bounded box sums of 2r+1 taps over
  the stacked moments, added tap after tap in window order: the same bits
  as the JAX package's ``reduce_window`` (the variance terms cancel, so
  another order moves LNCC by ~2e-5). The box sum is its own adjoint, so
  its backward is the same sums over the cotangent, axes in reverse. No
  cumsum differences, which lose f32 precision on large sums.
- The clips and ReLUs are ``torch.maximum`` / ``minimum``, whose gradient
  splits evenly at ties as ``jnp.maximum``'s does, and |x| has ``lax.abs``'
  gradient +1 at 0: winsorized volumes hold many exact 0s and 1s (exact
  bin centres), and Adam's first steps follow the gradient's sign.
- The quantiles of ``winsorize_rescale`` are ``jnp.quantile``'s linear
  interpolation between two order statistics taken with ``kthvalue``
  (``torch.quantile`` refuses inputs above 2^24 elements).
- Every function also takes a batch of pairs on a leading axis (volumes
  [B,D,H,W], fields [B,C,D,H,W]; ``batch=True`` where the input may have
  any shape) and reduces pair by pair: each pair's quantiles, histogram
  normaliser and means are its own, and a size read for a rule is one
  pair's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _order_stat_weights(n: int, q: float):
    """(lower index, upper index, lower weight, upper weight) of the q
    quantile of n values, in f32 as ``jnp.quantile`` forms them (n itself
    in f32, which rounds above 2^24)."""
    last = np.float32(n) - np.float32(1)
    pos = np.float32(q) * last
    lo, hi = np.floor(pos), np.ceil(pos)
    w_hi = np.float32(pos - lo)
    w_lo = np.float32(1.0) - w_hi
    lo, hi = (int(min(max(v, np.float32(0)), last)) for v in (lo, hi))
    return min(lo, n - 1), min(hi, n - 1), float(w_lo), float(w_hi)


def quantile(x, q: float, batch: bool = False) -> torch.Tensor:
    """The q quantile of all of ``x`` with linear interpolation (0-dim f32);
    with ``batch``, of each x[b] ([B] f32)."""
    flat = x.reshape(x.shape[:1] + (-1,) if batch else (-1,)).float()
    lo, hi, w_lo, w_hi = _order_stat_weights(flat.shape[-1], q)
    v_lo = torch.kthvalue(flat, lo + 1, dim=-1).values
    v_hi = v_lo if hi == lo else torch.kthvalue(flat, hi + 1, dim=-1).values
    return v_lo * w_lo + v_hi * w_hi


def winsorize_rescale(x, lo_q=0.005, hi_q=0.995) -> torch.Tensor:
    """Clip to the [0.5%, 99.5%] intensity quantiles and rescale to [0,1]
    (the reference's --winsorize-image-intensities [0.005,0.995]); a batch
    [B,D,H,W] pair by pair."""
    x = x.float()
    batch = x.dim() == 4
    lo = quantile(x, lo_q, batch)
    hi = quantile(x, hi_q, batch)
    hi = torch.where(hi > lo, hi, lo + 1.0)
    if batch:
        lo, hi = lo.view(-1, 1, 1, 1), hi.view(-1, 1, 1, 1)
    return torch.clamp((x - lo) / (hi - lo), 0.0, 1.0)


def _clip01(x) -> torch.Tensor:
    """``jnp.clip(x, 0, 1)``: minimum(maximum(x, 0), 1), ties splitting the
    gradient."""
    zero = x.new_zeros(())
    return torch.minimum(torch.maximum(x, zero), zero + 1.0)


def _abs(x) -> torch.Tensor:
    """|x| with ``lax.abs``' gradient: +1 at 0 (torch's is 0 there)."""
    return torch.where(x >= 0, x, -x)


def soft_joint_histogram(a, b, nbins: int = 32, mask=None, batch: bool = False) -> torch.Tensor:
    """Normalised differentiable joint histogram p_ab [nbins, nbins] of two
    [0,1] volumes (module docstring); with ``batch``, [B, nbins, nbins]
    from one batched product, each pair normalised by its own sum."""
    lead = tuple(a.shape[:1]) if batch else ()
    a = a.reshape(lead + (-1,))
    b = b.reshape(lead + (-1,))
    pa = _clip01(a) * (nbins - 1)
    pb = _clip01(b) * (nbins - 1)
    bins = torch.arange(nbins, dtype=torch.float32, device=a.device)
    zero = a.new_zeros(())
    wa = torch.maximum(zero, 1.0 - _abs(pa[..., None, :] - bins[:, None]))
    wb = torch.maximum(zero, 1.0 - _abs(pb[..., None, :] - bins[:, None]))
    if mask is not None:
        wb = wb * mask.reshape(lead + (-1,)).float()[..., None, :]
    hist = wa @ wb.transpose(-1, -2)
    return hist / torch.clamp(hist.sum((-2, -1), keepdim=True), min=1e-8)


def mutual_information(a, b, nbins: int = 32, mask=None, batch: bool = False) -> torch.Tensor:
    """MI(a, b) >= 0, higher = better aligned; with ``batch``, [B]."""
    p_ab = soft_joint_histogram(a, b, nbins, mask, batch)
    p_a = p_ab.sum(-1, keepdim=True)
    p_b = p_ab.sum(-2, keepdim=True)
    eps = 1e-10
    return (p_ab * (torch.log(p_ab + eps) - torch.log(p_a + eps) - torch.log(p_b + eps))).sum(
        (-2, -1))


def _box_axis(x, radius: int, dim: int) -> torch.Tensor:
    """Window sum of 2r+1 taps along ``dim``, zero outside, the taps added
    in window order."""
    n = x.shape[dim]
    xp = F.pad(x, [0, 0] * (x.dim() - dim - 1) + [radius, radius])
    out = xp.narrow(dim, 0, n)
    for j in range(1, 2 * radius + 1):
        out = out + xp.narrow(dim, j, n)
    return out


class _BoxSums(torch.autograd.Function):
    """Separable box sums over the last three axes; the backward is the
    same operator (it is symmetric) over the axes in reverse order."""

    @staticmethod
    def forward(ctx, x, radius):
        ctx.radius = radius
        for dim in range(x.dim() - 3, x.dim()):
            x = _box_axis(x, radius, dim)
        return x

    @staticmethod
    def backward(ctx, ct):
        for dim in reversed(range(ct.dim() - 3, ct.dim())):
            ct = _box_axis(ct, ctx.radius, dim)
        return ct, None


def box_sums(x, radius: int) -> torch.Tensor:
    """Separable box-filter sums with zero boundary (window 2r+1) over the
    last three axes of x [..., D, H, W]."""
    return _BoxSums.apply(x, radius)


def lncc(a, b, radius: int = 4, eps: float = 1e-5) -> torch.Tensor:
    """Local normalised cross-correlation (ANTs CC metric): the mean of the
    squared local correlation, in [0, 1]; higher = better aligned. A batch
    [B,D,H,W] gives [B]."""
    n, sa, sb, saa, sbb, sab = box_sums(
        torch.stack([torch.ones_like(a), a, b, a * a, b * b, a * b]), radius)
    ma = sa / n
    mb = sb / n
    cross = sab - mb * sa - ma * sb + ma * mb * n
    var_a = saa - 2 * ma * sa + ma * ma * n
    var_b = sbb - 2 * mb * sb + mb * mb * n
    cc = (cross * cross) / (var_a * var_b + eps)
    return cc.mean((-3, -2, -1))


def downsample_mean(x, factor: int) -> torch.Tensor:
    """Mean-pool a [..., D,H,W] volume by an integer factor (zero-padding
    the remainder): the pyramid shrink of the affine and SVF stages."""
    if factor <= 1:
        return x
    s = factor
    d, h, w = (int(v) for v in x.shape[-3:])
    xp = F.pad(x, (0, (-w) % s, 0, (-h) % s, 0, (-d) % s))
    D, H, W = (int(v) // s for v in xp.shape[-3:])
    return xp.reshape(tuple(xp.shape[:-3]) + (D, s, H, s, W, s)).mean((-5, -3, -1))


def grad_sq(v) -> torch.Tensor:
    """Mean squared forward differences over the spatial axes of a
    [C,D,H,W] field, summed over the axes (the SVF stage's and the learned
    loss' regulariser); a batch [B,C,D,H,W] gives [B]."""
    total = 0.0
    for ax in (-3, -2, -1):
        total = total + torch.diff(v, dim=ax).square().mean((-4, -3, -2, -1))
    return total
