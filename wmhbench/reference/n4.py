"""Frozen copy of the port's ``ops/n4.py`` for the benchmark's reference
(plain PyTorch / numpy; imports nothing of the port). Its docstring as
there:

N4 bias-field correction (port of ``deepwmh_tpu.ops.n4``).

Same algorithm, constants and order of operations: log domain at shrink
factor 2; each of 3 levels x 50 iterations sharpens the intensity histogram
by Wiener deconvolution (200 bins, FWHM 0.15, FFT), maps every voxel to
E[u|v], and fits the residual with a masked control-lattice average
interpolated by separable cubic B-splines (the lattice refines 2x per
level); the log bias is upsampled linearly and normalised to unit geometric
mean inside the mask.

Reproduced as written because they change the numbers: the histogram is
sampled at ``[::2, ::2, :]``, and E[u|v] is evaluated through a K=24
Chebyshev least-squares fit (pinv) with a Clenshaw recurrence rather than
an exact table lookup (which would drift up to ~5e-3 of the intensity
range). The triangular binning is two weighted ``index_add_`` calls in
32.32 fixed point: integer sums give the same bits in any order, while a
float ``index_add_`` on the card adds with atomics in another order each
run, which moves the predict masks between runs. The sum is the JAX
compare-reduce's to within its f32 rounding.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from wmhbench.reference.grid import linear_resize_axis

NBINS = 200
FWHM = 0.15
WIENER_NOISE = 0.01
CHEB_K = 24
FIXED_ONE = 2.0**32  # the histogram's fixed-point unit (one sample weighs <= 1)


def _cubic_bspline_weights(t):
    """The four cubic B-spline basis values for fractional offset t in [0,1)."""
    t2, t3 = t * t, t * t * t
    w0 = (1 - t) ** 3 / 6.0
    w1 = (3 * t3 - 6 * t2 + 4) / 6.0
    w2 = (-3 * t3 + 3 * t2 + 3 * t + 1) / 6.0
    w3 = t3 / 6.0
    return w0, w1, w2, w3


def _bspline_upsample_axis(c, axis: int, n_out: int):
    """Cubic B-spline with control values ``c`` (endpoint-aligned grid)
    evaluated at n_out points along ``axis``; border controls clamped."""
    n_c = c.shape[axis]
    if n_c == 1:
        return c.index_select(axis, torch.zeros(n_out, dtype=torch.long, device=c.device))
    x = torch.arange(n_out, dtype=torch.float32, device=c.device) * (
        (n_c - 1) / max(n_out - 1, 1))
    k = torch.floor(x).long().clamp(0, n_c - 2)
    t = x - k.float()
    shape = [1] * c.dim()
    shape[axis] = n_out
    out = 0.0
    for w, d in zip(_cubic_bspline_weights(t), (-1, 0, 1, 2)):
        out = out + w.view(shape) * c.index_select(axis, (k + d).clamp(0, n_c - 1))
    return out


def _smooth_field(residual, mask, n_control):
    """Masked control-lattice average + cubic B-spline interpolation."""
    shape = residual.shape
    cs = [int(math.ceil(shape[a] / n_control[a])) for a in range(3)]
    pad = []
    for a in (2, 1, 0):
        pad += [0, cs[a] * n_control[a] - shape[a]]
    cells = (n_control[0], cs[0], n_control[1], cs[1], n_control[2], cs[2])
    s = F.pad(residual * mask, pad).reshape(cells).sum(dim=(1, 3, 5))
    c = F.pad(mask, pad).reshape(cells).sum(dim=(1, 3, 5))
    out = s / torch.clamp(c, min=1.0)
    for ax in range(3):
        out = _bspline_upsample_axis(out, ax, shape[ax])
    return out


@functools.lru_cache(maxsize=4)
def _cheb_pinv(nbins: int, K: int) -> np.ndarray:
    """Least-squares projection [K+1, nbins] of a bin table onto Chebyshev
    polynomials over [-1, 1], as f32."""
    T = np.polynomial.chebyshev.chebvander(np.linspace(-1.0, 1.0, nbins), K)
    return np.linalg.pinv(T).astype(np.float32)


def _fixed(x):
    """f32 weights in [0, 1] as int64 multiples of 1 / FIXED_ONE (sums of up
    to 2^31 samples fit)."""
    return torch.round(x.double() * FIXED_ONE).long()


def _fixed_histogram(lo, w_lo, w_hi, nbins: int):
    """int64 [nbins + 1]: ``w_lo`` added into bins ``lo`` and ``w_hi`` into
    ``lo + 1`` in fixed point (the same sum in any order, so the parts of
    a sharded volume add up to the whole's bits)."""
    hist = torch.zeros(nbins + 1, dtype=torch.int64, device=lo.device)
    return hist.index_add_(0, lo, _fixed(w_lo)).index_add_(0, lo + 1, _fixed(w_hi))


def _from_fixed(hist, nbins: int):
    return (hist[:nbins].double() / FIXED_ONE).float()


def _triangular_histogram(lo, w_lo, w_hi, nbins: int):
    """f32 [nbins]: ``w_lo`` added into bins ``lo`` and ``w_hi`` into
    ``lo + 1``, summed in fixed point (the same bits in any order)."""
    return _from_fixed(_fixed_histogram(lo, w_lo, w_hi, nbins), nbins)


def _intensity_range(v, mask):
    """(vmin, vmax) of ``v`` where mask > 0.5; inf / -inf where none is."""
    sel = mask > 0.5
    return torch.where(sel, v, torch.inf).min(), torch.where(sel, v, -torch.inf).max()


def _bin_width(vmin, vmax, nbins: int):
    """The bin width over [vmin, vmax]; a constant image gets a range of one."""
    vmax = torch.where(vmax > vmin, vmax, vmin + 1.0)
    return (vmax - vmin) / (nbins - 1)


def _bin_positions(v, vmin, width, nbins: int):
    """Every voxel's bin position, clamped to [0, nbins - 1]."""
    pos = (v - vmin) / torch.clamp(width, min=1e-30)
    return pos.clamp(0.0, float(nbins - 1))


def _histogram_sample(pos, mask):
    """The quarter sample (every other D row and H column, all of W) as
    (lower bin, its weight, the upper bin's weight)."""
    pos_s = pos[::2, ::2, :].reshape(-1)
    w = mask[::2, ::2, :].reshape(-1)
    lo = torch.floor(pos_s)
    frac = pos_s - lo
    return lo.long(), w * (1.0 - frac), w * frac


def _expectation_map(hist, vmin, width, pinv, nbins=NBINS, fwhm=FWHM, noise=WIENER_NOISE):
    """Chebyshev coefficients [K + 1] of E[u|v] over the bins: the histogram
    sharpened by Wiener deconvolution with a Gaussian of the given FWHM
    (bin units), then reconvolved."""
    dev = hist.device
    pad_n = nbins * 2
    two = torch.tensor(2.0, dtype=torch.float32, device=dev)
    sigma_i = fwhm / (2.0 * torch.sqrt(2.0 * torch.log(two)))
    offs = (torch.arange(pad_n, dtype=torch.float32, device=dev) + pad_n // 2) % pad_n - pad_n // 2
    g = torch.exp(-0.5 * torch.square(offs * width / sigma_i))
    g = g / g.sum()
    Fh = torch.fft.fft(F.pad(hist, (0, pad_n - nbins)))
    G = torch.fft.fft(g)
    Fu = Fh * torch.conj(G) / (G.abs() ** 2 + noise)
    fu = torch.fft.ifft(Fu).real[:nbins].clamp_min(0.0)

    # E[u|v] = conv(G, u * f_u)(v) / conv(G, f_u)(v)
    u_bins = vmin + torch.arange(nbins, dtype=torch.float32, device=dev) * width
    num = torch.fft.ifft(torch.fft.fft(F.pad(fu * u_bins, (0, pad_n - nbins))) * G).real[:nbins]
    den = torch.fft.ifft(torch.fft.fft(F.pad(fu, (0, pad_n - nbins))) * G).real[:nbins]
    e_u = num / torch.where(den.abs() > 1e-12, den, 1e-12)
    # identity map where the density vanishes, blended smoothly
    blend = torch.clamp(den / (1e-4 * den.max() + 1e-30), 0.0, 1.0)
    e_u = blend * e_u + (1.0 - blend) * u_bins
    return pinv @ e_u


def _clenshaw(pos, coef, nbins: int = NBINS):
    """The Chebyshev fit ``coef`` evaluated at every voxel's bin position."""
    xs = pos / (nbins - 1) * 2.0 - 1.0
    b1 = torch.zeros_like(xs)
    b2 = torch.zeros_like(xs)
    for k in range(coef.shape[0] - 1, 0, -1):
        b1, b2 = coef[k] + 2.0 * xs * b1 - b2, b1
    return coef[0] + xs * b1 - b2


def _sharpen(v, mask, pinv, nbins=NBINS, fwhm=FWHM, noise=WIENER_NOISE):
    """Histogram sharpening: E[u|v] per voxel (the expected bias-free log
    intensity). ``pinv``: ``_cheb_pinv(nbins, K)`` on v's device."""
    vmin, vmax = _intensity_range(v, mask)
    width = _bin_width(vmin, vmax, nbins)
    pos = _bin_positions(v, vmin, width, nbins)
    hist = _triangular_histogram(*_histogram_sample(pos, mask), nbins)
    return _clenshaw(pos, _expectation_map(hist, vmin, width, pinv, nbins, fwhm, noise), nbins)


def _n4_core(v0, mask, levels: int, iters_per_level: int, base_control: int):
    """v0: log image at working resolution; returns the log bias field."""
    pinv = torch.from_numpy(_cheb_pinv(NBINS, CHEB_K)).to(v0.device)
    log_bias = torch.zeros_like(v0)
    for level in range(levels):
        n_c = tuple(min(base_control * (2**level) + 1, s) for s in v0.shape)
        for _ in range(iters_per_level):
            v = v0 - log_bias
            e = _sharpen(v, mask, pinv)
            residual = (v - e) * mask
            log_bias = log_bias + _smooth_field(residual, mask, n_c)
    return log_bias


def _shrink(x, s: int):
    """Average over s^3 blocks, zero-padding each axis to a multiple of s."""
    pad = []
    for a in (2, 1, 0):
        pad += [0, (-x.shape[a]) % s]
    xp = F.pad(x, pad)
    D, H, W = xp.shape
    return xp.reshape(D // s, s, H // s, s, W // s, s).mean(dim=(1, 3, 5))


def n4_bias_correction(
    data,
    mask=None,
    shrink: int = 2,
    levels: int = 3,
    iters_per_level: int = 50,
    base_control: int = 1,
    return_bias: bool = False,
):
    """Correct multiplicative bias of ``data`` [D,H,W] (positive
    intensities, f32 tensor on any device): 3 levels x 50 iterations at
    shrink factor 2 by default. Returns the corrected volume (and
    optionally the bias field normalised to unit geometric mean)."""
    data = data.float()
    eps = 1e-6
    mask_full = (data > 0).float() if mask is None else (mask > 0.5).float()
    if shrink > 1:
        small = _shrink(data, shrink)
        msmall = (_shrink(mask_full, shrink) > 0.5).float()
    else:
        small, msmall = data, mask_full

    v = torch.log(torch.clamp(small, min=eps)) * msmall
    lb = _n4_core(v, msmall, levels, iters_per_level, base_control)
    for ax in range(3):
        lb = linear_resize_axis(lb, ax, data.shape[ax])
    bias = torch.exp(lb)
    log_mean = (lb * mask_full).sum() / torch.clamp(mask_full.sum(), min=1.0)
    bias = bias / torch.exp(log_mean)
    corrected = data / torch.clamp(bias, min=1e-6)
    if return_bias:
        return corrected, bias
    return corrected
