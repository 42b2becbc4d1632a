"""Histograms, Otsu thresholding, the anomaly histogram curves and the
zero-crossing auto-threshold (port of ``deepwmh_tpu.ops.histogram``).

Bin geometry follows np.histogram: values outside [lo, hi] are dropped and
x == hi lands in the last bin. Otsu keeps the first maximum. The counts are
``index_add_`` sums of 0/1 weights, exact in any order below 2**24 per bin.
"""

from __future__ import annotations

import torch


def masked_histogram(x, lo, hi, nbins: int, weights=None):
    """f32 counts [nbins] of ``x`` over [lo, hi]; ``weights`` (e.g. a 0/1
    mask) multiplies each sample's contribution."""
    x = x.reshape(-1).float()
    w = torch.ones_like(x) if weights is None else weights.reshape(-1).float()
    width = (hi - lo) / nbins
    idx = torch.floor((x - lo) / torch.clamp(width, min=1e-30)).long()
    idx = idx.clamp(0, nbins - 1)
    w = w * ((x >= lo) & (x <= hi)).float()
    return torch.zeros(nbins, dtype=torch.float32, device=x.device).index_add_(0, idx, w)


def otsu_threshold(image, mask=None, nbins: int = 256):
    """Otsu threshold (skimage.threshold_otsu algorithm, 256 bins); with
    ``mask`` only voxels where mask > 0.5 take part. Returns a 0-d tensor."""
    x = image.float()
    if mask is None:
        w = None
        lo = x.min()
        hi = x.max()
    else:
        m = mask > 0.5
        w = m.float()
        lo = torch.where(m, x, torch.inf).min()
        hi = torch.where(m, x, -torch.inf).max()
    hi = torch.where(hi > lo, hi, lo + 1.0)  # degenerate constant image
    counts = masked_histogram(x, lo, hi, nbins, weights=w)
    edges = lo + (hi - lo) * torch.arange(nbins + 1, dtype=torch.float32,
                                          device=x.device) / nbins
    centers = (edges[:-1] + edges[1:]) / 2.0

    weight1 = torch.cumsum(counts, 0)
    weight2 = torch.cumsum(counts.flip(0), 0).flip(0)
    csum = torch.cumsum(counts * centers, 0)
    mean1 = csum / torch.clamp(weight1, min=1e-30)
    csum2 = torch.cumsum((counts * centers).flip(0), 0).flip(0)
    mean2 = csum2 / torch.clamp(weight2, min=1e-30)
    variance12 = weight1[:-1] * weight2[1:] * torch.square(mean1[:-1] - mean2[1:])
    # torch.argmax returns the first maximum, like jnp.argmax
    idx = torch.argmax(torch.nan_to_num(variance12, nan=-torch.inf))
    return centers[idx]


def _centers(lo, hi, nbins: int, device):
    edges = lo + (hi - lo) * torch.arange(nbins + 1, dtype=torch.float32,
                                          device=device) / nbins
    return (edges[:-1] + edges[1:]) / 2.0


def hist_curve(data, lo, hi, nbins: int, log_y: bool = False, mask=None):
    """Histogram curve over uniform bins: (bin centers, counts). With
    ``log_y`` zero counts become 0.001 before log10 and negatives are
    clamped to 0, the reference's log-scale transform. ``lo`` and ``hi``
    are numbers or 0-d tensors."""
    lo, hi = (torch.as_tensor(v, dtype=torch.float32, device=data.device) for v in (lo, hi))
    w = None if mask is None else (mask > 0.5).float()
    hist = masked_histogram(data, lo, hi, nbins, weights=w)
    if log_y:
        hist = torch.log10(torch.where(hist == 0, 0.001, hist))
        hist = torch.where(hist < 0, 0.0, hist)
    return _centers(lo, hi, nbins, data.device), hist


def histogram_analysis(a_prime, a_refs, mask, nbins: int = 400):
    """Anomaly histogram curves with automatic bins: bin width = the mean
    over references of mean(a_ref[mask & a_ref > 0]) / 4, bins over
    [0, nbins * width]. Returns (x, y, r, rs), rs the [K, nbins] stack of
    per-reference log curves and r their mean."""
    sel = (mask > 0.5)[None] & (a_refs > 0)
    dims = tuple(range(1, a_refs.dim()))
    cnt = sel.float().sum(dims)
    s = torch.where(sel, a_refs, 0.0).sum(dims)
    bin_width = (s / torch.clamp(cnt, min=1.0)).mean() / 4.0
    lo = torch.zeros((), dtype=torch.float32, device=a_prime.device)
    hi = nbins * bin_width
    x, y = hist_curve(a_prime, lo, hi, nbins, log_y=True)
    rs = torch.stack([hist_curve(r, lo, hi, nbins, log_y=True)[1] for r in a_refs])
    return x, y, rs.mean(0), rs


def _nanmedian(v):
    """Median of the finite entries, the two middles averaged for an even
    count (``jnp.nanmedian``; ``torch.nanmedian`` returns the lower one);
    NaN when there is none."""
    v = torch.sort(v[~torch.isnan(v)]).values
    n = v.numel()
    if n == 0:
        return torch.full((), torch.nan, dtype=torch.float32, device=v.device)
    return v[(n - 1) // 2] * 0.5 + v[n // 2] * 0.5


def auto_threshold_from_curves(curve_x, curve_rs, cutoff: float = 0.01):
    """Threshold = median over references of the last bin (bin 0 never
    counts) whose log curve exceeds ``cutoff``; references that never
    exceed it are left out."""
    nbins = curve_x.shape[0]
    iota = torch.arange(nbins, device=curve_x.device)
    above = (curve_rs > cutoff) & (iota[None, :] > 0)
    last_idx = torch.where(above, iota[None, :], -1).amax(1)
    crossing = torch.where(last_idx >= 0, curve_x[last_idx.clamp(min=0)], torch.nan)
    return _nanmedian(crossing)
