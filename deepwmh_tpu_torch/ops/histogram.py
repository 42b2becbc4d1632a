"""Histograms, Otsu thresholding, the anomaly histogram curves and the
zero-crossing auto-threshold (port of ``deepwmh_tpu.ops.histogram``).

Bin geometry follows np.histogram: values outside [lo, hi] are dropped and
x == hi lands in the last bin. Otsu keeps the first maximum. The counts are
``index_add_`` sums of 0/1 weights, exact in any order below 2**24 per bin.

A batch of cases shares one ``index_add_``: with per-row bounds lo / hi [R],
row r's samples land in bins r * nbins.. of one [R * nbins] histogram.
"""

from __future__ import annotations

import torch


def masked_histogram(x, lo, hi, nbins: int, weights=None):
    """f32 counts [nbins] of ``x`` over [lo, hi]; ``weights`` (e.g. a 0/1
    mask) multiplies each sample's contribution. With bounds lo / hi [R]
    (a row each of ``x`` [R, ...]) the counts are [R, nbins]."""
    rows = lo.dim() == 1
    if rows:
        x = x.reshape(lo.shape[0], -1).float()
        lo, hi = lo[:, None], hi[:, None]
    else:
        x = x.reshape(-1).float()
    w = torch.ones_like(x) if weights is None else weights.reshape(x.shape).float()
    width = (hi - lo) / nbins
    idx = torch.floor((x - lo) / torch.clamp(width, min=1e-30)).long()
    idx = idx.clamp(0, nbins - 1)
    w = w * ((x >= lo) & (x <= hi)).float()
    if rows:
        idx = idx + torch.arange(x.shape[0], device=x.device)[:, None] * nbins
    out = torch.zeros(idx.shape[:-1] + (nbins,), dtype=torch.float32, device=x.device)
    return out.reshape(-1).index_add_(0, idx.reshape(-1), w.reshape(-1)).reshape(out.shape)


def otsu_threshold(image, mask=None, nbins: int = 256):
    """Otsu threshold (skimage.threshold_otsu algorithm, 256 bins); with
    ``mask`` only voxels where mask > 0.5 take part. Returns a 0-d tensor;
    for a batch [B, D, H, W] one threshold a volume, [B]."""
    x = image.float()
    dims = (-3, -2, -1) if x.dim() == 4 else tuple(range(x.dim()))
    if mask is None:
        w = None
        lo = x.amin(dims)
        hi = x.amax(dims)
    else:
        m = mask > 0.5
        w = m.float()
        lo = torch.where(m, x, torch.inf).amin(dims)
        hi = torch.where(m, x, -torch.inf).amax(dims)
    hi = torch.where(hi > lo, hi, lo + 1.0)  # degenerate constant image
    counts = masked_histogram(x, lo, hi, nbins, weights=w)
    centers = _centers(lo, hi, nbins, x.device)

    weight1 = torch.cumsum(counts, -1)
    weight2 = torch.cumsum(counts.flip(-1), -1).flip(-1)
    csum = torch.cumsum(counts * centers, -1)
    mean1 = csum / torch.clamp(weight1, min=1e-30)
    csum2 = torch.cumsum((counts * centers).flip(-1), -1).flip(-1)
    mean2 = csum2 / torch.clamp(weight2, min=1e-30)
    variance12 = (weight1[..., :-1] * weight2[..., 1:]
                  * torch.square(mean1[..., :-1] - mean2[..., 1:]))
    # torch.argmax returns the first maximum, like jnp.argmax
    idx = torch.argmax(torch.nan_to_num(variance12, nan=-torch.inf), -1, keepdim=True)
    return centers.gather(-1, idx)[..., 0]


def _centers(lo, hi, nbins: int, device):
    """Bin centres [..., nbins] of bounds lo / hi [...]."""
    lo, hi = lo[..., None], hi[..., None]
    edges = lo + (hi - lo) * torch.arange(nbins + 1, dtype=torch.float32,
                                          device=device) / nbins
    return (edges[..., :-1] + edges[..., 1:]) / 2.0


def hist_curve(data, lo, hi, nbins: int, log_y: bool = False, mask=None):
    """Histogram curve over uniform bins: (bin centers, counts). With
    ``log_y`` zero counts become 0.001 before log10 and negatives are
    clamped to 0, the reference's log-scale transform. ``lo`` and ``hi``
    are numbers or 0-d tensors, or [R] tensors for the rows of ``data``
    [R, ...] (curves [R, nbins])."""
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
    per-reference log curves and r their mean. A batch of cases (a_prime
    [B, D, H, W], a_refs [B, K, D, H, W]) gives each its own bins and
    curves with a leading B; every curve of the batch is one histogram."""
    sel = (mask > 0.5).unsqueeze(-4) & (a_refs > 0)
    dims = (-3, -2, -1)
    cnt = sel.float().sum(dims)
    s = torch.where(sel, a_refs, 0.0).sum(dims)
    bin_width = (s / torch.clamp(cnt, min=1.0)).mean(-1) / 4.0
    lo = torch.zeros_like(bin_width)
    hi = nbins * bin_width
    x, y = hist_curve(a_prime, lo, hi, nbins, log_y=True)
    K = a_refs.shape[-4]
    per_ref = lambda t: t.unsqueeze(-1).expand(t.shape + (K,)).reshape(-1)
    rs = hist_curve(a_refs.reshape((-1,) + tuple(a_refs.shape[-3:])), per_ref(lo), per_ref(hi),
                    nbins, log_y=True)[1].reshape(tuple(a_refs.shape[:-3]) + (nbins,))
    return x, y, rs.mean(-2), rs


def _nanmedian(v):
    """Median of the finite entries along the last axis, the two middles
    averaged for an even count (``jnp.nanmedian``; ``torch.nanmedian``
    returns the lower one); NaN when there is none. ``torch.sort`` puts
    NaNs last, so the finite entries lead each sorted row."""
    v = torch.sort(v, -1).values
    n = (~torch.isnan(v)).sum(-1, keepdim=True)
    mid = lambda i: v.gather(-1, i.clamp(min=0))[..., 0]
    med = mid((n - 1) // 2) * 0.5 + mid(n // 2) * 0.5
    return torch.where(n[..., 0] > 0, med, torch.nan)


def auto_threshold_from_curves(curve_x, curve_rs, cutoff: float = 0.01):
    """Threshold = median over references of the last bin (bin 0 never
    counts) whose log curve exceeds ``cutoff``; references that never
    exceed it are left out. A batch (curve_x [B, nbins], curve_rs [B, K,
    nbins]) gives [B]."""
    nbins = curve_x.shape[-1]
    iota = torch.arange(nbins, device=curve_x.device)
    above = (curve_rs > cutoff) & (iota > 0)
    last_idx = torch.where(above, iota, -1).amax(-1)
    crossing = torch.where(last_idx >= 0, curve_x.gather(-1, last_idx.clamp(min=0)), torch.nan)
    return _nanmedian(crossing)
