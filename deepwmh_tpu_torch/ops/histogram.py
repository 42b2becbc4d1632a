"""Histograms and Otsu thresholding (port of ``deepwmh_tpu.ops.histogram``'s
``masked_histogram`` and ``otsu_threshold``).

Bin geometry follows np.histogram: values outside [lo, hi] are dropped and
x == hi lands in the last bin. Otsu keeps the first maximum.
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
