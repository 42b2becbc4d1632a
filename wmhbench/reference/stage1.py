"""One stage-1 case in plain float32 PyTorch: the benchmark's reference for
the stage-1 cells (the port's ``LesionAnalyzer`` on one case: its
``nll_analysis_core``, then the threshold segmentation and the 3 mm spark
removal).

The rough brain mask (label1 majority), z-scores, Otsu, the masked local
mean alignment of the references, the NLL anomaly of the target and of
every reference, the per-slice component filtering, the histogram curves
and the automatic threshold, the tissue vote, the 3 mm median (K2's plain
version) in the class-2 region; then ``anomaly > threshold`` and the
spark removal.

``precision="control"`` is the control: the target and references
rounded to bfloat16 on the way in and the anomaly map on the way out, the
precision one step below the float32 the analysis states.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from wmhbench.reference.components import (
    average_contiguous_labels,
    component_filtering,
    remove_3mm_sparks,
)
from wmhbench.reference.filters import median_3mm
from wmhbench.reference.grid import mean_std_grid
from wmhbench.reference.histogram import (
    auto_threshold_from_curves,
    histogram_analysis,
    otsu_threshold,
)
from wmhbench.reference.nll import nll, nll_from_moments
from wmhbench.reference.stats import SPATIAL, group_mean, z_score

PHYSICAL_PATCH_MM = 50.0
MIN_STD = 0.03


def patch_size_from_voxel(voxel_size):
    return tuple(max(int(math.ceil(PHYSICAL_PATCH_MM / float(v))), 1) for v in voxel_size)


def _fill_background(t, m_rough):
    tissue_min = torch.where(m_rough > 0.5, t, torch.inf).amin(SPATIAL, keepdim=True)
    return torch.where(m_rough < 0.5, tissue_min, t)


def _bf16(t):
    return t.to(torch.bfloat16).float()


@torch.no_grad()
def analyze(x_raw, refs_raw, label1s, label2s, voxel_size, precision: str = "f32") -> dict:
    """x_raw [D, H, W]; refs_raw, label1s, label2s [K, D, H, W], on one
    device. Returns the anomaly map, the threshold, the segmentation and
    the post-processed segmentation."""
    control = precision == "control"
    if control:
        x_raw, refs_raw = _bf16(x_raw), _bf16(refs_raw)
    K = refs_raw.shape[-4]
    num_classes = int(label2s.max()) + 1
    patch_size = patch_size_from_voxel(voxel_size)
    m_rough = (group_mean((label1s > 0.5).float()) > 0.5).float()
    m_cohort = m_rough.unsqueeze(-4)
    x = z_score(x_raw.float(), mask=m_rough)
    x_min = x.amin(SPATIAL, keepdim=True)
    otsu_thr = otsu_threshold(torch.where(m_rough < 0.5, x_min, x))
    m_valid = m_rough * (x > otsu_thr[..., None, None, None]).float()
    x = _fill_background(x, m_rough)
    refs = _fill_background(z_score(refs_raw.float(), mask=m_cohort), m_cohort)
    x_mu, _ = mean_std_grid(x, patch_size, mask=m_valid)
    refs = (refs - mean_std_grid(refs, patch_size,
                                 mask=m_valid.unsqueeze(-4).expand_as(refs))[0]
            + x_mu.unsqueeze(-4))
    anomaly, x_mean, x_std = nll(x, refs, min_std=MIN_STD, side="+", return_all=True)
    anomaly_refs = (nll_from_moments(refs, x_mean.unsqueeze(-4), x_std.unsqueeze(-4), "+")
                    * m_valid.unsqueeze(-4))
    anomaly = anomaly * component_filtering(m_valid, voxel_size)
    curve_x, _cy, _cr, curve_rs = histogram_analysis(anomaly, anomaly_refs, m_valid)
    threshold = auto_threshold_from_curves(curve_x, curve_rs)
    avg_label = average_contiguous_labels(label2s, num_classes).float()
    anomaly = anomaly * (avg_label > 0.5).float()
    cb_mask = (avg_label > 1.5) & (avg_label < 2.5)
    tissue_majority = ((label2s > 0.5).float().sum(-4) > K / 2.0).float()
    anomaly_cb = median_3mm(anomaly, voxel_size)
    anomaly = torch.where(cb_mask, anomaly_cb, anomaly) * tissue_majority
    if control:
        anomaly = _bf16(anomaly)
    thr = float(threshold)
    seg = (anomaly > thr).float()
    seg_pp = remove_3mm_sparks(seg, voxel_size)
    return {"anomaly": anomaly, "threshold": np.float32(thr), "segmentation": seg,
            "segmentation_pp": seg_pp}
