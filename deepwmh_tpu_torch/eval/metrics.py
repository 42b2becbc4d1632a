"""Voxel metrics (the port's copy of the parts of
``deepwmh_tpu.eval.metrics`` that the training pipeline and its phantom
harness use): hard Dice and voxel precision / recall, on host arrays."""

from __future__ import annotations

import numpy as np


def hard_dice_binary(a, b, threshold: float = 0.5) -> float:
    """Voxel-wise hard Dice of ``a > threshold`` and ``b > threshold``; 1.0
    when both are empty."""
    a = np.asarray(a) > threshold
    b = np.asarray(b) > threshold
    inter = np.logical_and(a, b).sum()
    denom = a.sum() + b.sum()
    if denom == 0:
        return 1.0
    return float(2.0 * inter / denom)


def voxel_precision_recall(pred, truth, threshold: float = 0.5):
    """(precision, recall) at the voxel level; each is 0.0 when its
    denominator is empty."""
    p = np.asarray(pred) > threshold
    t = np.asarray(truth) > threshold
    tp = np.logical_and(p, t).sum()
    precision = float(tp / p.sum()) if p.sum() > 0 else 0.0
    recall = float(tp / t.sum()) if t.sum() > 0 else 0.0
    return precision, recall
