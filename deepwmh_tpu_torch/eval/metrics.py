"""Evaluation metrics (the port of ``deepwmh_tpu.eval.metrics``): voxel
Dice and precision / recall, instance-level detection counts and F1,
per-lesion component Dice, the file-pair evaluation harnesses and the
summary.

The voxel metrics are host numpy sums. The instance metrics label
6-connected components on the device with ``ops.components.
label_components`` and count with integer bincounts there; compact ids run
1..n in ascending order of each component's minimum linear index (the JAX
package's order), and every sum is an integer, so each number equals the
JAX package's. Functions taking masks run on the mask's device when given
a tensor, else on ``device`` (CUDA unless the caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.device import resolve_device
from deepwmh_tpu_torch.ops.components import label_components
from deepwmh_tpu_torch.utils.parallel import run_parallel

METRICS = ("dice", "precision_recall", "instance_f1", "instance_precision_recall",
           "component_dice")


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


def _mask(x, threshold: float, device) -> torch.Tensor:
    """``x > threshold`` as a bool tensor on x's device (a tensor) or on
    ``device`` (host data)."""
    if torch.is_tensor(x):
        return x > threshold
    return torch.from_numpy(np.asarray(x) > threshold).to(resolve_device(device))


def _labels(m: torch.Tensor):
    """(int64 ids 0..n shaped like ``m``, n): 6-connected components of
    the bool mask numbered 1..n in ascending order of their minimum linear
    index (a root labels itself), 0 on background."""
    lbl = label_components(m).reshape(-1)
    N = lbl.numel()
    rank = torch.cumsum(lbl == torch.arange(N, device=lbl.device), 0)
    ids = torch.where(lbl < N, rank[lbl.clamp(max=N - 1)], 0)
    return ids.reshape(m.shape), int(rank[-1])


def _confusion(p, t, p_lbl, p_n, t_lbl, t_n):
    p_hit = torch.bincount(p_lbl[t], minlength=p_n + 1)[1:] > 0
    tp = int(p_hit.sum())
    t_hit = torch.bincount(t_lbl[p], minlength=t_n + 1)[1:] > 0
    return tp, p_n - tp, t_n - int(t_hit.sum())


def _f1(tp, fp, fn) -> float:
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom > 0 else 1.0


def _component_dice(t, p_lbl, p_n, t_lbl, t_n):
    """Per truth component (size, Dice) sorted by size (stable), from the
    integer overlap counts of (truth, prediction) component pairs."""
    if t_n == 0:
        return []
    size_t = torch.bincount(t_lbl.reshape(-1), minlength=t_n + 1)
    size_p = torch.bincount(p_lbl.reshape(-1), minlength=p_n + 1)
    # per predicted component: its voxels on any truth lesion
    p_on_truth = torch.bincount(p_lbl[t], minlength=p_n + 1)
    both = t & (p_lbl > 0)
    pair = t_lbl[both] * (p_n + 1) + p_lbl[both]
    uniq, counts = torch.unique(pair, return_counts=True)
    t_of, p_of = uniq // (p_n + 1), uniq % (p_n + 1)
    zeros = torch.zeros(t_n + 1, dtype=torch.int64, device=t.device)
    # |cT & cP|: cT's overlap with every predicted component touching it
    inter_t = zeros.index_add(0, t_of, counts)
    # |cP|: each touching component's full size less its voxels on other
    # truth lesions
    cp_size = zeros.index_add(0, t_of, size_p[p_of] - p_on_truth[p_of] + counts)
    inter_t, cp_size, size_t = (x.cpu().numpy() for x in (inter_t, cp_size, size_t))
    dice = 2.0 * inter_t.astype(np.float64) / np.maximum(size_t + cp_size.astype(np.float64), 1)
    out = [(int(size_t[i]), float(dice[i])) for i in range(1, t_n + 1)]
    return sorted(out, key=lambda e: e[0])


def instance_confusion(pred, truth, threshold: float = 0.5, device=None):
    """Instance-level (TP, FP, FN): a predicted component is a TP if it
    overlaps any truth voxel; a truth component is missed (FN) if no
    prediction overlaps it."""
    p, t = _mask(pred, threshold, device), _mask(truth, threshold, device)
    return _confusion(p, t, *_labels(p), *_labels(t))


def instance_f1(pred, truth, threshold: float = 0.5, device=None) -> float:
    return _f1(*instance_confusion(pred, truth, threshold, device))


def binary_component_dice(pred, truth, threshold: float = 0.5, device=None):
    """Per-truth-component Dice list, sorted by lesion size: for each truth
    lesion cT, Dice(cT, cP) where cP is the full extent of every predicted
    component overlapping cT, less the voxels of other truth lesions (the
    reference's ``cP = (mP - (yt - cT)) > 0.5``), so over-segmentation
    lowers the per-lesion Dice."""
    p, t = _mask(pred, threshold, device), _mask(truth, threshold, device)
    return _component_dice(t, *_labels(p), *_labels(t))


def evaluate_masks(pred, truth, metrics, device=None) -> dict:
    """One case's row of ``metrics`` (names of METRICS) for two host masks;
    each mask is labelled once, on ``device``, whatever the metrics."""
    if {"instance_f1", "instance_precision_recall", "component_dice"} & set(metrics):
        p, t = _mask(pred, 0.5, device), _mask(truth, 0.5, device)
        p_lab, t_lab = _labels(p), _labels(t)
    row = {}
    for m in metrics:
        if m == "dice":
            row[m] = hard_dice_binary(pred, truth)
        elif m == "precision_recall":
            row["precision"], row["recall"] = voxel_precision_recall(pred, truth)
        elif m == "instance_f1":
            row[m] = _f1(*_confusion(p, t, *p_lab, *t_lab))
        elif m == "instance_precision_recall":
            row["tp"], row["fp"], row["fn"] = _confusion(p, t, *p_lab, *t_lab)
        elif m == "component_dice":
            row[m] = _component_dice(t, *p_lab, *t_lab)
        else:
            raise ValueError("unknown metric %r" % m)
    return row


def _eval_one(pred_path, truth_path, metrics, device=None):
    pred = nifti.load_nifti_simple(pred_path)
    truth = nifti.load_nifti_simple(truth_path)
    return evaluate_masks(pred, truth, metrics, device)


class PairedEvaluation:
    """Evaluate (prediction file, truth file) pairs, serially or with a
    thread pool (the host work is gzip decompression, which releases the
    interpreter lock; the labelling runs on ``device``)."""

    def __init__(self, device=None):
        self.pairs = []
        self.device = resolve_device(device)

    def add_pair(self, name: str, pred_path: str, truth_path: str):
        self.pairs.append((name, pred_path, truth_path))

    def run(self, metrics=("dice",), num_workers: int = 1) -> dict:
        if num_workers > 1:
            rows = run_parallel(lambda args: _eval_one(args[0], args[1], metrics, self.device),
                                [(p, t) for _, p, t in self.pairs], num_workers=num_workers)
            return {name: row for (name, _, _), row in zip(self.pairs, rows)}
        return {name: _eval_one(p, t, metrics, self.device) for name, p, t in self.pairs}


class MethodEvaluation:
    """The reference experiments' evaluation harness: register named
    methods as case -> file mappings, then compare any two methods over
    the subject list with the subclass's metric. Operand order follows the
    reference: method_a is the ground truth, method_b the prediction. With
    allow_null=True a method may map a case to None, which evaluates as an
    all-background volume shaped like the other operand."""

    def _metric(self, truth, pred):  # override in subclasses
        raise NotImplementedError

    def __init__(self, subject_list, device=None):
        self.subjects = list(subject_list)
        self.methods = {}
        self.device = resolve_device(device)

    def add_method(self, name: str, path_fn):
        """path_fn: case name -> prediction/annotation file path (or None
        with allow_null)."""
        self.methods[name] = path_fn

    def get_subject_list(self):
        return list(self.subjects)

    def _eval_case(self, case, fa, fb, allow_null):
        file_a, file_b = fa(case), fb(case)
        if not allow_null and (file_a is None or file_b is None):
            raise RuntimeError(
                'subject "%s": NULL file is not allowed (allow_null=False)' % case)
        if file_a is None and file_b is None:
            raise RuntimeError('subject "%s": no valid file found for evaluation' % case)
        a = nifti.load_nifti_simple(file_a) if file_a is not None else None
        b = nifti.load_nifti_simple(file_b) if file_b is not None else None
        if a is None:
            a = np.zeros_like(b)
        if b is None:
            b = np.zeros_like(a)
        if a.shape != b.shape:
            raise RuntimeError('subject "%s": shapes not equal: %s vs %s'
                               % (case, a.shape, b.shape))
        return self._metric(a, b)

    def run_eval(self, method_a: str, method_b: str, num_workers: int = 4,
                 allow_null: bool = False):
        """Per-subject metric list of method_a (truth) vs method_b (pred)."""
        fa, fb = self.methods[method_a], self.methods[method_b]
        if num_workers > 1:
            return run_parallel(lambda case: self._eval_case(case, fa, fb, allow_null),
                                self.subjects, num_workers=num_workers)
        return [self._eval_case(c, fa, fb, allow_null) for c in self.subjects]

    # the reference's spelling
    run_eval_parallel = run_eval


class BinaryDiceEvaluation(MethodEvaluation):
    """Voxel-wise hard Dice (symmetric)."""

    def _metric(self, truth, pred):
        return hard_dice_binary(pred, truth)


class VoxelPrecisionRecallEvaluation(MethodEvaluation):
    """(precision, recall) per subject; method_a is the ground truth."""

    def _metric(self, truth, pred):
        return voxel_precision_recall(pred, truth)


class InstancePrecisionRecallEvaluation(MethodEvaluation):
    """Instance-level (TP, FP, FN) per subject; method_a is the ground
    truth."""

    def _metric(self, truth, pred):
        return instance_confusion(pred, truth, device=self.device)


class InstanceF1Evaluation(MethodEvaluation):
    """Instance-level F1 per subject; method_a is the ground truth."""

    def _metric(self, truth, pred):
        return instance_f1(pred, truth, device=self.device)


class BinaryComponentDiceEvaluation(MethodEvaluation):
    """Per-lesion (size, Dice) pairs per subject; method_a is the ground
    truth. ``eval.stats.component_dice_scatter`` plots the flattened
    result."""

    def _metric(self, truth, pred):
        return binary_component_dice(pred, truth, device=self.device)


def summarize(results: dict) -> dict:
    """Mean / std / n per metric across cases. List-valued metrics
    (component_dice rows of per-lesion (size, dice) pairs) aggregate over
    every lesion of every case: the Dice values' mean and std, n lesions."""
    keys = set()
    for row in results.values():
        keys.update(row.keys())
    out = {}
    for k in sorted(keys):
        vals = [row[k] for row in results.values() if k in row]
        if vals and isinstance(vals[0], (list, tuple)):
            dices = [d for case in vals for (_size, d) in case]
            out[k] = {"mean": float(np.mean(dices)) if dices else 0.0,
                      "std": float(np.std(dices)) if dices else 0.0,
                      "n": len(dices)}
        else:
            out[k] = {"mean": float(np.mean(vals)), "std": float(np.std(vals)), "n": len(vals)}
    return out
