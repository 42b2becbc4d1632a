"""Registration quality on distinct anatomies (the port of
``deepwmh_tpu.registration.quality``): two independently generated phantom
subjects (``eval/phantom.py``: one base head, distinct random
diffeomorphisms and affines) registered through the full group
registration path, the source's tissue labels propagated nearest-neighbour
and scored by Dice against the target's own labels. Recovering a
deformation the package generated itself would be circular; this is not.
"""

from __future__ import annotations

import os

import numpy as np

from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.eval.metrics import hard_dice_binary
from deepwmh_tpu_torch.eval.phantom import make_subject, phantom_header


def _tissue_dice(pred_label, true_label, classes=(1, 2, 3)):
    """Per-class and mean foreground Dice between two tissue label maps."""
    per_class = {int(c): hard_dice_binary(pred_label == c, true_label == c) for c in classes}
    return per_class, float(np.mean(list(per_class.values())))


def label_propagation_quality(
    work_dir,
    mode: str = "svf",
    shape=(96, 112, 96),
    spacing=(2.0, 2.0, 2.0),
    seed_src: int = 11,
    seed_tgt: int = 12,
    seed_anchor: int = 13,
    quick: bool = True,
    large_deformation: bool = True,
    learned_cfg=None,
    subjects=None,
    device=None,
):
    """Register phantom subject A onto B ('svf': GroupRegistration;
    'learned': LearnedGroupRegistration; 'warm': GroupRegistration with a
    third anchor anatomy, so A -> B is a composed-seed warm pair), propagate
    A's labels with apply_pair_transforms and score them against B's.

    Returns {"mode", "dice_per_class", "mean_fg_dice", "unregistered_dice"
    (A's labels compared directly: the floor a registration must beat),
    "brain_dice"}. subjects: optional precomputed (A, B) make_subject
    dicts. device: CUDA unless the CPU is asked for."""
    from deepwmh_tpu_torch.registration.group import (
        GroupRegistration,
        apply_pair_transforms,
        pair_name,
    )

    if mode not in ("svf", "warm", "learned"):
        raise ValueError("mode must be 'svf', 'warm' or 'learned', got %r" % mode)
    os.makedirs(work_dir, exist_ok=True)
    hdr = phantom_header(shape, spacing)

    if subjects is not None:
        src, tgt = subjects
    else:
        src = make_subject(shape, seed=seed_src, lesion=False, device=device)
        tgt = make_subject(shape, seed=seed_tgt, lesion=False, device=device)
    paths = {}
    for name, sub in (("SRC", src), ("TGT", tgt)):
        for k in ("flair", "label2", "label1"):
            p = os.path.join(work_dir, "%s_%s.nii.gz" % (name, k))
            nifti.save_nifti(sub[k].astype(np.float32), hdr, p)
            paths[(name, k)] = p

    reg_dir = os.path.join(work_dir, "reg_%s" % mode)
    sources = [("SRC", paths[("SRC", "flair")])]
    targets = [("TGT", paths[("TGT", "flair")])]
    if mode == "learned":
        from deepwmh_tpu_torch.registration.learned_group import LearnedGroupRegistration

        LearnedGroupRegistration(sources, targets, reg_dir, reg_cfg=learned_cfg,
                                 device=device).launch(verbose=False)
    else:
        if mode == "warm":
            anch = make_subject(shape, seed=seed_anchor, lesion=False, device=device)
            anch_p = os.path.join(work_dir, "ANCH_flair.nii.gz")
            nifti.save_nifti(anch["flair"].astype(np.float32), hdr, anch_p)
            sources = [("ANCH", anch_p)] + sources
        GroupRegistration(sources, targets, reg_dir, keep_deformation=True, quick=quick,
                          large_deformation=large_deformation, warm_start=mode == "warm",
                          device=device).launch(verbose=False)

    out_l2 = os.path.join(work_dir, "prop_label2_%s.nii.gz" % mode)
    out_l1 = os.path.join(work_dir, "prop_label1_%s.nii.gz" % mode)
    apply_pair_transforms(os.path.join(reg_dir, pair_name("SRC", "TGT")),
                          [paths[("SRC", "label2")], paths[("SRC", "label1")]],
                          [out_l2, out_l1], interp="NearestNeighbor", device=device)

    prop = nifti.load_nifti_simple(out_l2).astype(np.int32)
    true = tgt["label2"].astype(np.int32)
    per_class, mean_fg = _tissue_dice(prop, true)
    _, unreg = _tissue_dice(src["label2"].astype(np.int32), true)
    brain = hard_dice_binary(nifti.load_nifti_simple(out_l1) > 0.5, tgt["label1"] > 0.5)
    return {
        "mode": mode,
        "dice_per_class": per_class,
        "mean_fg_dice": round(mean_fg, 4),
        "unregistered_dice": round(unreg, 4),
        "brain_dice": round(brain, 4),
    }
