"""End-to-end accuracy harness: the whole training flow, then predict, on
a phantom cohort with known lesions (the port of ``deepwmh_tpu.eval.e2e``).

N4 -> group registration -> label propagation -> the 3-stage
self-training -> release -> install -> predict run on a cohort from
``eval/phantom.py``; the released model is scored with voxel Dice against
the exact lesion masks, on the training fit and on held-out patients the
pipeline never saw.
"""

from __future__ import annotations

import os

import numpy as np

from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.eval.metrics import hard_dice_binary, voxel_precision_recall
from deepwmh_tpu_torch.eval.phantom import (
    cohort_geometry,
    make_subject,
    phantom_header,
    write_cohort,
)


def default_e2e_budget():
    """Cut stage budgets for the phantom cohort: the reference recipe's
    semantics, 15 / 25 epochs x 20 batches at a 32^3 voxel budget."""
    from deepwmh_tpu_torch.pipeline.multistage import StageBudget

    return StageBudget(
        stage2_epochs=15,
        stage3_epochs=25,
        batches_per_epoch=20,
        batch_size=2,
        voxel_budget=32 * 32 * 32,
    )


def write_test_cases(data_dir, shape, spacing, n_ref, n_train, n_test, seed,
                     shapes=None, spacings=None, device=None):
    """Held-out patients TESTnn (seeds seed + 2000 + i, disjoint from the
    cohort's); returns ([(case, flair path)], {case: lesion GT path}).
    Cases whose two files load are kept."""
    cases, gts = [], {}
    for i in range(n_test):
        sh, sp = cohort_geometry(shape, spacing, shapes, spacings, n_ref + n_train + i)
        case = "TEST%02d" % i
        fp = os.path.join(data_dir, "%s_flair.nii.gz" % case)
        gp = os.path.join(data_dir, "%s_lesion_gt.nii.gz" % case)
        # both artifacts probed: a crash between the two saves re-saves
        if not (nifti.try_load_nifti(fp) and nifti.try_load_nifti(gp)):
            sub = make_subject(sh, seed=seed + 2000 + i, lesion=True, device=device)
            nifti.save_nifti(sub["flair"], phantom_header(sh, sp), fp)
            nifti.save_nifti(sub["lesion_gt"].astype(np.float32), phantom_header(sh, sp), gp)
        cases.append((case, fp))
        gts[case] = gp
    return cases, gts


def run_e2e_accuracy(
    work_dir,
    shape=(64, 80, 64),
    spacing=(2.0, 2.0, 2.0),
    n_ref=3,
    n_train=4,
    n_test=2,
    seed=0,
    budget=None,
    run_stages="full",
    skip_bfc=False,
    mesh=None,
    registration_mode="auto",
    learned_reg_cfg=None,
    shapes=None,
    spacings=None,
    device=None,
):
    """Run the training flow on a phantom cohort and score it. Returns
    {"stage1_dice", "trainfit_dice", "heldout_dice" {case: Dice},
    "heldout_pr" {case: (precision, recall)}, "dice" (the mean held-out
    Dice), "stage_stats" (run_train's seconds per step and stage)}; the
    held-out entries only with run_stages 'full'. Resumes from
    the artifacts under ``work_dir``. ``device``: CUDA unless the CPU is
    asked for. ``mesh``: ``run_train`` and ``run_predict`` over it."""
    from deepwmh_tpu_torch.cli.predict import run_predict
    from deepwmh_tpu_torch.cli.train import run_train
    from deepwmh_tpu_torch.unet.release import install_model

    os.makedirs(work_dir, exist_ok=True)
    data_dir = os.path.join(work_dir, "data")
    ref_csv, train_csv, gt_paths = write_cohort(
        data_dir, shape=shape, spacing=spacing, n_ref=n_ref, n_train=n_train, seed=seed,
        shapes=shapes, spacings=spacings, device=device)
    test_cases, test_gt = write_test_cases(data_dir, shape, spacing, n_ref, n_train, n_test,
                                           seed, shapes, spacings, device)

    stats = {}
    core = run_train(
        ref_csv, train_csv, os.path.join(work_dir, "train_out"),
        skip_bfc=skip_bfc,
        budget=budget or default_e2e_budget(),
        run_stages=run_stages,
        mesh=mesh,
        registration_mode=registration_mode,
        learned_reg_cfg=learned_reg_cfg,
        device=device,
        stage_stats=stats,
    )

    result = {"stage1_dice": {}, "trainfit_dice": {}, "heldout_dice": {}, "heldout_pr": {},
              "stage_stats": stats}
    for case, gp in gt_paths.items():
        gt = nifti.load_nifti_simple(gp)
        s1 = os.path.join(core, "Stage_1_initial_segmentation", case, "segmentation_pp.nii.gz")
        if os.path.isfile(s1):
            result["stage1_dice"][case] = hard_dice_binary(nifti.load_nifti_simple(s1), gt)
        fit = os.path.join(core, "Stage_3_DCNN_training", "002_training_fit", "3mm_postproc",
                           "%s.nii.gz" % case)
        if os.path.isfile(fit):
            result["trainfit_dice"][case] = hard_dice_binary(nifti.load_nifti_simple(fit), gt)

    if run_stages == "full":
        # always re-extracted: installing is cheap and validates the package
        model_dir = install_model(os.path.join(core, "Model_release", "model_release.tar.gz"),
                                  os.path.join(work_dir, "installed_model"))
        pred_dir = os.path.join(work_dir, "predict_out")
        run_predict([p for _, p in test_cases], [c for c, _ in test_cases], model_dir,
                    pred_dir, skip_bfc=skip_bfc, make_previews=False, mesh=mesh,
                    device=device)
        for case, _ in test_cases:
            pred = nifti.load_nifti_simple(os.path.join(
                pred_dir, "002_Segmentations", "003_postproc_fov", "%s.nii.gz" % case))
            gt = nifti.load_nifti_simple(test_gt[case])
            result["heldout_dice"][case] = hard_dice_binary(pred, gt)
            result["heldout_pr"][case] = voxel_precision_recall(pred, gt)
        result["dice"] = float(np.mean(list(result["heldout_dice"].values())))
    return result
