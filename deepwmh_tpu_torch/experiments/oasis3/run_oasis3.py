"""OASIS-3 end-to-end replication recipe on PyTorch / CUDA (PARITY C13).

The port's counterpart of the JAX package's
``experiments/010_OASIS3/run_oasis3.py``, itself a rebuild of the
reference's experiment scripts (run_Siemens_Biograph_mMR.py and
run_Siemens_TrioTim.py): the hard-coded OASIS-3 cohorts (cohorts.py: 10
healthy references + 100 mMR / 50 TrioTim WMH training subjects), per-
reference T1w prep, the annotation-free training pipeline, and a two-rater
+ intra-rater Dice evaluation of the training fit with boxplot output.

Per reference subject the reference runs robustfov, FSL bet on the T1w,
flirt T1w -> FLAIR, FreeSurfer recon-all's aseg and flirt of the labels
into FLAIR space. Here, in process and on the card:

  brain mask (label1): ops.brain.brain_extract on the T1w, mapped through
      a T1w -> FLAIR MI affine (registration.affine)
  tissue prior (label2): registration.priors.propagate_atlas of a 4-class
      labeled atlas onto the T1w, mapped through the same affine

Dataset layout (the reference's):
  <OASIS3_folder>/<case>/t1w_raw.nii.gz
  <OASIS3_folder>/<case>/t2flair_raw.nii.gz
Expert annotations for the evaluation:
  <rater_dir>/<case>/rater_1.nii.gz , <rater_dir>/<case>/rater_2.nii.gz

Usage:
  python -m deepwmh_tpu_torch.experiments.oasis3.run_oasis3 \\
      --oasis3-folder /path/to/Siemens_Biograph_mMR_... \\
      --atlas-image atlas_flair.nii.gz --atlas-label atlas_label.nii.gz \\
      [--scanner mMR|TrioTim] [--output DIR] [--rater-dir DIR] \\
      [--limit-reference N] [--limit-training N] [-g i | --device cpu]

CUDA unless the CPU is asked for. ``--mesh`` / ``--no-mesh`` as
DeepWMH_train's (``cli/train.py``): by default a mesh over the visible
cards when there is more than one, which shards the pipeline's
registration pair batches and training steps.
"""

from __future__ import annotations

import argparse
import os

import torch

from deepwmh_tpu_torch.cli import train as train_cli
from deepwmh_tpu_torch.cli.group_register import add_device_args, device_from_args
from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.core.artifacts import join_path, mkdir
from deepwmh_tpu_torch.core.manifests import write_csv_simple
from deepwmh_tpu_torch.device import resolve_device
from deepwmh_tpu_torch.experiments.oasis3.cohorts import COHORTS

T1W_FILENAME = "t1w_raw.nii.gz"
T2FLAIR_FILENAME = "t2flair_raw.nii.gz"


def prepare_reference_case(
    case, t1w_path, flair_path, atlas_image_path, atlas_label_path,
    out_dir, quick=True, device=None,
):
    """T1w brain mask + atlas tissue prior, both on the FLAIR grid.

    Returns (label1_path, label2_path); idempotent (resumes from artifacts).
    """
    from deepwmh_tpu_torch.ops.brain import brain_extract
    from deepwmh_tpu_torch.registration.affine import AffineConfig, apply_affine, register_affine
    from deepwmh_tpu_torch.registration.priors import propagate_atlas

    out_dir = mkdir(out_dir)
    label1_path = join_path(out_dir, "t2flair_raw_brain_mask.nii.gz")
    label2_path = join_path(out_dir, "t2flair_raw_brain_priors.nii.gz")
    if nifti.try_load_nifti(label1_path) and nifti.try_load_nifti(label2_path):
        return label1_path, label2_path

    dev = resolve_device(device)
    t1, _ = nifti.load_nifti(t1w_path)
    flair, f_hdr = nifti.load_nifti(flair_path)
    t1_sp = nifti.get_nifti_pixdim(t1w_path)
    fl_sp = nifti.get_nifti_pixdim(flair_path)

    # 1) bet replacement: brain mask on the T1w grid
    t1_mask = brain_extract(torch.tensor(t1, device=dev), spacing=t1_sp)

    # 2) flirt replacement: T1w -> FLAIR cross-contrast MI affine
    acfg = AffineConfig(shrinks=(8, 4), iters=(100, 50)) if quick else AffineConfig()
    matrix, _ = register_affine(flair, t1, fl_sp, t1_sp, cfg=acfg, device=dev)

    label1 = apply_affine(t1_mask, matrix, flair.shape, fl_sp, t1_sp, order=0)
    nifti.save_nifti(label1.cpu().numpy(), f_hdr, label1_path)

    # 3) recon-all replacement: 4-class atlas propagation onto the T1w,
    #    then through the same affine into FLAIR space
    atlas_img = nifti.load_nifti_simple(atlas_image_path)
    atlas_lbl = nifti.load_nifti_simple(atlas_label_path)
    atlas_sp = nifti.get_nifti_pixdim(atlas_image_path)
    prior_t1, _ = propagate_atlas(
        atlas_img, atlas_lbl, t1,
        atlas_spacing=atlas_sp, subject_spacing=t1_sp, quick=quick, device=dev,
    )
    label2 = apply_affine(prior_t1, matrix, flair.shape, fl_sp, t1_sp, order=0, device=dev)
    nifti.save_nifti(label2.cpu().numpy(), f_hdr, label2_path)
    return label1_path, label2_path


def evaluate_training_fit(training_cases, fit_dir, rater_dir, output_folder, device=None):
    """Two-expert-rater + intra-rater Dice of the training fit with boxplot
    (the reference's run_Siemens_Biograph_mMR.py:266-300 and its metrics.py
    boxplot_2x). Returns the CSV's path, or None when no case is covered."""
    from deepwmh_tpu_torch.eval.metrics import BinaryDiceEvaluation
    from deepwmh_tpu_torch.eval.stats import boxplot_compare

    # rater coverage is rarely total: evaluate only cases with BOTH rater
    # files and a prediction (a missing annotation must not crash the
    # evaluation after the multi-day training run)
    covered = [
        c for c in training_cases
        if os.path.isfile(join_path(rater_dir, c, "rater_1.nii.gz"))
        and os.path.isfile(join_path(rater_dir, c, "rater_2.nii.gz"))
        and os.path.isfile(join_path(fit_dir, "%s.nii.gz" % c))
    ]
    skipped = len(training_cases) - len(covered)
    if skipped:
        print("[eval] %d case(s) lack rater/prediction files, skipped" % skipped)
    if not covered:
        print("[eval] no case has complete rater coverage; skipping evaluation")
        return None
    evaluator = BinaryDiceEvaluation(covered, device=device)
    evaluator.add_method("manual1", lambda c: join_path(rater_dir, c, "rater_1.nii.gz"))
    evaluator.add_method("manual2", lambda c: join_path(rater_dir, c, "rater_2.nii.gz"))
    evaluator.add_method("proposed", lambda c: join_path(fit_dir, "%s.nii.gz" % c))

    proposed_vs_rater1 = evaluator.run_eval("proposed", "manual1")
    proposed_vs_rater2 = evaluator.run_eval("proposed", "manual2")
    rater1_vs_rater2 = evaluator.run_eval("manual1", "manual2")

    csv_dict = {
        "case": evaluator.get_subject_list(),
        "intra-rater_variability": rater1_vs_rater2,
        "proposed_vs_rater1": proposed_vs_rater1,
        "proposed_vs_rater2": proposed_vs_rater2,
    }
    eval_csv = join_path(output_folder, "Evaluation_training_fit.csv")
    write_csv_simple(eval_csv, csv_dict)

    boxplot_png = join_path(output_folder, "Evaluation_boxplot.png")
    try:
        boxplot_compare(
            [rater1_vs_rater2, proposed_vs_rater1, proposed_vs_rater2],
            ["rater1 vs rater2", "proposed vs rater1", "proposed vs rater2"],
            boxplot_png,
            paired_pairs=[(1, 2)],
        )
    except Exception as e:  # plotting is best-effort (matplotlib may be absent)
        print("[warn] boxplot skipped: %s" % e)
    return eval_csv


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="OASIS-3 annotation-free WMH training replication "
        "(PyTorch/CUDA; reference experiments/010_OASIS3)."
    )
    ap.add_argument("--oasis3-folder", required=True,
                    help="<folder>/<case>/{t1w_raw,t2flair_raw}.nii.gz")
    ap.add_argument("--atlas-image", required=True,
                    help="Atlas intensity volume (e.g. a labeled T1 template).")
    ap.add_argument("--atlas-label", required=True,
                    help="4-class atlas labels (0 bg, 1 cerebrum, "
                    "2 cerebellum+brainstem, 3 cortex).")
    ap.add_argument("--scanner", default="mMR", choices=sorted(COHORTS))
    ap.add_argument("--output", default=None,
                    help="Output folder (default ./<experiment_name>).")
    ap.add_argument("--rater-dir", default=None,
                    help="Expert masks <case>/rater_{1,2}.nii.gz (default "
                    "./Manual_annotations/<experiment_name>).")
    ap.add_argument("--limit-reference", type=int, default=None,
                    help="Use only the first N reference subjects (quick runs).")
    ap.add_argument("--limit-training", type=int, default=None,
                    help="Use only the first N training subjects (quick runs).")
    ap.add_argument("--stage2-epochs", type=int, default=None)
    ap.add_argument("--stage3-epochs", type=int, default=None)
    ap.add_argument("--batches-per-epoch", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--skip-bfc", action="store_true")
    ap.add_argument("--mesh", action=argparse.BooleanOptionalAction, default=None,
                    help="Shard registration pair batches and training steps over all "
                    "visible cards, as DeepWMH_train's --mesh. Default: on when more "
                    "than one card is visible and neither -g nor --device is given.")
    add_device_args(ap)
    args = ap.parse_args(argv)
    device = device_from_args(ap, args)
    mesh = train_cli.mesh_from_args(ap, args)
    prep_device = mesh.home if mesh is not None else device  # the steps off the mesh

    cohort = COHORTS[args.scanner]
    refs = list(zip(cohort["reference"], cohort["reference_desc"]))
    train = list(zip(cohort["training"], cohort["training_desc"]))
    if args.limit_reference:
        refs = refs[: args.limit_reference]
    if args.limit_training:
        train = train[: args.limit_training]

    output_folder = mkdir(args.output or join_path(os.getcwd(), cohort["experiment_name"]))
    rater_dir = args.rater_dir or join_path(
        os.getcwd(), "Manual_annotations", cohort["experiment_name"]
    )

    # 1+2) per-reference prep: brain mask + tissue priors in FLAIR space
    prep_folder = mkdir(join_path(output_folder, "Reference_prep"))
    ref_rows = {"case": [], "desc": [], "flair": [], "label1": [], "label2": []}
    for case, desc in refs:
        subject = join_path(args.oasis3_folder, case)
        t1w = join_path(subject, T1W_FILENAME)
        flair = join_path(subject, T2FLAIR_FILENAME)
        if not (os.path.isfile(t1w) and os.path.isfile(flair)):
            raise SystemExit("missing %s or %s" % (t1w, flair))
        print("preparing reference %s" % case, flush=True)
        l1, l2 = prepare_reference_case(
            case, t1w, flair, args.atlas_image, args.atlas_label,
            join_path(prep_folder, case), device=prep_device,
        )
        ref_rows["case"].append(case)
        ref_rows["desc"].append(desc)
        ref_rows["flair"].append(flair)
        ref_rows["label1"].append(l1)
        ref_rows["label2"].append(l2)

    # 3+4) cohort manifests (the reference.csv / training.csv contract)
    reference_csv = join_path(output_folder, "%s_reference.csv" % cohort["experiment_name"])
    training_csv = join_path(output_folder, "%s_training.csv" % cohort["experiment_name"])
    write_csv_simple(reference_csv, ref_rows)
    write_csv_simple(training_csv, {
        "case": [c for c, _ in train],
        "desc": [d for _, d in train],
        "flair": [join_path(args.oasis3_folder, c, T2FLAIR_FILENAME) for c, _ in train],
    })

    # 5) the pipeline, in process (the reference shells out)
    from deepwmh_tpu_torch.pipeline.multistage import StageBudget

    overrides = {
        k: v for k, v in {
            "stage2_epochs": args.stage2_epochs,
            "stage3_epochs": args.stage3_epochs,
            "batches_per_epoch": args.batches_per_epoch,
            "batch_size": args.batch_size,
        }.items() if v is not None
    }
    budget = StageBudget(**overrides) if overrides else None
    core = train_cli.run_train(reference_csv, training_csv, output_folder,
                               skip_bfc=args.skip_bfc, budget=budget, mesh=mesh, device=device)

    fit_dir = join_path(core, "Stage_3_DCNN_training", "002_training_fit", "3mm_postproc")
    print("\n** Pipeline training finished; training fit in %s **" % fit_dir)

    # 6) two-rater + intra-rater evaluation
    if os.path.isdir(rater_dir):
        eval_csv = evaluate_training_fit(
            [c for c, _ in train], fit_dir, rater_dir, output_folder, device=prep_device
        )
        if eval_csv:
            print("** Evaluation saved to %s **" % eval_csv)
    else:
        print("[!] rater dir %s not found: evaluation skipped." % rater_dir)

    print("** Trained model: %s **" % join_path(core, "Model_release"))
    return output_folder


if __name__ == "__main__":
    main()
