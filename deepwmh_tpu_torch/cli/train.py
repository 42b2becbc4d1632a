"""DeepWMH_train on the GPU: ``python -m deepwmh_tpu_torch.cli.train``.

  -s reference.csv   (case, desc, flair, label1, label2)
  -t training.csv    (case, desc, flair)
  -o output          working folder
  [-r release]       model release folder
  [--core-folder]    pipeline state folder (default <output>/004_WMH_pipeline)
  [-g i | --device cpu]

The flow and artifacts of ``deepwmh_tpu.cli.train``: N4 of every FLAIR
(001_Preprocessed) -> every healthy reference registered onto every
training subject (002_Registration, with regsource.csv / regtarget.csv and
run_registration.sh, which names ``python -m
deepwmh_tpu_torch.cli.group_register``) -> label propagation, nearest
neighbour (003_Transformed) -> the 3-stage self-training pipeline -> the
model release. Every phase resumes from its artifacts. ``--distributed
a/b`` registers one shard of the pairs, for machines sharing the output
folder; the run stops with exit code 2 until every pair is done.

It runs on CUDA (``-g i`` picks ``cuda:i``); the CPU only with ``--device
cpu``. With more than one card visible (on this process, or over the
processes of a run joined by the ``DEEPWMH_COORDINATOR`` /
``DEEPWMH_NUM_PROCESSES`` / ``DEEPWMH_PROCESS_ID`` contract) the run takes a
device mesh over them: registration pair batches (``--batch-pairs``, raised
to the mesh size) and the training steps are sharded over it. ``-g`` and
``--device`` turn the automatic mesh off; ``--mesh`` / ``--no-mesh`` force
the choice (``--mesh`` needs a card and excludes ``-g`` / ``--device``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from deepwmh_tpu_torch.cli.group_register import add_device_args, device_from_args
from deepwmh_tpu_torch.cli.integrity import check_system_integrity
from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.core.artifacts import join_path, mkdir
from deepwmh_tpu_torch.core.manifests import check_dataset, load_csv_simple, write_csv_simple
from deepwmh_tpu_torch.device import resolve_device
from deepwmh_tpu_torch.parallel.mesh import make_mesh

def n4_preprocess_cases(cases, flairs, out_folder, skip_bfc=False, device=None,
                        pinned=False):
    """N4-correct every FLAIR into <out>/<case>.nii.gz (cases whose output
    loads are skipped). ``pinned``: the run was pinned to one card."""
    from deepwmh_tpu_torch.ops.n4 import n4_bias_correction_auto

    dev = resolve_device(device)
    out_paths = {}
    for case, flair in zip(cases, flairs):
        out_path = join_path(out_folder, "%s.nii.gz" % case)
        out_paths[case] = out_path
        if nifti.try_load_nifti(out_path):
            continue
        print("N4: %s" % case, flush=True)
        data, hdr = nifti.load_nifti(flair)
        if not skip_bfc:
            data = n4_bias_correction_auto(torch.from_numpy(data).to(dev),
                                           pinned=pinned).cpu().numpy()
        nifti.save_nifti(data, hdr, out_path)
    return out_paths


def registration_command(source_csv, target_csv, registration_folder, mode,
                         quick_registration, large_deformation, svf_warm_start=False):
    """The recovery / sharding command written into run_registration.sh.
    The preset flags and --svf-warm-start belong to the svf mode (the
    registration CLI refuses them with --learned), so the command carries
    the mode the run selected."""
    return (
        "python -m deepwmh_tpu_torch.cli.group_register -s '%s' -t '%s' -o '%s' "
        "--keep-deformation%s"
        % (
            source_csv, target_csv, registration_folder,
            " --learned" if mode == "learned" else (
                (" --allow-quick-registration" if quick_registration else "")
                + (" --allow-large-deformations" if large_deformation else "")
                + (" --svf-warm-start" if svf_warm_start else "")
            ),
        )
    )


SH_HEADER_WARM = (
    "#!/bin/sh\n"
    "# This command carries --svf-warm-start: it must run on a\n"
    "# SINGLE machine (warm pairs compose the anchor row's\n"
    "# artifacts, which --distributed k/n cannot shard). To spread\n"
    "# it over machines sharing this filesystem instead, drop\n"
    "# --svf-warm-start and add --distributed k/n on each shard.\n"
)
SH_HEADER = (
    "#!/bin/sh\n"
    "# Distribute registration over machines sharing this filesystem by\n"
    "# running shard k of n on each: add --distributed k/n\n"
    "# (per-pair sharding applies to the svf mode; --learned trains\n"
    "#  one shared network on a single host instead)\n"
)


def run_train(
    reference_csv,
    training_csv,
    output_folder,
    core_folder=None,
    release_folder=None,
    skip_bfc=False,
    quick_registration=True,
    large_deformation=True,
    budget=None,
    run_stages="full",
    distributed=None,
    batch_pairs=1,
    mesh=None,
    registration_mode="auto",
    learned_reg_cfg=None,
    svf_warm_start=False,
    device=None,
    stage_stats=None,
):
    """The whole training flow; returns the pipeline's core folder.

    quick_registration / large_deformation both default on (the reference
    training command's registration preset). registration_mode: 'svf' (every
    pair optimised), 'learned' (one network, a forward a pair) or 'auto'
    (``registration/policy.py``). learned_reg_cfg: a LearnedRegConfig for
    the learned mode (None: the production one). svf_warm_start: seed the
    svf pairs from the anchor row's composition (``registration/warm.py``).
    device: CUDA unless the CPU is asked for (with ``mesh``, the mesh's
    home shard's by default). mesh: a ``parallel.mesh.Mesh``; the svf
    pairs go through ``register_pairs_mesh`` in chunks of at least the mesh
    size (the warm-start schedule stays serial on one device), the learned
    network and every pipeline Trainer train data parallel over it, and
    stage I deals its cases over it. stage_stats: a dict that receives the
    seconds (and on a card the peak memory) of each step that runs: "n4",
    "registration", "label_propagation", then the pipeline's stages and the
    release."""
    from deepwmh_tpu_torch.pipeline.multistage import (
        PipelineMultistage,
        StageBudget,
        timed_stage,
    )
    from deepwmh_tpu_torch.registration.group import (
        GroupRegistration,
        apply_pair_transforms,
        pair_name,
    )
    from deepwmh_tpu_torch.registration.policy import select_registration_mode

    # --distributed shards a pair list; the learned mode trains one shared
    # network, so two hosts would duplicate it and race on its artifacts
    if registration_mode == "learned" and distributed is not None:
        raise SystemExit(
            "--registration-mode learned cannot be combined with "
            "--distributed a/b: the learned mode trains ONE shared network "
            "(nothing to shard). Drop --distributed, or use "
            "--registration-mode svf/auto."
        )
    if svf_warm_start:
        # warm pairs compose the anchor row's svf artifacts (no learned
        # artifacts, no sharding across machines)
        if registration_mode == "learned":
            raise SystemExit(
                "--svf-warm-start is an svf-mode schedule; it cannot be "
                "combined with --registration-mode learned."
            )
        if distributed is not None:
            raise SystemExit(
                "--svf-warm-start pairs depend on the anchor row's "
                "artifacts, which --distributed a/b cannot shard. Drop one "
                "of the two flags."
            )
        if registration_mode == "auto":
            registration_mode = "svf"
    dev = resolve_device(mesh.home if device is None and mesh is not None else device)
    stats = {} if stage_stats is None else stage_stats

    # absolute paths: regsource/regtarget.csv and run_registration.sh are
    # run by other machines from any working directory
    output_folder = mkdir(os.path.abspath(output_folder))
    core_folder = mkdir(core_folder or join_path(output_folder, "004_WMH_pipeline"))
    release_folder = mkdir(release_folder or join_path(core_folder, "Model_release"))

    reference_dataset = load_csv_simple(
        reference_csv, key_names=["case", "desc", "flair", "label1", "label2"])
    training_dataset = load_csv_simple(training_csv, key_names=["case", "desc", "flair"])
    if not check_dataset(reference_dataset) or not check_dataset(training_dataset):
        raise SystemExit(1)
    # both cohorts share one preprocessing folder keyed by case name
    overlap = set(reference_dataset["case"]) & set(training_dataset["case"])
    if overlap:
        raise SystemExit(
            "case name(s) appear in BOTH reference and training CSVs: %s — "
            "rename one side." % sorted(overlap)
        )
    print("reference cases: %d, training cases: %d"
          % (len(reference_dataset["case"]), len(training_dataset["case"])))

    # 001: N4
    preproc_folder = mkdir(join_path(output_folder, "001_Preprocessed"))
    pinned = device is not None
    with timed_stage(stats, "n4", dev):
        ref_paths = n4_preprocess_cases(reference_dataset["case"], reference_dataset["flair"],
                                        preproc_folder, skip_bfc, device=dev, pinned=pinned)
        train_paths = n4_preprocess_cases(training_dataset["case"], training_dataset["flair"],
                                          preproc_folder, skip_bfc, device=dev, pinned=pinned)

    # 002: group registration (every reference onto every training subject)
    registration_folder = mkdir(join_path(output_folder, "002_Registration"))
    S = [(c, ref_paths[c]) for c in reference_dataset["case"]]
    T = [(c, train_paths[c]) for c in training_dataset["case"]]
    write_csv_simple(join_path(output_folder, "regsource.csv"), {
        "case": reference_dataset["case"],
        "data": [ref_paths[c] for c in reference_dataset["case"]]})
    write_csv_simple(join_path(output_folder, "regtarget.csv"), {
        "case": training_dataset["case"],
        "data": [train_paths[c] for c in training_dataset["case"]]})
    # the mean voxels a volume feed the policy's cost model
    vox = [int(np.prod(nifti.get_nifti_header(p).shape[:3]))
           for p in list(ref_paths.values())[:8] + list(train_paths.values())[:8]]
    mean_voxels = int(np.mean(vox)) if vox else None
    mode = select_registration_mode(len(S), len(T), mode=registration_mode,
                                    distributed=distributed, volume_voxels=mean_voxels)
    print("registration mode: %s (%d pairs%s)"
          % (mode, len(S) * len(T), "" if registration_mode != "auto" else ", auto-selected"))
    sh_path = join_path(output_folder, "run_registration.sh")
    with open(sh_path, "w") as f:
        f.write((SH_HEADER_WARM if svf_warm_start else SH_HEADER) + registration_command(
            join_path(output_folder, "regsource.csv"),
            join_path(output_folder, "regtarget.csv"),
            registration_folder, mode, quick_registration, large_deformation,
            svf_warm_start=svf_warm_start) + "\n")
    os.chmod(sh_path, 0o755)

    with timed_stage(stats, "registration", dev):
        if mode == "learned":
            from deepwmh_tpu_torch.registration.learned_group import LearnedGroupRegistration

            reg = LearnedGroupRegistration(S, T, registration_folder, reg_cfg=learned_reg_cfg,
                                           mesh=mesh, device=dev)
            reg.launch()
        else:
            reg = GroupRegistration(S, T, registration_folder, keep_deformation=True,
                                    quick=quick_registration,
                                    large_deformation=large_deformation,
                                    distributed=distributed, warm_start=svf_warm_start,
                                    device=dev)
            if svf_warm_start and not reg.warm_start:
                print("svf warm start: disabled — needs >= 2 reference cases "
                      "to form an anchor row (%d given); running the cold "
                      "schedule instead" % len(S))
            if reg.warm_start:
                # the warm schedule is serial (anchor row first) on one device
                if mesh is not None:
                    print("svf warm start: registration runs serially on one "
                          "chip (mesh still shards pipeline training)")
                reg.launch()
            else:
                if mesh is not None:
                    batch_pairs = max(batch_pairs, mesh.size)
                reg.launch(batch_pairs=batch_pairs, mesh=mesh)

    # barrier: with --distributed this shard did only part of the pairs;
    # go on only when every pair's full artifact set loads
    all_pairs = [(s, t) for s in reference_dataset["case"] for t in training_dataset["case"]]
    missing = [pair_name(s, t) for s, t in all_pairs if not reg.pair_complete(s, t)]
    if missing:
        print("[!] %d/%d registration pair(s) not finished yet (e.g. %s)."
              % (len(missing), len(all_pairs), missing[0]))
        print("    Run the remaining shards (see run_registration.sh), then "
              "re-run this command to continue.")
        raise SystemExit(2)

    # 003: propagate the reference labels onto each training subject
    transformed_folder = mkdir(join_path(output_folder, "003_Transformed"))
    ref_idx = {c: i for i, c in enumerate(reference_dataset["case"])}
    with timed_stage(stats, "label_propagation", dev):
        for s in reference_dataset["case"]:
            for t in training_dataset["case"]:
                pair = pair_name(s, t)
                out_dir = mkdir(join_path(transformed_folder, pair))
                outs = [join_path(out_dir, "label1.nii.gz"), join_path(out_dir, "label2.nii.gz")]
                # probe first: apply_pair_transforms decodes the warp up front
                if all(nifti.try_load_nifti(p) for p in outs):
                    continue
                i = ref_idx[s]
                apply_pair_transforms(
                    join_path(registration_folder, pair),
                    [reference_dataset["label1"][i], reference_dataset["label2"][i]],
                    outs, interp="NearestNeighbor", device=dev)

    # 004: the 3-stage pipeline, recording its stages beside the steps above
    pipeline = PipelineMultistage(core_folder, budget=budget or StageBudget(), mesh=mesh,
                                  device=dev)
    pipeline.stage_stats = stats
    for t in training_dataset["case"]:
        refs = [join_path(registration_folder, "%s.nii.gz" % pair_name(s, t))
                for s in reference_dataset["case"]]
        l1 = [join_path(transformed_folder, pair_name(s, t), "label1.nii.gz")
              for s in reference_dataset["case"]]
        l2 = [join_path(transformed_folder, pair_name(s, t), "label2.nii.gz")
              for s in reference_dataset["case"]]
        desc = training_dataset["desc"][training_dataset["case"].index(t)]
        pipeline.add_training_case(t, train_paths[t], refs, l1, l2, description=desc)

    pipeline.run_training(run_stages=run_stages)

    if run_stages == "full":
        if len(os.listdir(release_folder)) > 0:
            print("[!] release folder not empty; skipping release.")
        else:
            pipeline.release_model(release_folder)
    return core_folder


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train the full annotation-free WMH segmentation pipeline "
        "end to end (PyTorch/CUDA DeepWMH_train).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("-s", "--reference", type=str, required=True,
                        help="Reference cohort CSV (case,desc,flair,label1,label2).")
    parser.add_argument("-t", "--training", type=str, required=True,
                        help="Training cohort CSV (case,desc,flair).")
    parser.add_argument("-o", "--output-folder", type=str, required=True)
    parser.add_argument("-j", "--num-CPU-cores", type=int, default=8,
                        help="Kept for CLI compatibility (compute runs on the GPU).")
    parser.add_argument("-r", "--release-model", type=str, required=False)
    parser.add_argument("--core-folder", type=str, required=False)
    parser.add_argument("--skip-bfc", action="store_true",
                        help="[Advanced] Skip N4 bias field correction.")
    parser.add_argument("--allow-quick-registration",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="Quick registration (finest pyramid level dropped); with "
                        "--allow-large-deformations the reference's training preset.")
    parser.add_argument("--allow-large-deformations",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="Large-deformation capacity: more iterations, 2^4 "
                        "integration steps, the exact exp gradient.")
    parser.add_argument("--mesh", action=argparse.BooleanOptionalAction, default=None,
                        help="Shard registration pair batches and training steps over all "
                        "visible cards (of every process of the run). Default: on when "
                        "more than one card is visible and neither -g nor --device is "
                        "given.")
    parser.add_argument("--run-stages", choices=["initseg", "denoise", "full"],
                        default="full", help="[Advanced] Run a pipeline prefix.")
    parser.add_argument("--distributed", type=str, default=None,
                        help="[Advanced] 'a/b': run registration shard a of b.")
    parser.add_argument("--stage2-epochs", type=int, default=None,
                        help="[Advanced] Override the 50-epoch denoiser budget.")
    parser.add_argument("--stage3-epochs", type=int, default=None,
                        help="[Advanced] Override the 100-epoch final budget.")
    parser.add_argument("--batches-per-epoch", type=int, default=None,
                        help="[Advanced] Override the 150 batches/epoch budget.")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--batch-pairs", type=int, default=1,
                        help="Register N same-geometry pairs at a time as one batch "
                        "(raised to the mesh size over a mesh).")
    parser.add_argument("--registration-mode", choices=["auto", "svf", "learned"],
                        default="auto",
                        help="'svf' optimises every pair, 'learned' trains one network "
                        "and registers each pair with a forward pass; 'auto' decides "
                        "from the cost model of registration/policy.py.")
    parser.add_argument("--svf-warm-start", action="store_true",
                        help="[Advanced] Seed each svf pair from the anchor-row "
                        "composition and refine on a shortened schedule. Implies "
                        "--registration-mode svf; incompatible with --distributed; "
                        "needs >= 2 reference cases.")
    parser.add_argument("--skip-integrity-check", action="store_true")
    add_device_args(parser)
    return parser


def main(argv=None):
    parser = make_parser()
    args = parser.parse_args(argv)
    device = device_from_args(parser, args)
    mesh = mesh_from_args(parser, args)

    if not args.skip_integrity_check and not check_system_integrity(device):
        raise SystemExit(1)

    budget = None
    overrides = {
        "stage2_epochs": args.stage2_epochs,
        "stage3_epochs": args.stage3_epochs,
        "batches_per_epoch": args.batches_per_epoch,
        "batch_size": args.batch_size,
    }
    overrides = {k: v for k, v in overrides.items() if v is not None}
    if overrides:
        from deepwmh_tpu_torch.pipeline.multistage import StageBudget

        budget = StageBudget(**overrides)

    run_train(
        args.reference,
        args.training,
        args.output_folder,
        core_folder=args.core_folder,
        release_folder=args.release_model,
        skip_bfc=args.skip_bfc,
        quick_registration=args.allow_quick_registration,
        large_deformation=args.allow_large_deformations,
        run_stages=args.run_stages,
        distributed=args.distributed,
        budget=budget,
        batch_pairs=args.batch_pairs,
        registration_mode=args.registration_mode,
        svf_warm_start=args.svf_warm_start,
        mesh=mesh,
        device=device,
    )


def mesh_from_args(parser, args):
    """The run's mesh (after joining a multi-process run from the
    environment): all visible cards when ``--mesh`` is given, or by default
    when more than one card is visible and neither ``-g`` nor ``--device``
    pins the run; None otherwise."""
    from deepwmh_tpu_torch.parallel.mesh import device_info, init_distributed_from_env

    if args.mesh and (args.gpu is not None or args.device is not None):
        parser.error("--mesh and -g/--gpu or --device are mutually exclusive")
    init_distributed_from_env()
    use_mesh = args.mesh
    if use_mesh is None:
        use_mesh = (args.gpu is None and args.device is None and torch.cuda.is_available()
                    and device_info()["device_count"] > 1)
    if not use_mesh:
        return None
    mesh = make_mesh()
    home = mesh.home
    print("mesh: %d device(s) (%s)" % (mesh.size, torch.cuda.get_device_name(home)
                                       if home.type == "cuda" else home.type))
    return mesh


if __name__ == "__main__":
    main()
