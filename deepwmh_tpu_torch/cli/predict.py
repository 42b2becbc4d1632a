"""DeepWMH_predict on the GPU — ``python -m deepwmh_tpu_torch.cli.predict``.

Same flags and output layout as ``deepwmh_tpu.cli.predict``:

  -i images -n names -m model -o output [-g i | --device cpu | --mesh] [--skip-bfc]
  output/001_Preprocessed_Images/<case>_0000.nii.gz        (N4-corrected)
  output/002_Segmentations/001_raw/<case>.nii.gz           (raw U-Net seg)
  output/002_Segmentations/002_postproc_3mm/<case>.nii.gz  (3mm spark removal)
  output/002_Segmentations/003_postproc_fov/<case>.nii.gz  (brain FOV mask)
  output/003_Previews/<case>.gif

It runs on CUDA (``-g i`` picks ``cuda:i``); the CPU only with
``--device cpu``. ``--mesh`` spreads each volume's sweep over every card of
this process (``parallel/infer_sharded.py``): minimum latency a volume,
where ``-g`` runs one process a card for throughput. Every artifact is
loadability-probed so re-running resumes where it stopped.
"""

from __future__ import annotations

import argparse
import os

from deepwmh_tpu_torch.cli.integrity import check_system_integrity
from deepwmh_tpu_torch.core.manifests import check_dataset
from deepwmh_tpu_torch.parallel.mesh import make_mesh
from deepwmh_tpu_torch.pipeline.inference import make_output_folders, predict_one_case


def run_predict(
    input_images,
    case_names,
    model_dir,
    output_folder,
    skip_bfc: bool = False,
    tta: bool = True,
    make_previews: bool = True,
    checkpoint_name: str = "model_best",
    task_name: str | None = None,
    device=None,
    mesh=None,
):
    """Predict every case; ``device`` is CUDA by default ("cuda:i", or
    "cpu" when asked for). With ``mesh`` (a ``parallel.mesh.Mesh``) each
    sweep is sharded over it, the rest of a case running on ``device`` or
    the mesh's first device. Returns the FOV-masked segmentation folder."""
    from deepwmh_tpu_torch.unet.infer import SlidingWindowPredictor
    from deepwmh_tpu_torch.unet.release import load_released_model, resolve_model_dir

    model_dir = resolve_model_dir(model_dir, task_name)
    if mesh is not None:
        from deepwmh_tpu_torch.parallel.infer_sharded import ShardedSlidingWindowPredictor

        model, plan = load_released_model(model_dir, checkpoint_name,
                                          device=mesh.devices[0] if device is None else device)
        predictor = ShardedSlidingWindowPredictor(model, plan, mesh, tta=tta, device=device)
    else:
        model, plan = load_released_model(model_dir, checkpoint_name, device=device)
        predictor = SlidingWindowPredictor(model, plan, tta=tta, device=device)

    folders = make_output_folders(output_folder)
    for case, image_path in zip(case_names, input_images):
        print(">> case %s" % case, flush=True)
        predict_one_case(predictor, case, image_path, folders,
                         skip_bfc=skip_bfc, make_previews=make_previews)
    print("")
    print(">>> Prediction done.")
    print(">>> Preprocessed images: %s" % folders["images"])
    print(">>> Segmentations: %s" % folders["post_fov"])
    return folders["post_fov"]


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Do lesion segmentation using a pre-trained/installed model "
        "(PyTorch/CUDA DeepWMH_predict).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("-i", "--input-images", type=str, nargs="+", required=True,
                        help="Input image paths for prediction.")
    parser.add_argument("-n", "--case-names", type=str, nargs="+", required=True,
                        help="Case name for each input image.")
    parser.add_argument("-m", "--trained-model", type=str, required=True,
                        help="Root folder of the trained model (plan.json + model_best).")
    parser.add_argument("-o", "--output-folder", type=str, required=True,
                        help="Output folder for preprocessed images and segmentations.")
    parser.add_argument("-g", "--gpu", type=int, default=None,
                        help="CUDA device index to run on (default: the current "
                        "CUDA device).")
    parser.add_argument("--device", type=str, default=None,
                        help="Device to run on: cuda, cuda:i or cpu. The CPU is "
                        "used only when asked for. Mutually exclusive with -g.")
    parser.add_argument("--mesh", action="store_true",
                        help="Shard each volume's TTA sweep over every card of this "
                        "process for minimum per-volume latency (vs -g: N runs, one "
                        "card each, for throughput). Mutually exclusive with -g and "
                        "--device.")
    parser.add_argument("--skip-bfc", action="store_true",
                        help="[Advanced] Skip N4 bias field correction.")
    parser.add_argument("--custom-task-name", type=str, default=None,
                        help="[Advanced] Pick one model package when the "
                        "model root contains several task folders.")
    parser.add_argument("--disable-tta", action="store_true",
                        help="[Advanced] Disable mirror test-time augmentation (8x faster).")
    parser.add_argument("--no-previews", action="store_true",
                        help="[Advanced] Skip GIF preview rendering.")
    parser.add_argument("--checkpoint", type=str, default="model_best",
                        help="[Advanced] Checkpoint to load from the model dir "
                        "(e.g. model_best, model_latest, model_ep_0042).")
    parser.add_argument("--skip-integrity-check", action="store_true")
    args = parser.parse_args(argv)

    if args.gpu is not None and args.device is not None:
        parser.error("-g/--gpu and --device are mutually exclusive")
    if args.mesh and (args.gpu is not None or args.device is not None):
        parser.error("--mesh and -g/--gpu or --device are mutually exclusive")
    device = "cuda:%d" % args.gpu if args.gpu is not None else args.device

    if len(args.case_names) != len(args.input_images):
        raise SystemExit(
            "Number of input images (%d) must equal number of case names (%d)."
            % (len(args.input_images), len(args.case_names))
        )
    if not args.skip_integrity_check and not check_system_integrity(device):
        raise SystemExit(1)

    dataset = {
        "case": list(args.case_names),
        "flair": [os.path.abspath(p) for p in args.input_images],
    }
    if not check_dataset(dataset):
        raise SystemExit(1)

    mesh = None
    if args.mesh:
        # this process's cards only: a single-process CLI
        mesh = make_mesh(local=True)
        print("mesh: sharding each sweep over %d device(s)" % mesh.size)

    run_predict(
        dataset["flair"],
        dataset["case"],
        args.trained_model,
        args.output_folder,
        skip_bfc=args.skip_bfc,
        tta=not args.disable_tta,
        make_previews=not args.no_previews,
        checkpoint_name=args.checkpoint,
        task_name=args.custom_task_name,
        device=device,
        mesh=mesh,
    )


if __name__ == "__main__":
    main()
