"""All-pairs group registration on the GPU:
``python -m deepwmh_tpu_torch.cli.group_register``.

Same flags and artifacts as ``deepwmh_tpu.cli.group_register`` (the
reference's antsGroupRegistration, with its manual multi-machine
``--distributed a/b`` protocol: machines sharing the output folder each run
one shard, and finished pairs are skipped, so re-running is safe), plus
``-g i | --device cpu``. The training-prep preset is

  -s src.csv -t tgt.csv -o out --keep-deformation \\
      --allow-quick-registration --allow-large-deformations

It runs on CUDA (``-g i`` picks ``cuda:i``); the CPU only with
``--device cpu``. ``--mesh`` takes a device mesh over every visible card
(of every process of a run joined by the ``DEEPWMH_*`` contract): the
classic mode registers pair batches of ``--batch-pairs`` (raised to the
mesh size) over it, the learned mode trains its network data parallel over
it. Without a mesh same-geometry pairs run in batches of ``--batch-pairs``
(default 1: one by one), each batch through one Adam loop a level.
"""

from __future__ import annotations

import argparse

from deepwmh_tpu_torch.core.manifests import load_csv_simple
from deepwmh_tpu_torch.parallel.mesh import init_distributed_from_env, make_mesh


def add_device_args(parser) -> None:
    parser.add_argument("-g", "--gpu", type=int, default=None,
                        help="CUDA device index to run on (default: the current CUDA "
                        "device).")
    parser.add_argument("--device", type=str, default=None,
                        help="Device to run on: cuda, cuda:i or cpu. The CPU is used only "
                        "when asked for. Mutually exclusive with -g.")


def device_from_args(parser, args):
    if args.gpu is not None and args.device is not None:
        parser.error("-g/--gpu and --device are mutually exclusive")
    return "cuda:%d" % args.gpu if args.gpu is not None else args.device


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Register every source image onto every target image "
        "(rigid + affine + diffeomorphic SVF, PyTorch/CUDA).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("-s", "--source", type=str, required=True,
                        help="Source CSV with columns (case, data).")
    parser.add_argument("-t", "--target", type=str, required=True,
                        help="Target CSV with columns (case, data).")
    parser.add_argument("-o", "--output-folder", type=str, required=True)
    parser.add_argument("-j", "--jobs", type=int, default=1,
                        help="Kept for CLI compatibility (pairs run one by one on the "
                        "device).")
    parser.add_argument("--keep-deformation", action="store_true",
                        help="Keep dense warp fields (needed for label propagation).")
    parser.add_argument("--allow-quick-registration", action="store_true",
                        help="Fewer iterations / coarser finest level.")
    parser.add_argument("--allow-large-deformations", action="store_true",
                        help="More iterations for large anatomical differences.")
    parser.add_argument("--affine-only", action="store_true",
                        help="Skip the deformable stage.")
    parser.add_argument("--learned", action="store_true",
                        help="Amortized mode (the reference's VoxelMorph pathway): build "
                        "an affine template, train one registration network on the "
                        "cohort, register every pair with a single forward pass.")
    parser.add_argument("--mesh", action="store_true",
                        help="Shard pair batches (classic mode) or the network's training "
                        "(--learned) over every visible card; excludes -g / --device.")
    parser.add_argument("--batch-pairs", type=int, default=1,
                        help="Register N same-geometry pairs at a time as one batch "
                        "(raised to the mesh size under --mesh).")
    parser.add_argument("-d", "--distributed", type=str, default=None,
                        help="'a/b': run shard a (1-based) of b machines.")
    parser.add_argument("--svf-warm-start", action="store_true",
                        help="Seed each pair's SVF from the composition of the "
                        "anchor-source row and source->anchor pairs, refined on a "
                        "shortened schedule (needs >= 2 sources, --keep-deformation, no "
                        "--distributed/--batch-pairs).")
    add_device_args(parser)
    return parser


def main(argv=None):
    parser = make_parser()
    args = parser.parse_args(argv)
    device = device_from_args(parser, args)
    mesh = None
    if args.mesh:
        if device is not None:
            parser.error("--mesh and -g/--gpu or --device are mutually exclusive")
        init_distributed_from_env()
        mesh = make_mesh()
        device = mesh.home

    src = load_csv_simple(args.source, key_names=["case", "data"])
    tgt = load_csv_simple(args.target, key_names=["case", "data"])
    sources = list(zip(src["case"], src["data"]))
    targets = list(zip(tgt["case"], tgt["data"]))

    if args.learned:
        from deepwmh_tpu_torch.registration.learned_group import LearnedGroupRegistration

        if args.distributed:
            raise SystemExit("--learned trains one shared network; shard the pair list "
                             "only in the classic mode.")
        ignored = [name for name, on in [
            ("--affine-only", args.affine_only),
            ("--allow-quick-registration", args.allow_quick_registration),
            ("--allow-large-deformations", args.allow_large_deformations),
            ("--batch-pairs", args.batch_pairs != 1),
            ("--svf-warm-start", args.svf_warm_start),
        ] if on]
        if ignored:
            raise SystemExit("--learned does not support: %s (learned mode always keeps "
                             "deformations; pyramid/batching flags are classic-mode only)."
                             % " ".join(ignored))
        if mesh is not None:
            print("mesh: dp pair batches over %d device(s) for network training" % mesh.size)
        LearnedGroupRegistration(sources, targets, args.output_folder, mesh=mesh,
                                 device=device).launch()
        print("learned group registration finished.")
        return

    from deepwmh_tpu_torch.registration.group import GroupRegistration

    reg = GroupRegistration(
        sources, targets, args.output_folder,
        keep_deformation=args.keep_deformation,
        quick=args.allow_quick_registration,
        large_deformation=args.allow_large_deformations,
        distributed=args.distributed,
        deformable=not args.affine_only,
        warm_start=args.svf_warm_start,
        device=device,
    )
    print("%d registration pair(s) in this shard." % len(reg.tasks))
    batch_pairs = args.batch_pairs
    if mesh is not None:
        batch_pairs = max(batch_pairs, mesh.size)
        print("mesh: sharding pair batches over %d device(s)" % mesh.size)
    reg.launch(batch_pairs=batch_pairs, mesh=mesh)
    print("group registration finished.")


if __name__ == "__main__":
    main()
