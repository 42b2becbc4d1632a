"""DeepWMH_serve on the GPU — ``python -m deepwmh_tpu_torch.cli.serve``.

Warm-model spool-directory serving with the flags of
``deepwmh_tpu.cli.serve``, less the compilation cache:

  python -m deepwmh_tpu_torch.cli.serve -m MODEL -s SPOOL -o OUT          # poll until SPOOL/STOP
  python -m deepwmh_tpu_torch.cli.serve -m MODEL -s SPOOL -o OUT --once   # drain and exit

Request  = drop <case>.nii.gz into SPOOL.
Response = DeepWMH_predict's output layout under OUT, plus a
           SPOOL/.done/<case>.json receipt (or .failed/<case>.err).
It runs on CUDA (``-g i`` picks ``cuda:i``); the CPU only with
``--device cpu``. ``--mesh`` shards each volume's sweep over every card of
this process, and bursts run one case a card. ``--once`` exits 1 when any
request failed.
"""

from __future__ import annotations

import argparse
import signal


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Serve lesion segmentation from a spool directory with a warm model "
        "(PyTorch/CUDA DeepWMH_serve).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("-m", "--trained-model", type=str, required=True,
                        help="Root folder of the trained model (plan.json + model_best).")
    parser.add_argument("-s", "--spool", type=str, required=True,
                        help="Spool directory watched for <case>.nii.gz requests.")
    parser.add_argument("-o", "--output-folder", type=str, required=True,
                        help="Output folder (DeepWMH_predict layout).")
    parser.add_argument("--once", action="store_true",
                        help="Drain the spool once and exit instead of polling.")
    parser.add_argument("--poll-interval", type=float, default=2.0,
                        help="Seconds between spool polls when idle.")
    parser.add_argument("--settle-seconds", type=float, default=2.0,
                        help="Only claim requests whose mtime is this old — guards "
                        "against claiming files mid-copy. Clients that rename into "
                        "the spool can set 0.")
    parser.add_argument("--stale-after", type=float, default=1800.0,
                        help="Re-spool another server's claimed requests when its "
                        "heartbeat is older than this (crash recovery across server ids).")
    parser.add_argument("--server-id", type=str, default=None,
                        help="Stable id for this server's work/status files (default: "
                        "srv<pid>); reuse an id to recover its crashed claims.")
    parser.add_argument("-g", "--gpu", type=int, default=None,
                        help="CUDA device index to pin this server to (one server per "
                        "card against a shared spool).")
    parser.add_argument("--device", type=str, default=None,
                        help="Device to run on: cuda, cuda:i or cpu. The CPU is used "
                        "only when asked for. Mutually exclusive with -g.")
    parser.add_argument("--mesh", action="store_true",
                        help="Shard each volume's TTA/patch sweep over every card of this "
                        "process (minimum per-volume latency). Without it, scale "
                        "throughput by running one server per card against the same "
                        "spool. Mutually exclusive with -g and --device.")
    parser.add_argument("--skip-bfc", action="store_true",
                        help="[Advanced] Skip N4 bias field correction.")
    parser.add_argument("--disable-tta", action="store_true",
                        help="[Advanced] Disable mirror test-time augmentation.")
    parser.add_argument("--no-previews", action="store_true",
                        help="[Advanced] Skip GIF preview rendering.")
    parser.add_argument("--checkpoint", type=str, default="model_best",
                        help="[Advanced] Checkpoint to load from the model dir.")
    parser.add_argument("--custom-task-name", type=str, default=None,
                        help="[Advanced] Pick one model package when the model root "
                        "contains several task folders.")
    parser.add_argument("--batch-max", type=int, default=None,
                        help="Burst batching: same-geometry requests pending at the "
                        "same moment run as ONE batched sweep, up to this many (a lone "
                        "request never waits for companions). Default 1 (off) on one "
                        "card; with --mesh one case a card, capped at the mesh size.")
    args = parser.parse_args(argv)

    if args.gpu is not None and args.device is not None:
        parser.error("-g/--gpu and --device are mutually exclusive")
    if args.mesh and (args.gpu is not None or args.device is not None):
        parser.error("--mesh and -g/--gpu or --device are mutually exclusive")
    device = "cuda:%d" % args.gpu if args.gpu is not None else args.device

    from deepwmh_tpu_torch.pipeline.serve import SpoolServer

    mesh = None
    if args.mesh:
        from deepwmh_tpu_torch.parallel.mesh import make_mesh

        # this process's cards only: a single-process server
        mesh = make_mesh(local=True)
        print("mesh: sharding each sweep over %d device(s)" % mesh.size)

    server = SpoolServer(
        args.spool,
        args.output_folder,
        args.trained_model,
        skip_bfc=args.skip_bfc,
        tta=not args.disable_tta,
        make_previews=not args.no_previews,
        checkpoint_name=args.checkpoint,
        poll_interval=args.poll_interval,
        server_id=args.server_id,
        settle_seconds=args.settle_seconds,
        stale_after=args.stale_after,
        task_name=args.custom_task_name,
        batch_max=args.batch_max,
        device=device,
        mesh=mesh,
    )

    # finish the in-flight case, then exit cleanly
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: server.request_stop())

    if args.once:
        server.recover_work()
        server.recover_stale(args.stale_after)
        served, failed = server.drain()
        print("drained: %d served, %d failed" % (served, failed), flush=True)
        return 1 if failed else 0
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
