"""The readings that a cell's limits are set from, on the card at the
cell's own size:

    python3 -m wmhbench.readings --workload <name> --seeds 1 2 ... \
        [--seconds 4] [--control-seeds 3] [--faults half_batch ...] \
        [--compute-dtype float32]

For each seed, one whole run (set-up, a short window, the check) gives the
program's numbers; on the first ``--control-seeds`` seeds the control (the
reference one precision step down, put in the program's place) is judged
the same way; each ``--faults`` fault is planted in the timed path on as
many seeds. ``--compute-dtype`` runs the program in another type than the
configuration states (a look, not a reading a limit is set from; float32
turns TF32 off on both sides). One JSON line a reading, then a summary
line: the largest program reading and the smallest control and fault
readings of each number. Needs a card, as the benchmark does.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

from wmhbench import harness
from wmhbench.run import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m wmhbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--compute-dtype", default=None)
    args = ap.parse_args(argv)
    harness.cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("wmhbench.readings: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    if args.compute_dtype:
        from wmhbench.reference.unet import no_tf32

        cell.config = dict(cell.config, compute_dtype=args.compute_dtype)
        no_tf32()
    device = torch.device("cuda", 0)
    summary = {"program": {}, "control": {}}

    def keep(kind, numbers, worst):
        into = summary.setdefault(kind, {})
        for k, v in numbers.items():
            into[k] = v if k not in into else worst(into[k], v)

    runs = [(s, None) for s in args.seeds]
    runs += [(s, f) for f in args.faults for s in args.seeds[:args.control_seeds]]
    for i, (seed, fault) in enumerate(runs):
        workdir, drv = tempfile.mkdtemp(prefix="wmhbench-"), None
        try:
            out, drv = run_cell(cell, seed, args.seconds, False, device, 1,
                                time.perf_counter(), workdir, fault=fault)
            numbers = out["numbers"]
            line = {"seed": seed, "fault": fault, "numbers": numbers,
                    "units": out["units"], "metrics": out["metrics"],
                    "compute_dtype": cell.config["compute_dtype"]}
            keep(fault or "program", numbers, min if fault else max)
            line["look"] = drv.look()
            if fault is None and i < args.control_seeds:
                line["control"] = drv.control()
                line["control_look"] = drv.look(control=True)
                keep("control", line["control"], min)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
            del drv
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        print(json.dumps(line), flush=True)
    print(json.dumps({"summary": summary, "limits": cell.limits,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
