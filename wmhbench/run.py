"""Run one cell of the benchmark once and print its result.

    python3 -m wmhbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (inputs and weights from the seed, the program's objects, warm-up
of every shape the cell uses) runs first and is ``setup_s``; then the
window measures for ``--seconds``; then the program's state is freed and
the plain reference judges what the timed path produced. The last line of
standard output is one JSON object; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.

Exits 2 without a result when no CUDA card (or too few) is visible, and 3
when a forbidden module (JAX, or the JAX package) is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from wmhbench import harness  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m wmhbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(code: int, msg: str) -> int:
    print("wmhbench: " + msg, file=sys.stderr, flush=True)
    return code


def run_cell(cell, seed: int, seconds: float, trace: bool, device, chips: int,
             t_start: float, workdir: str, fault: str | None = None):
    """Set-up, window, check; returns (the result's fields, the driver),
    printing nothing. ``fault`` plants a named fault in the timed path
    (the tests' and ``readings``' use)."""
    import torch

    drv = harness.driver_module(cell.driver).Driver(cell, seed, device, workdir)
    if fault:
        drv.plant(fault)
    win = harness.Window(seconds, t_start, device,
                         trace_units=int(cell.traffic.get("trace_units", 1)) if trace else 0)
    drv.setup()
    drv.run(win)
    device_out = harness.device_info(device, chips)
    drv.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = drv.check()
    correct, rows = harness.judge(numbers, cell.limits)
    found = harness.forbidden_modules()
    out = {"correct": bool(correct), "attempted": drv.attempted, "failed": drv.failed,
           "device": device_out, "checks": rows, "numbers": numbers, "forbidden": found}
    ctx = drv.context(win)
    if trace:
        readers = [(m, harness.metric_reader(m["name"])) for m in cell.per_layer]
    else:
        readers = [(m, harness.end_to_end_reader(m)) for m in cell.end_to_end]
    metrics = {}
    for m, read in readers:
        v = read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out["metrics"] = metrics
    out["units"] = win.units
    out["unit_ends"] = win.unit_ends
    if trace:
        tr = win.trace
        out["device"]["busy_s"] = tr.busy_s()
        out["device"]["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_kernels(10), "idle_gaps": tr.idle_gaps(10)}
    return out, drv


def main(argv=None) -> int:
    args = parse(argv)
    harness.cache_dirs()
    try:
        spec = harness.benchmark_spec()
        cell = harness.load_cell(args.workload, spec)
        for m in cell.end_to_end:
            harness.end_to_end_reader(m)
    except (OSError, KeyError, ValueError, StopIteration) as e:
        return fail(2, "cannot load workload %r: %r" % (args.workload, e))
    chips = next(w["chips"] for w in spec["workloads"] if w["name"] == args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return fail(2, "needs %d CUDA card(s); found %d" % (
            chips, torch.cuda.device_count() if torch.cuda.is_available() else 0))
    device = torch.device("cuda", 0)
    workdir = tempfile.mkdtemp(prefix="wmhbench-")
    try:
        out, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, chips,
                       T_START, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if out["forbidden"]:
        return fail(3, "forbidden modules loaded: %s" % ", ".join(out["forbidden"]))
    rows = out.pop("checks")
    out.pop("forbidden")
    units, ends = out.pop("units"), out.pop("unit_ends")
    print("window: %d units, completed at %s s" % (
        units, " ".join("%.3f" % t for t in ends)), file=sys.stderr)
    # every number the driver computed, those without a limit too (looks)
    print("numbers: " + json.dumps(out.pop("numbers")), file=sys.stderr)
    out["checked"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    for name, v, lim in rows:
        print("check %s = %r (limit %r)" % (name, v, lim), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
