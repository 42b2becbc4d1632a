"""Error bars for the e2e accuracy (the port of the JAX package's
``experiments/studies/seed_variance_study.py``).

One train -> predict loop at the e2e configuration (``eval/e2e.py`` at
64x80x64 2 mm, 5 references, 3 patients, 2 held out, the default budget)
at the cohort seed given; the seeds' held-out Dice give the spread a
single draw has. Fault C5 (svf's held-out Dice at seed 2) reads it.

Usage:
  python -m deepwmh_tpu_torch.experiments.studies.seed_variance_study <seed> [--device cpu]

The work directory ``<tmp>/seed_study/<seed>`` persists (a rerun resumes
from its artifacts). Prints JSON to stdout, progress to stderr.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

from deepwmh_tpu_torch.experiments.studies import device_name, emit, log, progress_to_stderr

E2E = dict(n_ref=5, n_train=3, n_test=2)


def work_dir(seed: int) -> str:
    return os.path.join(tempfile.gettempdir(), "seed_study", str(seed))


def run(seed: int, device=None, work=None) -> dict:
    """The study's reading at ``seed``: held-out Dice (mean and per case),
    stage-1 Dice, the wall."""
    from deepwmh_tpu_torch.eval.e2e import run_e2e_accuracy

    work = work or work_dir(seed)
    log("seed_variance: seed %d in %s" % (seed, work))
    t0 = time.time()
    res = run_e2e_accuracy(work, seed=seed, run_stages="full", device=device, **E2E)
    return {"seed": seed, "heldout_dice": res["dice"],
            "heldout_per_case": res["heldout_dice"], "stage1_dice": res["stage1_dice"],
            "wall_s": time.time() - t0, "device": device_name(device)}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("seed", type=int)
    parser.add_argument("--device", default=None, help="cuda (default), cuda:i or cpu")
    args = parser.parse_args(argv)
    with progress_to_stderr():
        out = run(args.seed, args.device)
    emit(out)
    return out


if __name__ == "__main__":
    main()
