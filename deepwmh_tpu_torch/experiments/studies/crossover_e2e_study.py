"""Full-loop check of the registration policy above the crossover (the
port of the JAX package's ``experiments/studies/crossover_e2e_study.py``).

12 references x 14 patients = 168 pairs through the whole annotation-free
loop (``eval/e2e.py``) with one registration mode forced, seed 0, scored
by the held-out Dice on 2 unseen patients. ``registration/policy.py``'s
quality rule (auto never learned at or below 168 pairs, fault C1) rests on
this loop: svf's Dice at or above learned's.

Usage:
  python -m deepwmh_tpu_torch.experiments.studies.crossover_e2e_study svf|learned [--device cpu]

The work directory ``<tmp>/crossover_study/<mode>`` persists (a rerun
resumes). Prints JSON to stdout, progress to stderr.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from deepwmh_tpu_torch.experiments.studies import device_name, emit, log, progress_to_stderr

COHORT = dict(n_ref=12, n_train=14, n_test=2)


def work_dir(mode: str) -> str:
    return os.path.join(tempfile.gettempdir(), "crossover_study", mode)


def run(mode: str, device=None, work=None) -> dict:
    from deepwmh_tpu_torch.eval.e2e import run_e2e_accuracy

    if mode not in ("svf", "learned"):
        raise ValueError("mode must be svf or learned, not %r" % (mode,))
    work = work or work_dir(mode)
    log("crossover: %s, %d x %d pairs in %s" % (mode, COHORT["n_ref"], COHORT["n_train"], work))
    t0 = time.time()
    res = run_e2e_accuracy(work, seed=0, run_stages="full", registration_mode=mode,
                           device=device, **COHORT)
    return {"mode": mode, "n_pairs": COHORT["n_ref"] * COHORT["n_train"],
            "heldout_dice": res["dice"], "heldout_per_case": res["heldout_dice"],
            "stage1_mean_dice": float(np.mean(list(res["stage1_dice"].values()) or [0.0])),
            "trainfit_mean_dice": float(np.mean(list(res["trainfit_dice"].values()) or [0.0])),
            "wall_s": time.time() - t0, "device": device_name(device)}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", nargs="?", default="svf", choices=("svf", "learned"))
    parser.add_argument("--device", default=None, help="cuda (default), cuda:i or cpu")
    args = parser.parse_args(argv)
    with progress_to_stderr():
        out = run(args.mode, args.device)
    emit(out)
    return out


if __name__ == "__main__":
    main()
