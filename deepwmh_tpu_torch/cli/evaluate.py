"""Segmentation accuracy evaluation: ``python -m
deepwmh_tpu_torch.cli.evaluate -p <predictions> -g <ground truth> -o
report.json [--metrics ...] [--device cpu]``.

The flags and report of ``DeepWMH_evaluate`` (voxel Dice, precision /
recall, instance F1 and counts, per-lesion component Dice between a
prediction folder and a ground-truth folder, matched by case name across
.nii / .nii.gz), plus ``--device``: the components are labelled on CUDA
unless the CPU is asked for. The report (``cases``, ``summary``) is
written atomically.
"""

from __future__ import annotations

import argparse
import json
import os

from deepwmh_tpu_torch.core.artifacts import atomic_write_json
from deepwmh_tpu_torch.eval.metrics import METRICS, PairedEvaluation, summarize


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Evaluate predicted segmentations against ground truth "
        "(PyTorch/CUDA DeepWMH_evaluate).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("-p", "--predictions", type=str, required=True,
                        help="Folder with predicted <case>.nii.gz files.")
    parser.add_argument("-g", "--ground-truth", type=str, required=True,
                        help="Folder with ground-truth <case>.nii.gz files.")
    parser.add_argument("-o", "--output", type=str, required=True,
                        help="Output report path (.json).")
    parser.add_argument("--metrics", nargs="+", choices=list(METRICS),
                        default=["dice", "precision_recall", "instance_f1"])
    parser.add_argument("--device", type=str, default=None,
                        help="Device to label components on: cuda, cuda:i or cpu "
                        "(default: the current CUDA device). The CPU is used only "
                        "when asked for.")
    args = parser.parse_args(argv)

    ev = PairedEvaluation(device=args.device)
    n = 0
    seen = set()
    for f in sorted(os.listdir(args.predictions)):
        if f.endswith(".nii.gz"):
            case = f[: -len(".nii.gz")]
        elif f.endswith(".nii"):
            case = f[: -len(".nii")]
        else:
            continue
        if case in seen:
            print("[skip] duplicate prediction variant for %s (%s)" % (case, f))
            continue
        seen.add(case)
        truth = os.path.join(args.ground_truth, f)
        if not os.path.isfile(truth):
            # the truth may use the other compression variant
            for alt in (case + ".nii.gz", case + ".nii"):
                if os.path.isfile(os.path.join(args.ground_truth, alt)):
                    truth = os.path.join(args.ground_truth, alt)
                    break
            else:
                print("[skip] no ground truth for %s" % f)
                continue
        ev.add_pair(case, os.path.join(args.predictions, f), truth)
        n += 1
    results = ev.run(metrics=tuple(args.metrics))
    report = {"cases": results, "summary": summarize(results)}
    atomic_write_json(report, args.output)
    print(json.dumps(report["summary"], indent=2))
    print("report written to %s (%d case(s))" % (args.output, n))
    return report


if __name__ == "__main__":
    main()
