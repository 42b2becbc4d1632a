"""SVF warm start against the cold path: throughput and quality (the port
of the JAX package's ``experiments/studies/warm_start_study.py``).

1. Throughput, at 192x224x192 1 mm with the training-prep preset (quick +
   large deformation): a 3 x 3 cohort registered end to end (artifacts
   written) cold and warm. Warm does (S-1)+T full-budget pairs (the
   auxiliary row and the anchor row) and (S-1)*T shortened pairs; the
   per-pair costs measured here project the gain at the reference's
   cohort sizes.
2. Quality, on 96x112x96 phantoms of distinct anatomies: the label-
   propagation benchmark (``registration/quality.py``) for the same pair
   through the cold svf path and through a warm composed-seed pair.

Usage:
  python -m deepwmh_tpu_torch.experiments.studies.warm_start_study [--skip-quality] [--device cpu]

Prints JSON to stdout, progress to stderr.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from deepwmh_tpu_torch.experiments.studies import device_name, emit, log, progress_to_stderr

BENCH_SHAPE = (192, 224, 192)
QUALITY_SHAPE = (96, 112, 96)


def make_heads(tmp, n_src, n_tgt, shape):
    """Distinct spherical heads (throughput only: the schedules are static,
    so a pair's cost does not depend on its anatomy)."""
    from deepwmh_tpu_torch.core import nifti

    hdr = nifti.NiftiHeader()
    hdr.set_shape(shape)
    hdr.set_zooms((1.0, 1.0, 1.0))
    g = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")

    def head(seed, shift):
        rr = np.sqrt((g[0] - shift) ** 2 + g[1] ** 2 + g[2] ** 2)
        tex = np.random.RandomState(seed).rand(*shape).astype(np.float32)
        return ((rr < 0.8) * (300 + 100 * tex)).astype(np.float32)

    srcs, tgts = [], []
    for i in range(n_src):
        p = os.path.join(tmp, "src%d.nii.gz" % i)
        nifti.save_nifti(head(i, 0.03 * (i + 1)), hdr, p)
        srcs.append(("S%d" % i, p))
    for i in range(n_tgt):
        p = os.path.join(tmp, "tgt%d.nii.gz" % i)
        nifti.save_nifti(head(100 + i, -0.02 * (i + 1)), hdr, p)
        tgts.append(("T%d" % i, p))
    return srcs, tgts


def project(S, T, c_full, c_warm):
    """Cold / warm wall at an S x T cohort from the per-pair costs."""
    cold = S * T * c_full
    warm = (S - 1 + T) * c_full + (S - 1) * T * c_warm
    return cold / warm if warm > 0 else None


def throughput_study(tmp, device=None, shape=None):
    from deepwmh_tpu_torch.registration.group import GroupRegistration

    srcs, tgts = make_heads(tmp, 3, 3, shape or BENCH_SHAPE)

    def launch(s, t, name, warm):
        GroupRegistration(s, t, os.path.join(tmp, name), quick=True, large_deformation=True,
                          warm_start=warm, device=device).launch(verbose=False)

    # first calls pay the kernels' and libraries' set-up: run them outside
    # the timed sections
    log("warmup: one cold pair, one warm triangle")
    launch(srcs[:1], tgts[:1], "warm_cold", False)
    launch(srcs[:2], tgts[:1], "warm_warm", True)
    log("timed: cold 3x3 (9 full pairs)")
    t0 = time.time()
    launch(srcs, tgts, "cold33", False)
    cold_s = time.time() - t0
    log("timed: warm 3x3 (2 auxiliary + 3 anchor full pairs, 6 warm pairs)")
    t0 = time.time()
    launch(srcs, tgts, "warm33", True)
    warm_s = time.time() - t0

    n_pairs = 9
    # warm total = 5 c_full + 6 c_warm, c_full the cold pair's cost
    c_full = cold_s / n_pairs
    c_warm = max(warm_s - 5 * c_full, 0.0) / 6.0
    return {
        "cold_3x3_s": cold_s, "warm_3x3_s": warm_s,
        "cold_pairs_per_min": n_pairs / cold_s * 60.0,
        "warm_pairs_per_min": n_pairs / warm_s * 60.0,
        "speedup_3x3": cold_s / warm_s,
        "c_full_s_per_pair": c_full, "c_warm_s_per_pair": c_warm,
        "projected_speedup": {"%dx%d" % st: project(*st, c_full, c_warm)
                              for st in ((5, 10), (10, 50), (10, 100))},
    }


def quality_study(tmp, device=None, shape=None):
    from deepwmh_tpu_torch.registration.quality import label_propagation_quality

    out = {}
    for mode in ("svf", "warm"):
        log("quality: mode=%s at %s" % (mode, "x".join(map(str, shape or QUALITY_SHAPE))))
        out[mode] = label_propagation_quality(os.path.join(tmp, "q_%s" % mode), mode=mode,
                                              shape=shape or QUALITY_SHAPE, device=device)
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--skip-quality", action="store_true")
    parser.add_argument("--device", default=None, help="cuda (default), cuda:i or cpu")
    args = parser.parse_args(argv)
    t0 = time.time()
    res = {}
    with tempfile.TemporaryDirectory() as tmp, progress_to_stderr():
        res["throughput"] = throughput_study(tmp, args.device)
        if not args.skip_quality:
            res["quality"] = quality_study(tmp, args.device)
    res["wall_s"] = time.time() - t0
    res["device"] = device_name(args.device)
    emit(res)
    return res


if __name__ == "__main__":
    main()
