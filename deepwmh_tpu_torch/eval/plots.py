"""Stage-1's per-case histogram-curve plot (the port's copy of
``deepwmh_tpu.eval.plots.hist_curve_plot``). matplotlib is imported at the
call, so a host without it can still import this module; the caller treats
the plot as best-effort."""

from __future__ import annotations

import os

import numpy as np


def hist_curve_plot(x, y, r, rs, save_file, thresholds=None):
    """Log-scale anomaly histogram curves: per-reference gray curves, the
    cohort mean (blue), the input case (red), optional threshold marks."""
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    plt.figure("figure", figsize=(8, 6), dpi=144, frameon=True)
    if thresholds is not None:
        for value in thresholds:
            plt.axvline(x=value, ls="--", lw=1, color="k")
    for r0 in np.asarray(rs):
        plt.plot(x, r0, color=(0.39, 0.39, 0.39), ls="-", lw=0.5)
    plt.plot(x, y, color=(0.92, 0.25, 0.20), label="input", ls="-", lw=1.5)
    plt.plot(x, r, color=(0.20, 0.25, 0.92), label="refs", ls="-", lw=1.5)
    plt.title("Histogram curve plot (log scale)")
    plt.xlabel("anomaly score")
    plt.ylabel("exponent value")
    plt.grid(which="both", ls="--", lw=1, color=(0.78, 0.78, 0.78))
    plt.legend()
    os.makedirs(os.path.dirname(os.path.abspath(save_file)), exist_ok=True)
    plt.savefig(save_file)
    plt.close("figure")
