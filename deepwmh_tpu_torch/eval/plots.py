"""Observability plots (the port's copy of ``deepwmh_tpu.eval.plots``):
stage-1's per-case histogram-curve plot, multi-series curves and the
trainer's loss / metric curves. matplotlib (agg backend) is imported at
the call, so a host without it can still import this module; callers
treat the plots as best-effort."""

from __future__ import annotations

import os

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    return plt


def hist_curve_plot(x, y, r, rs, save_file, thresholds=None):
    """Log-scale anomaly histogram curves: per-reference gray curves, the
    cohort mean (blue), the input case (red), optional threshold marks."""
    plt = _plt()
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


def curve_plot(xs, ys, labels, save_file, title="", xlabel="", ylabel=""):
    """Multi-series curve plot."""
    plt = _plt()
    plt.figure(figsize=(8, 6), dpi=120)
    for x, y, lab in zip(xs, ys, labels):
        plt.plot(x, y, label=lab, lw=1.2)
    plt.title(title)
    plt.xlabel(xlabel)
    plt.ylabel(ylabel)
    plt.grid(ls="--", lw=0.5)
    if any(labels):
        plt.legend()
    os.makedirs(os.path.dirname(os.path.abspath(save_file)), exist_ok=True)
    plt.savefig(save_file)
    plt.close()


def training_curve_plot(epochs, losses, metrics, save_file):
    """Loss/metric-vs-epoch plot for the trainer's observability output."""
    plt = _plt()
    fig, ax1 = plt.subplots(figsize=(8, 5), dpi=120)
    ax1.plot(epochs, losses, color="tab:red", label="train loss")
    ax1.set_xlabel("epoch")
    ax1.set_ylabel("loss", color="tab:red")
    if metrics is not None:
        ax2 = ax1.twinx()
        ax2.plot(epochs, metrics, color="tab:blue", label="val metric")
        ax2.set_ylabel("metric", color="tab:blue")
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(save_file)), exist_ok=True)
    fig.savefig(save_file)
    plt.close(fig)
