"""The port's studies (the JAX package's ``experiments/studies/``): each
script takes its JAX counterpart's arguments plus ``--device`` (CUDA unless
``cpu``), prints one JSON object on stdout and its progress on stderr, and
keeps its work directories under the temporary directory as the JAX script
keeps them under ``/tmp``.

    python -m deepwmh_tpu_torch.experiments.studies.seed_variance_study <seed>
    python -m deepwmh_tpu_torch.experiments.studies.crossover_e2e_study svf|learned
    python -m deepwmh_tpu_torch.experiments.studies.warm_start_study [--skip-quality]
    python -m deepwmh_tpu_torch.experiments.studies.fused_stats_study
"""

import contextlib
import json
import os
import sys


def log(msg) -> None:
    print(msg, file=sys.stderr, flush=True)


@contextlib.contextmanager
def progress_to_stderr():
    """Within the block everything written to stdout (the pipeline's
    progress lines, a subprocess's output) goes to stderr, so that stdout
    holds the study's JSON alone."""
    sys.stdout.flush()
    saved = os.dup(1)
    os.dup2(2, 1)
    try:
        with contextlib.redirect_stdout(sys.stderr):
            yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def emit(obj) -> None:
    print(json.dumps(obj, indent=1), flush=True)


def device_name(device) -> str:
    """What the study ran on: the card's name, or 'cpu'."""
    import torch

    from deepwmh_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
